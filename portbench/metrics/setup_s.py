"""setup_s: seconds from the process's start to the window's start:
imports, making the seed's weights on the card, the program's loader,
loading the built kernels and the warm-up on the cell's own shapes."""


def read(run, name):
    return run.setup_s
