"""window_captures.<cell kind>: the rise of ``engine.graphs.stats()
["captures"]`` from the window's start until its requests are done: a
CUDA graph captured there stalls every slot (0 once the warm-up has
brought every shape the traffic forms to its graph)."""


def read(run, name):
    w = run.window
    if "captures" not in w.graphs1:
        return None
    return float(w.graphs1["captures"] - w.graphs0["captures"])
