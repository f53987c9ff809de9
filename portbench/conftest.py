"""pytest settings of the benchmark's own tests (``portbench/tests``):
the ``card`` marker of tests that need a CUDA card, which decide inside
the test whether there is one and skip there when there is not."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside the test without one)")
