"""device_idle_pct.<cell kind>: the share of the traced sub-window's wall
time in which nothing ran on the card (kernels, copies, sets), from the
``torch.profiler`` device trace (``portbench/devtrace.py``). Nothing
when the trace holds no device activity: a host reading never stands in
for it."""


def read(run, name):
    t = run.trace_summary
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
