"""backlog_max.<cell kind>: the most requests waiting at once in the
window, counted on the benchmark's side (submitted to the scheduler less
those whose result has come back, ``traffic.open_poisson``), sampled
every 10 ms: requests queued in the scheduler, in ``serve()``'s own queue
and in slots alike."""


def read(run, name):
    b = run.window.extra.get("backlog")
    return float(max(b)) if b else None
