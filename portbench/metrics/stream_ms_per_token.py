"""stream_ms_per_token: the window's wall time over the tokens its
``Engine.generate`` calls generated, prefill included: what a CLI user
waits a token."""


def read(run, name):
    w = run.window
    wall = sum(t1 - t0 for t0, t1 in w.calls)
    tokens = sum(len(r.new_ids or []) for r in w.requests)
    return wall * 1e3 / tokens if tokens else None
