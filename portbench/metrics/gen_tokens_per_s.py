"""gen_tokens_per_s: generated tokens of every entry call in the window
over the whole wall time of those calls (run back to back)."""


def read(run, name):
    w = run.window
    wall = sum(t1 - t0 for t0, t1 in w.calls)
    tokens = sum(len(r.new_ids or []) for r in w.requests)
    return tokens / wall if wall > 0 and tokens else None
