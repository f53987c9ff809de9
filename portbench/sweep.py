"""The sweep that finds the highest rate an open-loop cell sustains, on the
card:

    python -m portbench.sweep --workload <cell> --seconds <s> --seed <n> --rates 40 80 ...

One set-up, then one window of the cell's traffic at each rate in turn
(the cell's own mix and arrival process, its rate replaced). For each
rate one JSON line: the arrival rate, the requests the window finished
within it a second, the backlog (queued + in flight) by quarter of the
window, the time to first token's median and 95th percentile, the
95th percentile of the time a token, and the submitter's lateness. The
backlog is the benchmark's own count (submitted less finished,
``traffic.open_poisson``). A rate is sustained where completions keep
pace with arrivals (the requests finished inside the window, a second,
at least ``PACE`` of the rate) and the backlog does not grow over the
window: the first quarter is its fill from empty, and neither later
quarter's mean lies above ``GROWTH`` times the second's. The last line
names the highest rate sustained with every lower rate of the sweep
sustained too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

PACE = 0.95
# the cell's fixed arrival schedule moves a quarter's backlog by 10-15%
# at every rate the sweep reaches, the card far from full included
GROWTH = 1.15


def sustained(rate: float, finished_per_s: float, quarters: list) -> bool:
    return (finished_per_s >= PACE * rate and len(quarters) == 4
            and max(quarters[2:]) <= GROWTH * quarters[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from . import run as R
    from .stats import p95

    if not torch.cuda.is_available():
        print("portbench.sweep: needs a CUDA card", file=sys.stderr)
        return 2
    run, _, kind, sess = R.setup(args.workload, args.seed, args.seconds,
                                 False)
    best, broken = None, False
    for rate in sorted(args.rates):
        run.wl["params"]["rate"] = rate
        rec = R.measure(run, kind, sess, time.perf_counter())
        w = run.window
        done = [r for r in w.requests if r.done]
        b = w.extra["backlog"]
        q = max(1, len(b) // 4)
        ttft = [(r.t_first - r.t_due) * 1e3 for r in done]
        tpot = [(r.t_last - r.t_first) * 1e3 / (len(r.new_ids) - 1)
                for r in done if len(r.new_ids) > 1]
        per_s = sum(1 for r in done if r.t_last <= w.t1) / args.seconds
        quarters = [statistics.mean(b[i * q:(i + 1) * q])
                    for i in range(4) if b[i * q:(i + 1) * q]]
        ok = sustained(rate, per_s, quarters)
        broken = broken or not ok
        if not broken:
            best = rate
        print(json.dumps({
            "rate": rate, "requests": len(w.requests),
            "finished_in_window_per_s": per_s,
            "unfinished": len(w.requests) - len(done),
            "backlog_quarter_means": quarters,
            "backlog_max": max(b) if b else None,
            "sustained": ok,
            "ttft_p50_ms": statistics.median(ttft) if ttft else None,
            "ttft_p95_ms": p95(ttft), "tpot_p95_ms": p95(tpot),
            "submit_late_s": w.extra["submit_late_s"],
            "graph_captures": rec["graph_captures_in_window"],
        }), flush=True)
    print(json.dumps({"highest_sustained": best}), flush=True)
    R.free(kind, sess)
    return 0


if __name__ == "__main__":
    sys.exit(main())
