"""The readings a cell's correctness limits are set from, on the card:

    python -m portbench.calibrate --workload <cell> --seconds <s> --seeds 1 2 3 ...

For each seed, in one process, a run of the cell as ``run.py`` makes it
(its weights, set-up, window and sample of served tokens), whose numbers
are the lower readings; then, on the same prompts and served tokens, the
control (the reference in fp8 in the program's place, ``check.
control_source``) and, where the mix samples, each of ``check.FAULTS``,
judged by the same numbers and the cell's own verdict: the upper
readings. One JSON line a seed. It exits with 1 where the control comes
out as correct on any seed. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from . import check
    from . import run as R

    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    samples = R.load_cell(args.workload)[2]["check"].get("sample_sampled")

    def sources(ref, seed):
        out = {"control": check.control_source(ref, seed)}
        if samples:
            out.update({k: make(seed) for k, make in check.FAULTS.items()})
        return out

    control_passed = 0
    for seed in args.seeds:
        out = R.run_cell(args.workload, seed, args.seconds, False,
                         sources=sources, t_start=time.perf_counter())
        res, rec = out["result"], out["record"]
        control_passed += rec["others"]["control"]["correct"]
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": res["correct"], "program": rec["compared"],
            **rec["others"], "reference_s": rec["reference_s"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        }), flush=True)
    if control_passed:
        print(f"portbench.calibrate: the control came out as correct on "
              f"{control_passed} seed(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
