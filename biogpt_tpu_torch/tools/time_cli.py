"""The generation CLI's cold-process time, one checkout against another.

    python -m biogpt_tpu_torch.tools.time_cli [--trees A B ...] [-n 200]
        [--reps 2] [--model FILE] [--device cuda]

Each run is a fresh ``python -m biogpt_tpu_torch.cli`` process (a user's
one-shot call: nothing built into it is warm but the kernel libraries)
started in the root of one checkout (``--trees``, default this one),
greedy (``--temp 0``) and sampled (``--temp 0.9 -s 1``), ``-n`` new
tokens with ``--no-stop-at-eos`` so that every run decodes the same
count. The trees run in the order given and then reversed, ``--reps``
times (A, B, B, A, ...), so that a drift of the card reaches every tree
alike. Every tree loads the kernels that this one builds first (one
``BIOGPT_TORCH_BUILD_DIR``; its libraries are named by their sources'
hash, so a tree whose kernel sources differ builds its own inside its
first run, which that run's process wall then holds).

The model is a random BioGPT-347M Q4_0 file (``write_random_quantized_
model``, seed 7) unless ``--model`` names one. One JSON line a run: the
CLI's own load, prefill, first-sample and predict times and ms/token,
and the process's wall; then one line a tree and mode with the medians. The
card's name and power limit stand in every line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PROMPT = "the protein binds the receptor"
MODES = {"greedy": ["--temp", "0"], "sampled": ["--temp", "0.9", "-s", "1"]}
TIMES = {"load_ms": r"load time =\s*([\d.]+) ms",
         "prefill_ms": r"prefill time =\s*([\d.]+) ms",
         "sample_ms": r"sample time =\s*([\d.]+) ms",
         "predict_ms": r"predict time =\s*([\d.]+) ms",
         "ms_per_token": r"/\s*([\d.]+) ms per token",
         "total_ms": r"total time =\s*([\d.]+) ms"}


def card_stamp(device: str) -> str:
    if device != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_cli(tree: Path, model: str, n: int, mode: str, device: str,
            env: dict) -> dict:
    """One cold CLI process in ``tree`` -> its times."""
    argv = [sys.executable, "-m", "biogpt_tpu_torch.cli", "-m", model,
            "-p", PROMPT, "-n", str(n), "--no-stop-at-eos",
            "--device", device, *MODES[mode]]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                          text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: cli rc {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    out = {k: float(m.group(1)) for k, rx in TIMES.items()
           if (m := re.search(rx, proc.stderr))}
    if len(out) != len(TIMES):
        raise RuntimeError(f"{tree}: cli times not found in "
                           f"{proc.stderr[-2000:]}")
    return {**out, "process_wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to time, each holding biogpt_tpu_torch")
    ap.add_argument("-n", "--n_predict", type=int, default=200)
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of the trees in order and reversed")
    ap.add_argument("--model", default=None,
                    help="model file (default: a random 347M Q4_0 one)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from ..ops import cuda_lib

    stamp = card_stamp(args.device)
    trees = [Path(t).resolve() for t in args.trees]
    env = dict(os.environ, BIOGPT_TORCH_BUILD_DIR=str(cuda_lib.build_dir()))
    if args.device == "cuda":
        cuda_lib.build_all()
    with tempfile.TemporaryDirectory(prefix="time_cli_") as tmp:
        model = args.model
        if model is None:
            from ..config import BioGptConfig
            from ..modelio.synthetic import write_random_quantized_model
            from ..quant import codecs
            model = os.path.join(tmp, "biogpt347m-q4_0.bin")
            write_random_quantized_model(model, BioGptConfig(),
                                         codecs.GGML_TYPE_Q4_0, seed=7)
        results = {}
        for rep in range(args.reps):
            for tree in trees + trees[::-1]:
                for mode in MODES:
                    r = run_cli(tree, model, args.n_predict, mode,
                                args.device, env)
                    results.setdefault((str(tree), mode), []).append(r)
                    print(json.dumps({"time_cli": "run", "tree": str(tree),
                                      "mode": mode, "rep": rep,
                                      "n_predict": args.n_predict, **r,
                                      "card": stamp}), flush=True)
    for (tree, mode), rs in results.items():
        print(json.dumps({
            "time_cli": "median", "tree": tree, "mode": mode,
            "runs": len(rs), "n_predict": args.n_predict,
            **{k: statistics.median(r[k] for r in rs) for k in rs[0]},
            "ms_per_token_all": [r["ms_per_token"] for r in rs],
            "card": stamp}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
