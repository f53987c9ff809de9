"""Where a single-stream decode step's time goes on the card.

    python -m biogpt_tpu_torch.tools.profile_decode [--steps 32] [--past 100]
                                                    [--trace out.json]

Builds a BioGPT-347M Q4_0 engine on random weights (``write_random_
quantized_model``, seed 7), prefills a prompt, and measures the greedy
main-path step (fused decode step + fused LN/lm_head/argmax tail + the KV
commit) three ways, printing one JSON line each:

  - ``wall``: host clock over ``--steps`` steps ending in a synchronize
    (ms/step), and the host time to enqueue one step without waiting;
  - ``device``: ``torch.profiler`` over the same steps: kernel launches per
    step, summed kernel time per step, and the device's idle share of the
    wall window, with the kernels that take the most time;
  - ``generate``: ``Engine.generate`` ms/token over 128 greedy tokens.

Needs a CUDA card; it names the card and its power limit in every line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch


def card_stamp() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--past", type=int, default=100,
                    help="cache length at the first profiled step")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled steps here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    from ..config import BioGptConfig, GenerationParams
    from ..modelio.checkpoint import load_params
    from ..modelio.synthetic import write_random_quantized_model
    from ..ops import cuda_lib
    from ..runtime.engine import Engine

    stamp = card_stamp()
    cuda_lib.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.bin")
        write_random_quantized_model(path, BioGptConfig(), seed=7)
        config, _, _, params = load_params(path, device="cpu")
    eng = Engine(config, params, device="cuda")
    del params

    prompt = [2] + [40 + i % 50 for i in range(args.past - 1)]
    gen = GenerationParams(n_predict=args.steps + 2, temp=0.0,
                           stop_at_eos=False)

    def prepare():
        cache = eng.new_cache()
        logits, cache, past = eng.prefill(cache, prompt)
        torch.cuda.synchronize()
        return cache, torch.argmax(logits, -1).to(torch.int32), past

    def run_steps(cache, tok, past, n):
        window = eng._window(past + n)
        enqueue = []
        t0 = time.perf_counter()
        for i in range(n):
            te = time.perf_counter()
            tok, _, cache = eng._step(cache, tok.reshape(1, 1).long(),
                                      past + i, window, True, gen, None)
            enqueue.append(time.perf_counter() - te)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, sorted(enqueue)

    run_steps(*prepare(), 4)   # warm: builds, allocator
    ms_step, enqueue = run_steps(*prepare(), args.steps)
    print(json.dumps({
        "what": "wall", "ms_per_step": ms_step,
        "host_enqueue_ms_median": enqueue[len(enqueue) // 2] * 1e3,
        "steps": args.steps, "past": args.past, "card": stamp}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    state = prepare()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = run_steps(*state, args.steps)
    per_kernel = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = per_kernel[ev.name]
            k[0] += 1
            k[1] += ev.device_time_total / 1e3          # us -> ms
    if args.trace:
        prof.export_chrome_trace(args.trace)
    n = args.steps
    launches = sum(c for c, _ in per_kernel.values()) / n
    busy = sum(t for _, t in per_kernel.values()) / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    print(json.dumps({
        "what": "device", "kernel_launches_per_step": launches,
        "kernel_ms_per_step": busy, "wall_ms_per_step_profiled": ms_prof,
        "idle_share": max(0.0, 1 - busy / ms_prof),
        "top_kernels": [{"name": name[:90], "per_step": c / n,
                         "ms_per_step": t / n} for name, (c, t) in top],
        "card": stamp}), flush=True)

    g = GenerationParams(n_predict=128, temp=0.0, stop_at_eos=False, seed=0)
    eng.generate(prompt[:8], g)
    res = eng.generate(prompt[:8], g)
    print(json.dumps({"what": "generate",
                      "ms_per_token": res.timings["ms_per_token"],
                      "new_tokens": res.timings["n_new"], "card": stamp}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
