"""Where a decode step's time goes on the card.

    python -m biogpt_tpu_torch.tools.profile_decode [--steps 32] [--past 100]
                                                    [--batch 1] [--trace out.json]

Builds a BioGPT-347M Q4_0 model on random weights (``write_random_
quantized_model``, seed 7) and measures one decode step three ways,
printing one JSON line each:

  - ``wall``: host clock over ``--steps`` steps ending in a synchronize
    (ms/step), and the host time to enqueue one step without waiting;
  - ``device``: ``torch.profiler`` over the same steps: kernel launches per
    step, summed kernel time per step, and the device's idle share of the
    wall window, with the kernels that take the most time;
  - ``generate`` (``--batch 1`` only): ``Engine.generate`` ms/token over
    128 greedy tokens.

``--batch 1`` (default) is the single-stream main path: the ``Engine``
prefills a prompt of ``--past`` tokens, and the step is the fused decode
step + fused LN/lm_head/argmax tail + the KV commit. ``--batch B`` (2..32)
is the serving step of a ``BatchedEngine`` with every slot at position
``--past``: once greedy (fused step + argmax/commit tail) and once sampled
(fused step + logits/group-maxima/commit tail + the per-request sampler).

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


def measure(prepare, run_steps, n: int, stamp: str, trace, **tags) -> None:
    """Print the ``wall`` and ``device`` lines of ``n`` steps.
    ``run_steps(state, n)`` enqueues n steps from ``prepare()``'s state and
    returns (ms/step after a synchronize, sorted host enqueue times)."""
    run_steps(prepare(), 4)   # warm: builds, allocator
    ms_step, enqueue = run_steps(prepare(), n)
    print(json.dumps({
        "what": "wall", **tags, "ms_per_step": ms_step,
        "host_enqueue_ms_median": enqueue[len(enqueue) // 2] * 1e3,
        "steps": n, "card": stamp}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    state = prepare()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = run_steps(state, n)
    per_kernel = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = per_kernel[ev.name]
            k[0] += 1
            k[1] += ev.device_time_total / 1e3          # us -> ms
    if trace:
        prof.export_chrome_trace(trace)
    launches = sum(c for c, _ in per_kernel.values()) / n
    busy = sum(t for _, t in per_kernel.values()) / n
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    print(json.dumps({
        "what": "device", **tags, "kernel_launches_per_step": launches,
        "kernel_ms_per_step": busy, "wall_ms_per_step_profiled": ms_prof,
        "idle_share": max(0.0, 1 - busy / ms_prof),
        "top_kernels": [{"name": name[:90], "per_step": c / n,
                         "ms_per_step": t / n} for name, (c, t) in top],
        "card": stamp}), flush=True)


def profile_single(config, params, args, stamp: str) -> None:
    from ..config import GenerationParams
    from ..runtime.engine import Engine

    eng = Engine(config, params, device="cuda")
    prompt = [2] + [40 + i % 50 for i in range(args.past - 1)]
    gen = GenerationParams(n_predict=args.steps + 2, temp=0.0,
                           stop_at_eos=False)

    def prepare():
        cache = eng.new_cache()
        logits, cache, past = eng.prefill(cache, prompt)
        torch.cuda.synchronize()
        return cache, torch.argmax(logits, -1).to(torch.int32), past

    def run_steps(state, n):
        cache, tok, past = state
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

    measure(prepare, run_steps, args.steps, stamp, args.trace, batch=1,
            past=args.past)
    g = GenerationParams(n_predict=128, temp=0.0, stop_at_eos=False, seed=0)
    eng.generate(prompt[:8], g)
    res = eng.generate(prompt[:8], g)
    print(json.dumps({"what": "generate",
                      "ms_per_token": res.timings["ms_per_token"],
                      "new_tokens": res.timings["n_new"], "card": stamp}),
          flush=True)


def step_slots(eng, past: int):
    """The slot state of :func:`profile_batched`'s steps on ``eng``'s B
    slots: every slot at token 40 and position ``past``, sampled at temp
    0.9, top-p 0.9, top-k 40."""
    from ..runtime.serving import _Slots

    def full(v, dtype):
        return torch.full((eng.B,), v, dtype=dtype, device=eng.device)

    return _Slots(toks=full(40, torch.int32),
                  lengths=full(past, torch.int32),
                  first_buf=full(0, torch.int32),
                  temps=full(0.9, torch.float32),
                  top_ps=full(0.9, torch.float32),
                  top_ks=full(40, torch.int32))


def profile_batched(config, params, args, stamp: str) -> None:
    from ..runtime.engine import _bucket
    from ..runtime.serving import BatchedEngine

    B = args.batch
    eng = BatchedEngine(config, params, max_batch=B, max_seq=512, chunk=16,
                        device="cuda")
    dev = eng.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def prepare():
        st = step_slots(eng, args.past)
        torch.cuda.synchronize()
        return st, eng.new_cache()

    for greedy in (True, False):
        def run_steps(state, n):
            st, cache = state
            window = min(_bucket(args.past + n, floor=128), eng.max_seq)
            enqueue = []
            t0 = time.perf_counter()
            for _ in range(n):
                te = time.perf_counter()
                nxt, _, cache = eng._step(st, cache, live, window, greedy, gen)
                st.toks = nxt.to(torch.int32)
                st.lengths = st.lengths + 1
                enqueue.append(time.perf_counter() - te)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3, sorted(enqueue)

        measure(prepare, run_steps, args.steps, stamp,
                args.trace if greedy else None, batch=B, past=args.past,
                tail="greedy" if greedy else "sampled")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--past", type=int, default=100,
                    help="cache length at the first profiled step")
    ap.add_argument("--batch", type=int, default=1,
                    help="1: the single-stream step; 2..32: the serving step")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the (greedy) profiled steps "
                         "here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2

    from ..config import BioGptConfig
    from ..modelio.checkpoint import load_params
    from ..modelio.synthetic import write_random_quantized_model
    from ..ops import cuda_lib

    stamp = card_stamp()
    cuda_lib.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.bin")
        write_random_quantized_model(path, BioGptConfig(), seed=7)
        config, _, _, params = load_params(path, device="cpu")
    (profile_single if args.batch == 1 else profile_batched)(
        config, params, args, stamp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
