"""Where a decode step's time goes on the card.

    python -m biogpt_tpu_torch.tools.profile_decode [--steps 32] [--past 100]
                                                    [--batch 1] [--trace out.json]

Builds a BioGPT-347M Q4_0 model on random weights (``write_random_
quantized_model``, seed 7) and measures one decode step three ways,
printing one JSON line each (with ``--batch 1``, a ``first_use`` line
first: the B=1 libraries' loads and the commit's first launches):

  - ``wall``: host clock over ``--steps`` steps ending in a synchronize
    (ms/step), and the host time to enqueue one step without waiting;
  - ``device``: ``torch.profiler`` over the same steps: kernel launches per
    step, summed kernel time per step, and the device's idle share of the
    wall window, with the kernels that take the most time;
  - ``step_routes`` (``--batch 1`` only): the same steps at the device
    position and at the host's int position, greedy and sampled (the
    sampler's temp and top_p as device tensors or host floats),
    alternating, four rounds;
  - ``generate`` (``--batch 1`` only): ``Engine.generate`` ms/token over
    128 greedy tokens after a key's eager runs and its capture, on the
    graph route (each decode chunk one CUDA graph's replay) and with the
    engine's capture off (the eager chunk).

``--batch 1`` (default) is the single-stream main path: the ``Engine``
prefills a prompt of ``--past`` tokens into its own cache, and the step is
``generate``'s: the fused decode step + fused LN/lm_head/argmax tail + the
KV commit at the engine's (1,) device position, advanced in place. ``--batch B`` (2..32)
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
from types import SimpleNamespace

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


def first_use(config, stamp: str) -> None:
    """Print the ``first_use`` line: in this fresh process, each B=1
    library's load (``cuda_lib.library``), the B=1 commit's
    (``kv_commit``) first and second launch at the card's full depth, and
    the sampler's first and second call on (1, V) logits with temp and
    top_p as host floats and then as (1, 1) device tensors, each to a
    synchronize: what a cold process pays once."""
    from ..ops import cuda_lib
    from ..ops.decode_kernels import kv_commit
    from ..runtime.sampling import sample_top_k_top_p

    load = {}
    for name in ("qmatmul", "lm_head_argmax", "decode_step", "kv_commit"):
        t0 = time.perf_counter()
        cuda_lib.library(name)
        load[name] = (time.perf_counter() - t0) * 1e3
    L, D = config.n_layer, config.d_model
    k = torch.zeros(L, 1, 128, D, dtype=torch.bfloat16, device="cuda")
    v = torch.zeros_like(k)
    rows = torch.ones(1, L, D, dtype=torch.bfloat16, device="cuda")
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    launches = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv_commit(k, v, rows, rows, pos)
        torch.cuda.synchronize()
        launches.append((time.perf_counter() - t0) * 1e3)
    logits = torch.randn(1, config.n_vocab, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = dict(dtype=torch.float32, device="cuda")
    sampler = {}
    for name, p in (("host_floats", 0.9),
                    ("device_tensors", torch.full((1, 1), 0.9, **dev))):
        sampler[name] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample_top_k_top_p(logits, g, top_k=40, top_p=p, temp=p)
            torch.cuda.synchronize()
            sampler[name].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"what": "first_use", "library_load_ms": load,
                      "kv_commit_launch_ms": launches,
                      "sampler_call_ms": sampler, "card": stamp}),
          flush=True)


def profile_single(config, params, args, stamp: str) -> None:
    from ..config import GenerationParams
    from ..runtime.engine import Engine
    from ..runtime.graphs import ChunkGraphs

    eng = Engine(config, params, device="cuda")
    prompt = [2] + [40 + i % 50 for i in range(args.past - 1)]
    gen = GenerationParams(n_predict=args.steps + 2, temp=0.0,
                           stop_at_eos=False)

    st = eng._decode_state()

    def prepare():
        logits, cache, past = eng.prefill(eng._gen_cache(), prompt)
        st.pos.fill_(past)
        torch.cuda.synchronize()
        return cache, torch.argmax(logits, -1).to(torch.int32), past

    def run_steps(state, n, device_pos=True, greedy=True, params=st):
        cache, tok, past = state
        window = eng._window(past + n)
        enqueue = []
        t0 = time.perf_counter()
        for i in range(n):
            te = time.perf_counter()
            tok, _ = eng._step(cache, tok.reshape(1, 1).long(),
                               st.pos if device_pos else past + i, window,
                               greedy, gen.top_k, params)
            if device_pos:
                st.pos.add_(1)
            enqueue.append(time.perf_counter() - te)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, sorted(enqueue)

    measure(prepare, run_steps, args.steps, stamp, args.trace, batch=1,
            past=args.past)
    # the same steps at the host's int position (committed by
    # ``commit_rows``, as ``Engine.decode_step`` callers run them) beside
    # the device position's, greedy and sampled (temp and top_p 0.9 as
    # the engine's device tensors or as host floats), alternating in one
    # process
    st.temp.fill_(0.9)
    st.top_p.fill_(0.9)
    floats = SimpleNamespace(temp=0.9, top_p=0.9)
    routes = {"device_position": (True, True, st),
              "host_int": (False, True, st),
              "sampled_device_position": (True, False, st),
              "sampled_host_int": (False, False, st),
              "sampled_device_position_host_floats": (True, False, floats),
              "sampled_host_int_host_floats": (False, False, floats)}
    rounds = {r: [] for r in routes}
    for _ in range(4):
        for r, route in routes.items():
            ms, enqueue = run_steps(prepare(), args.steps, *route)
            rounds[r].append((ms, enqueue[len(enqueue) // 2] * 1e3))
    print(json.dumps({
        "what": "step_routes", "batch": 1, "past": args.past,
        "steps": args.steps,
        **{r: {"ms_per_step": [m for m, _ in v],
               "host_enqueue_ms_median": [e for _, e in v]}
           for r, v in rounds.items()}, "card": stamp}), flush=True)
    g = GenerationParams(n_predict=128, temp=0.0, stop_at_eos=False, seed=0)
    eager = Engine(config, params, device="cuda")
    eager.graphs.capture = False
    for route, e in (("graph", eng), ("eager", eager)):
        for _ in range(ChunkGraphs.EAGER_RUNS + 1):   # the graphs captured
            e.generate(prompt[:8], g)
        res = e.generate(prompt[:8], g)
        print(json.dumps({"what": "generate", "route": route,
                          "ms_per_token": res.timings["ms_per_token"],
                          "new_tokens": res.timings["n_new"],
                          "graphs": e.graphs.stats(), "card": stamp}),
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
    if args.batch == 1:
        first_use(config, stamp)
    (profile_single if args.batch == 1 else profile_batched)(
        config, params, args, stamp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
