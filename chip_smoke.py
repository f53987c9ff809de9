"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed; each
logs its seconds):
  1. card stamp: name and power limit (nvidia-smi), TF32 off; every kernel
     library built from ``biogpt_tpu_torch/csrc`` (one nvcc per source,
     started together);
  2. every kernel of the single-stream path against its plain PyTorch
     version at BioGPT-347M shapes on seeded random planes, with its time
     beside its bound, the plain version's time and a one-call PyTorch
     yardstick (each a device time: a spin on the card covers the host's
     enqueue of the call, whose time is kept beside it; :func:`time_ms`);
     the B=1 step at past 1, 100 and 900 (its position also as a (1,)
     tensor on the card), at 100 and 900 timed and traced: 5 launches a
     layer of its own chain and none of the chain it replaced
     (:func:`b1_trace`); ``qmatmul_wide`` at 9, 16, 17, 31 and 32 rows on
     every projection and the lm_head, at 16 and 32 timed and traced to
     one launch of the streaming GEMV (:func:`wide_trace`); the M <= 8
     tails at 1, 2, 5 and 8 rows, greedy and sampled, with a forced tie
     and a NaN row (:func:`hold_small_tails`), the CLI's greedy tail
     traced to the streaming GEMV and the fold; then ``qmatmul`` (row 1,
     ``csrc/qmatmul.cu``) at every M from 1 to 8 in every format on the
     five shapes, the TP ranks' local lm_head widths, a 4096 -> 4096
     plane and Q5-odd widths (d_in 640, 1600), each call traced to one
     launch of its route's kernel, and timed at M = 1 and 8 on each shape
     (:func:`phase_qmatmul_kernels`);
  3. likewise every kernel of the batched serving path: the batched decode
     step at B=8 and B=32 (window 512, ragged positions, dead slots; at
     B=32 a profiler trace shows the tensor-core GEMV on all four
     projections of every layer and where the step's time goes), the KV
     commit (with row 10's rule: its time against the index store, its
     bound and an empty launch), and the greedy and sampled lm_head +
     commit tails at M=8, 16 and 32 (and on Q4_1 planes at M=32), at M=16
     and 32 traced: the LayerNorm'd rows and the tensor-core GEMV
     (``lm_head_mma_kernel``), never the scalar tile (:func:`tail_trace`);
  4. likewise the kernels of the refill and int8 KV paths: ``prefill_fused``
     at 32x32, 8x128 and 1x512 prompts x tokens (ragged lengths; with the
     per-op refill it replaces timed beside it; traced: 7 launches a layer,
     the wgmma GEMM on all four projections, the tensor-core attention,
     never the kernels they replaced, and each part's device ms,
     :func:`prefill_trace`), the int8 decode step at
     B=1 (past 100 and 900, traced: 5 launches a layer) and at B=8 and
     B=32 (window 512, ragged positions, dead slots; Q4_0, and Q4_1 at B=1
     and B=32), and ``kv_commit_quant``
     (bit-equal, positions clamped) and its mode with the rows'
     quantization folded in, ``kv_commit_quant_rows`` (bit-equal to
     ``quantize_rows`` + the plain commit at B=32 and B=1 on rows with
     exact .5 ties, a zero row, NaN and inf rows, positions clamped;
     :func:`hold_commit_rows`);
  5. likewise the paged and staged steps: the paged step, bf16 and int8, at
     B=1 (past 100 and 600) and B=32 (window 512, ragged positions, dead
     slots, a slot past the window), also held against the batched CUDA
     step, and the staged step at B=32 (16 staging rows, steps 0, 7, 15;
     Q4_1 step 7);
  5a. the batched steps' attention alone (``batched_attention``: one
     launch of ``attn_batched_kernel``, ``csrc/attn_batched.cuh``) against
     its plain version in every mode (lockstep and paged KV blocks, bf16
     and int8, staged at steps 0, 7, 15) at B=32 window 512 ragged and at
     the uniform serve's window 128 (each timed beside its bound and one
     ``scaled_dot_product_attention`` call a layer), B=8 with a slot past
     the window, window 1024 (eight 128-row blocks, a slot at 1000 live
     rows whose running max rises late); then each batched step at both
     shapes timed and traced (``step_breakdown`` lines: device ms, the
     attention's spans and its time after the qkv GEMV ends); every
     batched step's trace in phases 3-6 shows one ``attn_batched_kernel``
     a layer and none of the kernels it replaced (:func:`gemv_trace`);
  5b. the batched steps' projection alone (``decode_gemv``, the
     tensor-core GEMV with its LayerNorm prologue and bias, GELU or
     residual epilogue) at qkv, o, fc1 and fc2 shapes, M = 8, 16, 32, in
     every format, timed beside its bound and ``x_bf16 @ dequantize(W)``;
     every B=32 batched, paged and staged step in phases 3-6 is traced to
     launch it 4 L times and the scalar-FMA GEMV never; then
     ``qmatmul_wide`` at the same uneven widths and on 8192 -> 1024 and
     32768 -> 1024 planes, every format;
  5c. the B=1 step's projection alone (``decode_gemv_b1``, the M=1 GEMV
     with the X' numerics, its LayerNorm computed in each block, and its
     bias, GELU or residual epilogue) at the same four shapes in every
     format, timed beside its bound and ``x_bf16 @ dequantize(W)``, and
     held untimed at three uneven widths;
  5d. the refill kernel's GEMM alone (``prefill_gemm``, the wgmma GEMM
     with its qkv, residual or GELU epilogue) at its four projections, at
     1024, 512 and uneven row counts, in every format, at 1024 rows timed
     beside its bound and ``a_bf16 @ dequantize(W)``;
  6. every kernel that reads weights again in each of Q5_0, Q5_1 and
     Q8_0 (the GEMVs at every projection shape, ``lm_head_argmax`` and both
     tails, the B=1 (past 100 and 900), batched, paged and staged steps
     with bf16 and int8 KV, ``prefill_fused``; the steps and the refill
     ``FORMAT_DEPTH`` (6) layers deep) against its plain version
     with the Q4 limits, timed beside its bound and yardstick (the
     lm_head's ``qmatmul_wide`` at M = 16 and 32 among them; the M <= 8
     tails at 1, 2, 5, 8 rows and the two serving tails at M = 8 too);
  7. the tensor-parallel decode step's halves (attention, the int8 mode's
     qkv and attention, FFN) of a random 347M model's shards at tp 2 and 4,
     in every format with bf16 and int8 KV, B=32 (window 512, ragged
     positions, dead slots): every shard's halves over 24 layers in one
     process, their partials summed in shard order, against the plain
     halves (each layer's hidden state, the final one, every shard's K/V
     rows), each half alone (traced: every projection on the tensor-core
     GEMV) and one shard's step timed beside their bounds;
  8. single stream end to end: a 347M Q4_0 model file with random weights,
     the CLI greedy (prompts of <= 8, 9-32 and >= 33 tokens, 128 new
     tokens) and sampled, then the CLI ``--kv-quant`` greedy, the launch
     counts of each, 8 teacher-forced decode steps of the kernels against
     the plain path, the int8 steps' commit traced on the lockstep, paged
     and single-stream steps (one ``kv_commit_quant_rows_kernel`` after
     the step, no PyTorch kernel: :func:`commit_traces`), the decode rate
     with a bf16 and an int8 cache (a warm engine's fourth generation,
     every chunk a graph replay);
  9. serving end to end on the same file, once with a bf16 and once with
     an int8 KV cache: ``BatchedEngine.serve`` of 96 uniform greedy
     requests at B=32 (refills through ``prefill_fused``; the wall split
     into decode chunks, refill waves and the rest), then the HTTP server
     answering 8 concurrent mixed greedy/sampled requests, one SSE stream
     and ``GET /stats``, the launch counts of that run; one refill wave's
     first-token logits through the prefill kernel against the per-op
     refill (bf16); 8 teacher-forced B=32 steps of the kernels against the
     plain path; the tokens/s of each run;
  10. the paged (bf16 and int8) and staged engines on the same file: the
     uniform greedy serve (ids against the lockstep serve's, the launch
     counts; the staged step's tail traced to one launch of the streaming
     GEMV) and a mixed-length serve of 32 requests, half greedy (its
     greedy rows against the lockstep engines' on the same requests);
  9a. the decode chunks, refills and prefills as CUDA graphs on the same
     file (:func:`phase_graphs`; every single-device route above runs
     through graph replays once a key has run eagerly twice): each
     graph-route engine beside one whose capture is off (its bodies under
     ``set_sync_debug_mode("error")``): the single stream (bf16, int8;
     greedy, sampled; 150 tokens across windows 128 and 256; and the
     per-op route, an f16 cache and unpacked weights, 32 tokens; four
     generations each: two eager, the capturing one, one of replays),
     refill groups alone (1 x 16, 4 x 32, 32 x 32, 16 x 128, 32 x 512;
     host and device ms, each key's pool bytes),
     the lockstep, paged (bf16, int8) and staged serves at B=32 (uniform
     greedy and mixed) and the per-op serve (an f16 cache, B=8): ids
     equal exactly, caches bit-equal, refill and prefill keys captured and
     replayed, ms/token, tokens/s, wall and device ms a step of both
     routes, captures, capture seconds and the graphs' pool bytes; a
     64-step (B=1) and a 16-step (B=32) graph's replay timed, and replays
     traced (a refill's too): the launch counts a replay adds against the
     kernels its trace shows; the local-batch probe on the refill kernel's
     route and the per-op route;
  11. tensor-parallel serving on a file of 347M's widths 4 layers deep:
     two ranks that share the card (the port's launcher, gloo, this
     script with ``--tp-rank``; the kernels built before they start) serve
     the uniform 96 greedy requests through ``BatchedEngine(mesh,
     tp_fused_decode=True)`` with a bf16 and an int8 cache and a mixed
     serve, each rank launching exactly the TP route's kernels, the ranks'
     ids equal (and counted against the lockstep serve of that file), with
     a refill wave and teacher-forced TP steps of the kernels against the
     plain halves; then a (1, 1) mesh in this process on the main file:
     the same serve, and ``Engine(mesh).generate`` at B=1;
  11a. the rest of the mesh on a file of 347M's widths 4 layers deep
     (:func:`phase_mesh_serving`, every rank a process on the one card,
     started by the launcher with gloo, this script with ``--mesh-rank``;
     the lockstep serves and a (1, 1) mesh generate of that file in this
     process): (a) a (2, 2) mesh of four
     ranks serves the uniform 96 greedy requests at B=32 through
     ``BatchedEngine(mesh, tp_fused_decode=True)`` with a bf16 and an int8
     cache and a mixed serve: each rank holds 16 slots of D / 2 features,
     launches exactly the TP route's kernels, exchanges over the data axis
     once a chunk and once a refill wave; the four ranks' ids equal, and
     counted against (d)'s (1, 2) serve; teacher-forced TP steps at
     the local batch against the plain halves; the local-batch probes
     (a replica's refill of 16 rows against the group's 32, and of 2
     prompts against a group of 4 padded to 8, op by op) held; (b)
     ``Engine(mesh=(2, 1)).generate`` at B=1 on two ranks: the (1, 1) mesh
     engine's ids; (d) the (1, 2) TP serves of (a)'s requests; (c) the
     route of unpacked weights (``pack_q4=False``, f32) on a (1, 2) mesh:
     a traced 16-token generate with no launch of the port's kernels, its
     scores within 1e-3 of the single-device engine's, ids equal where the
     top-2 margin exceeds that, a serve of 8 requests, and each rank's
     resident weight bytes (the sharded planes halved, the rest whole);
  12. a random file of 347M's widths, 6 layers deep, in each of Q4_1,
     Q5_0, Q5_1 and Q8_0: the CLI
     greedy, sampled and ``--kv-quant`` (32 new tokens), the uniform
     greedy serve of 96 requests (bf16 and int8 lockstep, paged, staged),
     each run launching exactly its route's kernels (the batched, paged
     and staged steps' GEMV counted as ``decode_gemv``; an unpacked Q8_0
     lm_head takes the lm_head GEMV, never the argmax tails), teacher-
     forced B=1 and B=32 steps and a refill wave against the plain path;
  13. the README's model files at 347M (:func:`phase_model_files`): the
     HF golden's seed-7 state dict written as an HF directory, converted
     to f32 and f16 files and quantized to the five formats; the f32 file
     against HF's own prefill logits and greedy ids (dense f32 path), the
     Q4_0 and Q4_1 files against the quantized goldens (f32, unpacked)
     and, on the production path (bf16, packed), against the card's own
     golden (``check_goldens_gpu``: two eager generations and one of graph
     replays), the Q4_0 file through the CLI's engine after ``warmup()``
     and ``perplexity_of_ids`` at window 32 (rows 1 and 2, the windows'
     nll against the CPU's plain versions), and perplexity at window 1024
     of every file with tokens/s, its full windows replaying one scoring
     graph (the first window's nll equal to its eager run's);
  14. the ``kernels`` line (each kernel with the formats this run held it
     in against its plain version, or drove its route in) and the result
     line.

``python3 chip_smoke.py --attn-probe`` runs only :func:`attn_probe`: each
batched step's ``step_breakdown`` at both shapes, with entry points every
tree of the port has (to compare two trees in one call).
``python3 chip_smoke.py --wide-probe`` runs only :func:`wide_probe`: the
numbers of ``qmatmul_wide`` and the M <= 8 tails and of the paths they sit
on, with entry points every tree of the port has (to compare two trees in
one call).
``python3 chip_smoke.py --qmm-probe`` runs only :func:`qmm_probe`: the
numbers of ``qmatmul`` at M <= 8 (each of its two routes on every shape,
where the tree has them) and of the int8 commit as the steps run it, the
int8 steps and the CLI's decode rates (the sampled CLI and a short
prefill on each route), with entry points every tree of the port has (to
compare two trees in one call).

``python3 chip_smoke.py --refill-probe`` runs only :func:`refill_probe`:
the refill kernel's and the per-op refill's device ms at a serve's refill
shapes, with entry points every tree of the port has (to compare two trees
in one call).
``python3 chip_smoke.py --model-files`` runs only :func:`phase_model_files`.
``python3 chip_smoke.py --graphs`` runs only :func:`phase_graphs` (phase
9a) on the main file.
``python3 chip_smoke.py --mesh`` runs only :func:`mesh_phases`: the
lockstep serves and phases 11 and 11a.

Needs a CUDA card; exits non-zero without one or without the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

FAILURES: list = []
SPREAD: dict = {}
WINDOWS: dict = {}   # fn -> every timing window's ms (time_ms)
HOST: dict = {}    # fn -> its host enqueue time and spin (time_ms)
SPIN: dict = {}    # the device spin's clock rate (spin_rate)
# weight formats: name -> (ggml type, level bits as the engines prepare them)
FORMATS = {"q4_0": (2, 4), "q4_1": (3, 4), "q5_0": (6, 5), "q5_1": (7, 5),
           "q8_0": (8, 8)}
# the row counts ``qmatmul_wide`` is held at (8 < M <= 32, one and two
# m16 tiles, full and partial)
WIDE_ROWS = (9, 16, 17, 31, 32)
# the row counts the M <= 8 lm_head tails are held at
SMALL_TAIL_ROWS = (1, 2, 5, 8)
# the row counts ``qmatmul`` (row 1) is held at in every format
QMM_ROWS = tuple(range(1, 9))
# the formats after Q4_0 and Q4_1, held kernel by kernel on their own
NEW_FORMATS = ("q5_0", "q5_1", "q8_0")
# the formats driven end to end from a model file of their own (Q4_0 is the
# main file's)
E2E_FORMATS = ("q4_1",) + NEW_FORMATS
# the depth of the steps and model files of the format phases (6 and 12):
# 347M's widths, a quarter of its 24 layers; every width-dependent path is
# the same at any depth, and the Q4_0 phases keep the full depth
FORMAT_DEPTH = 6


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(what)
        log(f"FAIL: {what}")


def spin_rate() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep`` on this card, timed once
    with CUDA events over a 20M-cycle spin."""
    if "cycles_per_ms" not in SPIN:
        n = 20_000_000
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(n)
        e.record()
        torch.cuda.synchronize()
        SPIN["cycles_per_ms"] = n / s.elapsed_time(e)
    return SPIN["cycles_per_ms"]


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` CUDA-event-timed calls.
    Before each call, outside the window, on an idle card: ``flush``, then
    a device spin (``torch.cuda._sleep``) of four times the call's host
    enqueue time (0.5 ms at least, 100 ms at most; ``utils.profiling.
    spin_cycles``: the host's time per call varies 2-3x from call to
    call), so the host enqueues the call's launches while the
    card spins and the window opens when the spin ends: it holds device
    time alone, unless the host took longer than the spin. The card is
    idle before each call (a synchronize), so no backlog of earlier calls
    stalls the host's enqueue. The host's time around each call goes into
    ``HOST[fn]`` (median ``host_ms``, ``spin_ms``, ``host_inclusive``,
    and ``host_over_spin``, the windows whose call the host took longer to
    enqueue than their spin ran: those hold host time), the spread (min,
    max) of the windows into ``SPREAD[fn]``, and every window's ms, its
    call's host ms, its spin's ms and the SM clock the spin ran at (its
    cycles over its ms) into ``WINDOWS[fn]``."""
    from biogpt_tpu_torch.utils.profiling import spin_cycles

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    rate = spin_rate()
    cycles = spin_cycles(warm_ms, rate)
    evs, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        if flush is not None:
            flush()
        z = torch.cuda.Event(enable_timing=True)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        z.record()
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        e.record()
        evs.append((z, s, e))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for _, s, e in evs]
    spins = [z.elapsed_time(s) for z, s, _ in evs]
    SPREAD[fn] = [min(times), max(times)]
    WINDOWS[fn] = {"ms": times, "host_ms": host, "spin_ms": spins,
                   "spin_mhz": [cycles / t / 1e3 for t in spins]}
    host_ms, spin_ms = statistics.median(host), cycles / rate
    HOST[fn] = {"host_ms": host_ms, "spin_ms": spin_ms,
                "host_inclusive": host_ms > spin_ms,
                "host_over_spin": sum(h > t for h, t in zip(host, spins))}
    return statistics.median(times)


def timed(rec: dict, kfn, plain, lib_call, nbytes, flops, reps=20,
          plain_reps=3, flush=None) -> dict:
    """Add the kernel's, the plain version's and the yardstick's device
    times, each with its host enqueue time and whether its window is
    host-inclusive (:func:`time_ms`), and the bound to ``rec``
    (``tools/kernel_bounds.py``: the H100's published memory and bf16
    rates). A kernel's window must hold device time alone."""
    from biogpt_tpu_torch.tools.kernel_bounds import bound

    b_ms, b_by = bound(nbytes, flops)
    rec.update(kernel_ms=time_ms(kfn, reps, flush), kernel_ms_range=SPREAD[kfn],
               kernel_host_over_spin=HOST[kfn]["host_over_spin"],
               kernel_spin_mhz_range=[min(WINDOWS[kfn]["spin_mhz"]),
                                      max(WINDOWS[kfn]["spin_mhz"])],
               kernel_host_ms=HOST[kfn]["host_ms"], spin_ms=HOST[kfn]["spin_ms"],
               kernel_host_inclusive=HOST[kfn]["host_inclusive"],
               plain_ms=time_ms(plain, plain_reps, flush),
               plain_host_ms=HOST[plain]["host_ms"],
               plain_host_inclusive=HOST[plain]["host_inclusive"],
               library_ms=None, library_host_ms=None,
               library_host_inclusive=None,
               bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
    if lib_call is not None:
        rec.update(library_ms=time_ms(lib_call, reps, flush),
                   library_host_ms=HOST[lib_call]["host_ms"],
                   library_host_inclusive=HOST[lib_call]["host_inclusive"])
    check(not rec["kernel_host_inclusive"],
          f"{rec.get('kernel', rec.get('tp_step'))}: the kernel's window "
          "holds host time "
          f"({rec['kernel_host_ms']} ms on the host, {rec['spin_ms']} ms spin)")
    return rec


def rows_within(got, want, what: str) -> float:
    """Check each layer's K/V rows (L, B, D) against the plain ones, to two
    bf16 ulps (2^-6 of that layer's largest magnitude); returns the worst
    error as a fraction of its layer's limit. A row comes after all earlier
    layers' attention, so an attention fault shows here even where the FFN
    residual dominates the hidden state. Two ulps, not one: the hidden
    state entering a layer's LN already differs by ~1e-3 between the two
    paths, and rows measured up to 1.35 ulps of the layer's largest
    magnitude apart (H100)."""
    worst = 0.0
    for lyr in range(want.shape[0]):
        g, w = got[lyr].float(), want[lyr].float()
        tol = 2 ** -6 * w.abs().max().item()
        err = (g - w).abs().max().item()
        check(err <= tol, f"{what}: layer {lyr} rows err {err} > {tol}")
        worst = max(worst, err / max(tol, 1e-30))
    return worst


def hidden_within(got, want, what: str) -> float:
    """The decode step's hidden state: the bf16 path rounds h, q and p to
    bf16, and the kernel's softmax splits differ from the plain version's
    KV blocks, so a rounding flip can move one product by a bf16 ulp. Over
    24 layers it measured within 1.3e-3 of its magnitude (H100): the limit
    is 3e-3. Returns the error."""
    err = (got - want).abs().max().item()
    tol = 3e-3 * want.abs().max().item()
    check(err <= tol and bool(torch.isfinite(got).all()),
          f"{what}: x err {err} > {tol}")
    return err


def quant_rows_within(got, want, what: str) -> float:
    """int8 K/V rows, levels (L, B, D) with row scales (L, B), against the
    plain ones, dequantized: :func:`rows_within`'s limit on the rows
    before quantization (two bf16 ulps of the layer's largest magnitude)
    carried through it -- quantizing moves a value by at most half its
    row's scale, so each row may differ by the limit plus half the two
    rows' scales. Returns the worst error as a fraction of its limit."""
    (q, s), (qp, sp) = got, want
    worst = 0.0
    for lyr in range(q.shape[0]):
        g = q[lyr].float() * s[lyr][..., None]
        w = qp[lyr].float() * sp[lyr][..., None]
        tol = (2 ** -6 * w.abs().max().item()
               + (s[lyr] + sp[lyr])[..., None] / 2)
        ratio = ((g - w).abs() / tol).max().item()
        check(ratio <= 1, f"{what}: layer {lyr} rows err {ratio} of the limit")
        worst = max(worst, ratio)
    return worst


def layers_within(got: list, want: list, what: str) -> float:
    """Each layer's hidden state (B, D) against the plain one, on that
    layer's own scale: 3e-3 of its largest magnitude, the limit of
    :func:`hidden_within` taken per layer, as :func:`rows_within` holds the
    K/V rows. It stands beside the final state's limit, which follows the
    weights' mean (the residual stream's magnitude grows with it), and
    applies where a step's layers come out one by one (the TP halves; a
    fused step returns only its last layer, where the two coincide).
    ``got[l]`` is layer l's output from the same input as ``want[l]`` (the
    plain step's state before layer l), so each layer is held on its own;
    the final state holds the 24 layers' accumulated error. Returns the
    worst error as a fraction of its layer's limit."""
    worst = 0.0
    for lyr, (g, w) in enumerate(zip(got, want)):
        tol = 3e-3 * w.abs().max().item()
        err = (g - w).abs().max().item()
        check(err <= tol and bool(torch.isfinite(g).all()),
              f"{what}: layer {lyr} x err {err} > {tol}")
        worst = max(worst, err / max(tol, 1e-30))
    return worst


def fed_rows(plain, k_rows, v_rows):
    """``plain()`` with its int8 mode's fake quantization of each layer's
    current rows fed the kernel's rows (``k_rows``, ``v_rows`` (L, B, D)
    f32, in the order the plain step quantizes them: each layer's k, then
    its v) in place of its own -> its output."""
    from biogpt_tpu_torch.ops import decode_kernels as dk

    rows = iter([r for pair in zip(k_rows, v_rows) for r in pair])
    own = dk.fake_quant_rows
    dk.fake_quant_rows = lambda x: own(next(rows).reshape(x.shape))
    try:
        out = plain()
    finally:
        dk.fake_quant_rows = own
    check(next(rows, None) is None,
          "fed_rows: the plain step quantized fewer rows than it returned")
    return out


def held_step(run, plain, what: str, rec: dict, int8: bool = False):
    """Run a decode or prefill step's kernel and its plain version, hold
    the hidden state and every layer's K/V rows to the steps' limits
    (:func:`hidden_within`, :func:`rows_within`) and note the errors in
    ``rec`` -> the kernel's (x, k_rows, v_rows). With an int8 cache
    (``int8``) each layer fake-quantizes its current rows, each path from
    its own qkv: a row can differ by one int8 level, and a dead slot's
    context is its current row alone, so the step carries that whole
    level into x. The hidden state is then held against the plain version
    fed the kernel's current rows (:func:`fed_rows`), as the TP step's
    is; the rows stay held on each path's own quantization, and x's error
    against the plain version on its own rows is noted
    (``x_err_own_rows``, and over the limit)."""
    x, kr, vr = run()
    xp, krp, vrp = plain()
    torch.cuda.synchronize()
    if int8:
        own = (x - xp).abs().max().item()
        rec.update(x_err_own_rows=own, x_err_own_rows_over_tol=own / (
            3e-3 * xp.abs().max().item()))
        xp = fed_rows(plain, kr, vr)[0]
        torch.cuda.synchronize()
    err = hidden_within(x, xp, what)
    rows = max(rows_within(kr, krp, what + " k"),
               rows_within(vr, vrp, what + " v"))
    rec.update(max_abs_err=err, tol=3e-3 * xp.abs().max().item(),
               rows_err_over_tol=rows)
    return x, kr, vr


# short spins that open each trace window (kernel_trace)
TRACE_PAD = 8
# retakes of a window the tracer returned empty (it lost two running once,
# in a process that had taken some hundreds of traces, H100)
TRACE_EMPTY_RETAKES = 3


def kernel_trace(run, seq: list | None = None,
                 counted: dict | None = None,
                 log_dir: str | None = None) -> dict:
    """One call of ``run`` under ``torch.profiler`` (the card's records
    only, ``utils.profiling.trace``) -> {kernel name: [launches, device
    ms]}; ``seq``, where given, gets every device record as (name, start
    us, device ms) in start order, ``counted`` the wrappers' launch counts
    (``cuda_lib.LAUNCHES``) that the call of the window returned added,
    and ``log_dir`` the window's Chrome trace (``trace.json``).
    ``TRACE_PAD`` short spins open the window: on
    some H100 hosts, after a few dozen traces in one process, the tracer
    lost the records of a window's first one to three kernels, and once in
    a while a whole window: the spins take the first losses, a window
    without a single device record (the spins always run) is taken again,
    calling ``run`` again, up to ``TRACE_EMPTY_RETAKES`` times, and the
    checks take a short trace again."""
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.utils.profiling import trace

    for _ in range(TRACE_EMPTY_RETAKES + 1):
        torch.cuda.synchronize()
        before = dict(cuda_lib.LAUNCHES)
        with trace(log_dir, host=False) as prof:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(1000)
            run()
            torch.cuda.synchronize()
        if counted is not None:
            counted.clear()
            counted.update({k: v - before.get(k, 0)
                            for k, v in cuda_lib.LAUNCHES.items()})
        names, recs = {}, []
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                n = names.setdefault(ev.name, [0, 0.0])
                n[0] += 1
                n[1] += ev.time_range.elapsed_us() / 1e3
                recs.append((ev.name, ev.time_range.start,
                             ev.time_range.elapsed_us() / 1e3))
        if recs:
            break
    if seq is not None:
        seq.extend(sorted(recs, key=lambda r: r[1]))
    return names


def launches_of(names: dict, kernel: str) -> int:
    return sum(v[0] for k, v in names.items() if kernel in k)


def span_ms(names: dict, kernel: str) -> float:
    return sum(v[1] for k, v in names.items() if kernel in k)


# the batched, paged and staged steps' attention (csrc/attn_batched.cuh),
# and the kernels those steps must never launch: the split and combine
# kernels it replaced, the paged CTA (the B=1 and TP chains' own) and the
# separate absmax launch of the int8 mode
BATCHED_ATTN = "attn_batched_kernel"
BATCHED_ATTN_NEVER = ("attn_split_batched_kernel",
                      "attn_combine_batched_kernel", "attn_paged_kernel",
                      "row_absmax_kernel")


def trace_whole(names: dict, L: int) -> bool:
    """Whether a step's trace holds every record of the kernels beside its
    GEMVs: the LayerNorm statistics (``row_stats_kernel``, 2 L) and the
    attention (``attn_batched_kernel``, L)."""
    return (launches_of(names, "row_stats_kernel") == 2 * L
            and launches_of(names, BATCHED_ATTN) == L)


def gemv_trace(run, L: int, what: str) -> dict:
    """One step of ``run`` under ``torch.profiler``: the batched, paged and
    staged steps must launch the tensor-core GEMV (``qgemv_mma_kernel``)
    for all four projections of every layer, 4 L launches by the step's
    own count (``decode_gemv``) and in the trace, and the scalar-FMA
    ``qgemv_partial_kernel`` for none; and their attention as one launch
    of ``attn_batched_kernel`` a layer (L by ``batched_attention``'s count
    and in the trace), none of ``BATCHED_ATTN_NEVER`` -> {kernel name:
    [launches, device ms]}. A trace short of GEMV records is taken again, up to three times,
    only where the tracer lost records of the step's other kernels too
    (:func:`trace_whole`; it dropped 53 of 96 once in 27 traces on the
    H100): GEMV records missing from an otherwise whole trace fail at
    once. Every attempt's counts are printed."""
    attempts = []
    for attempt in range(3):
        launches = {}
        names = kernel_trace(run, counted=launches)
        counted = launches["decode_gemv"]
        mma = launches_of(names, "qgemv_mma_kernel")
        old = launches_of(names, "qgemv_partial_kernel")
        attn = launches_of(names, BATCHED_ATTN)
        attn_counted = launches["batched_attention"]
        never = {k: launches_of(names, k) for k in BATCHED_ATTN_NEVER}
        whole = trace_whole(names, L)
        attempts.append({"qgemv_mma_kernel": mma, "decode_gemv_counted":
                         counted, "qgemv_partial_kernel": old,
                         BATCHED_ATTN: attn,
                         "batched_attention_counted": attn_counted,
                         "never": never, "others_whole": whole,
                         "records": sum(v[0] for v in names.values())})
        if (mma == 4 * L and attn == L) or whole:
            break
    check(mma == 4 * L and counted == 4 * L and old == 0,
          f"{what}: {mma} tensor-core GEMV launches in the trace and "
          f"{counted} counted (want {4 * L}), {old} of qgemv_partial_kernel "
          f"(want 0); attempts {attempts}")
    check(attn == L and attn_counted == L and not any(never.values()),
          f"{what}: {attn} launches of {BATCHED_ATTN} in the trace and "
          f"{attn_counted} counted (want one a layer, {L}), of the kernels "
          f"it replaced {never} (want none); attempts {attempts}")
    print(json.dumps({"gemv_route": what, "attempts": attempts}), flush=True)
    return names


# the B=1 step's chain (csrc/decode_step.cu), and the kernels it must
# never launch: the chain it replaced, and the absmax kernel (its int8
# mode takes the absmax in the attention CTA)
B1_CHAIN = ("qgemv_b1_kernel", "attn_paged_kernel")
B1_NEVER = ("qgemv_partial_kernel", "partial_sum_kernel", "attn_split_kernel",
            "attn_combine_kernel", "row_absmax_kernel", BATCHED_ATTN)
# the B=1 step's launches beside its chain, whatever its depth: the fill
# of a host position and the copy of x0 (``decode_kernels._decode_step_b1``)
B1_WRAPPER_LAUNCHES = 2


def b1_trace(run, L: int, what: str) -> dict:
    """One B=1 step of ``run`` under ``torch.profiler``: 5 launches a layer
    of its own chain, bf16 or int8 -- 4 L of the M=1 GEMV
    (``qgemv_b1_kernel``, also by the step's own count ``decode_gemv_b1``)
    and L of the attention CTA -- none of the old chain's kernels nor the
    absmax kernel, and outside the chain and the trace's opening spins at
    most the wrapper's ``B1_WRAPPER_LAUNCHES`` (its position fill and x0
    copy), at any depth. A trace
    short of the chain's records (the tracer loses records on some hosts,
    :func:`kernel_trace`) is taken again, up to five times; the step's
    own count of GEMV launches stands beside every attempt -> the record
    printed (launches and device ms of each kernel)."""
    want = {"qgemv_b1_kernel": 4 * L, "attn_paged_kernel": L}
    attempts = []
    for _ in range(5):
        launches = {}
        names = kernel_trace(run, counted=launches)
        counted = launches["decode_gemv_b1"]
        chain = {k: launches_of(names, k) for k in B1_CHAIN}
        never = {k: launches_of(names, k) for k in B1_NEVER}
        others = sum(v[0] for v in names.values()) - sum(chain.values())
        wrapper = others - launches_of(names, "spin_kernel")
        attempts.append({"launches": chain, "counted": counted,
                         "never": never, "outside_chain": others,
                         "wrapper": wrapper})
        if chain == want:
            break
    per_layer = sum(chain.values()) / L
    check(chain == want and counted == 4 * L and sum(never.values()) == 0
          and wrapper <= B1_WRAPPER_LAUNCHES and per_layer <= 5,
          f"{what}: B=1 chain launches {chain} (want {want}), {counted} "
          f"GEMVs counted, {never} of the kernels it must not launch, "
          f"{others} outside the chain ({wrapper} besides the trace's "
          f"spins, want <= {B1_WRAPPER_LAUNCHES}); attempts {attempts}")
    rec = {"b1_trace": what, "launches_per_layer": per_layer,
           "launches": chain, "outside_chain": others, "attempts": attempts,
           "span_ms": {k: span_ms(names, k) for k in B1_CHAIN},
           "kernels": {k: v for k, v in names.items()}}
    print(json.dumps(rec), flush=True)
    return rec


def tp_trace(run, n_mma: int, what: str) -> None:
    """One call of a TP half under ``torch.profiler``: its ``n_mma``
    projections all on the tensor-core GEMV (``qgemv_mma_kernel``), the
    scalar-FMA ``qgemv_partial_kernel`` and ``partial_sum_kernel`` never. A
    trace short of GEMV records is taken again, up to five times."""
    attempts = []
    for _ in range(5):
        names = kernel_trace(run)
        mma = launches_of(names, "qgemv_mma_kernel")
        old = (launches_of(names, "qgemv_partial_kernel")
               + launches_of(names, "partial_sum_kernel"))
        attempts.append({"qgemv_mma_kernel": mma, "old": old})
        if mma >= n_mma or old:
            break
    check(mma == n_mma and old == 0,
          f"{what}: {mma} tensor-core GEMV launches (want {n_mma}), {old} "
          f"of the scalar GEMV; attempts {attempts}")
    print(json.dumps({"tp_trace": what, "attempts": attempts}), flush=True)


# the refill kernel's chain a layer, in launch order (csrc/prefill.cu), the
# name each role's kernel has, and the kernels it must never launch: the
# scalar-dequant GEMM and scalar-FMA attention it replaced
PREFILL_ROLES = ("ln0", "qkv", "attention", "o", "ln1", "fc1", "fc2")
PREFILL_KERNELS = {"ln0": "ln_rows_kernel", "qkv": "prefill_gemm_kernel",
                   "attention": "causal_attn_kernel",
                   "o": "prefill_gemm_kernel", "ln1": "ln_rows_kernel",
                   "fc1": "prefill_gemm_kernel", "fc2": "prefill_gemm_kernel"}
PREFILL_NEVER = ("qgemm_kernel", "prefill_attn_kernel")


def prefill_trace(run, L: int, what: str) -> dict:
    """One ``prefill_fused`` call of ``run`` under ``torch.profiler``: its
    chain's records in launch order, each given its role in the layer
    (``PREFILL_ROLES``; the chain's kernels are those whose names hold
    "ln_rows", "gemm" or "attn") -> the record printed: per role its
    launches and device ms summed over the layers, their share of the
    roles' sum, and the chain's span on the card (first start to last
    end; programmatic launches overlap, so the roles' sum may exceed it).
    The kernels wait inside for the one before (programmatic launch), so a
    role's span holds that wait; its marginal ms (from the later of its
    start and the previous kernel's end to its end) is what it adds to the
    chain, and the marginals sum to the span less the gaps. Checks 7 L
    records, every role on its kernel of ``PREFILL_KERNELS`` and none of
    ``PREFILL_NEVER``. A trace short of records (:func:`kernel_trace`) is
    taken again, up to three times."""
    attempts = []
    for _ in range(3):
        seq = []
        names = kernel_trace(run, seq)
        chain = [r for r in seq
                 if any(k in r[0] for k in ("ln_rows", "gemm", "attn"))]
        attempts.append(len(chain))
        if len(chain) == 7 * L:
            break
    roles = {r: [0, 0.0, 0.0] for r in PREFILL_ROLES}
    misplaced, prev_end = 0, None
    for i, (name, start, ms) in enumerate(chain):
        role = PREFILL_ROLES[i % 7]
        end = start / 1e3 + ms
        roles[role][0] += 1
        roles[role][1] += ms
        # what it adds to the chain: from the later of its start and the
        # previous kernel's end to its own end
        roles[role][2] += max(0.0, end - max(start / 1e3, prev_end)) \
            if prev_end is not None else ms
        prev_end = end if prev_end is None else max(prev_end, end)
        misplaced += PREFILL_KERNELS[role] not in name
    total = sum(v[1] for v in roles.values())
    span = ((chain[-1][1] - chain[0][1]) / 1e3 + chain[-1][2]) if chain else 0.0
    never = {k: launches_of(names, k) for k in PREFILL_NEVER}
    check(len(chain) == 7 * L and misplaced == 0
          and sum(never.values()) == 0,
          f"{what}: {len(chain)} chain records (want {7 * L}), "
          f"{misplaced} not on their role's kernel, {never} of the "
          f"replaced kernels; attempts {attempts}")
    rec = {"prefill_trace": what, "records": len(chain), "attempts": attempts,
           "span_ms": span, "roles_ms": {k: v[1] for k, v in roles.items()},
           "roles_marginal_ms": {k: v[2] for k, v in roles.items()},
           "roles_share": {k: v[1] / max(total, 1e-30)
                           for k, v in roles.items()},
           "roles_launches": {k: v[0] for k, v in roles.items()},
           "never": never, "kernels": names}
    print(json.dumps(rec), flush=True)
    return rec


# the lm_head tails (csrc/lm_head_argmax.cu): at M = 16, 32 the LayerNorm'd
# rows and the tensor-core GEMV, at M <= 8 the streaming GEMV with the
# LayerNorm in its blocks; and the scalar-FMA kernels they replaced
TAIL_KERNELS = ("ln_rows_kernel", "lm_head_mma_kernel")
SMALL_TAIL_KERNELS = ("qgemv_stream_kernel",)
TAIL_NEVER = ("lm_head_block_kernel", "lm_head_logits_gmax_kernel",
              "qgemv_partial_kernel", "partial_sum_kernel")
# the 9-32-row GEMV (csrc/qgemv_stream.cuh) and the two kernels of the
# scalar-FMA GEMV it replaced
WIDE_KERNEL = "qgemv_stream_kernel"
WIDE_NEVER = ("qgemv_partial_kernel", "partial_sum_kernel")


def tail_trace(run, what: str, small: bool = False) -> dict:
    """One call of an lm_head tail under ``torch.profiler`` -> the record
    printed (launches and device ms of each kernel). Checks one launch
    each of ``TAIL_KERNELS`` (``small``, M <= 8: ``SMALL_TAIL_KERNELS``)
    and none of ``TAIL_NEVER``. A trace short of records is taken again,
    up to three times."""
    kernels = SMALL_TAIL_KERNELS if small else TAIL_KERNELS
    attempts = []
    for _ in range(3):
        names = kernel_trace(run)
        got = {k: launches_of(names, k) for k in kernels}
        never = {k: launches_of(names, k) for k in TAIL_NEVER}
        attempts.append({"launches": got, "never": never})
        if all(v == 1 for v in got.values()):
            break
    check(all(v == 1 for v in got.values()) and sum(never.values()) == 0,
          f"{what}: tail launches {got} (want one each), {never} of the "
          f"replaced kernels; attempts {attempts}")
    rec = {"tail_trace": what, "attempts": attempts, "kernels": names}
    print(json.dumps(rec), flush=True)
    return rec


def wide_trace(run, what: str) -> dict:
    """One call of ``run`` (one ``qmatmul_wide``, alone or in a tail) under
    ``torch.profiler``: one launch of the streaming GEMV, none of the
    scalar-FMA GEMV's two kernels -> {kernel name: [launches, device
    ms]}. A trace short of records is taken again, up to three times."""
    attempts = []
    for _ in range(3):
        names = kernel_trace(run)
        got = launches_of(names, WIDE_KERNEL)
        never = {k: launches_of(names, k) for k in WIDE_NEVER}
        attempts.append({"launches": got, "never": never})
        if got == 1:
            break
    check(got == 1 and sum(never.values()) == 0,
          f"{what}: {got} launches of {WIDE_KERNEL} (want 1), {never} of "
          f"the replaced kernels; attempts {attempts}")
    print(json.dumps({"wide_trace": what, "attempts": attempts,
                      "kernels": names}), flush=True)
    return names


def hold_wide(c: "Ctx", qt, m: int, what: str) -> tuple:
    """``qmatmul_wide`` at m rows on random inputs against its plain
    version: f32 summation order only, 1e-5 of the output's magnitude ->
    (x, max error, tolerance)."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import (qmatmul_wide,
                                                      qmatmul_wide_plain)

    x = c.randn(m, qt.d_in)
    y = qmatmul_wide(x, qt)
    ref = qmatmul_wide_plain(x, qt)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item() + 1e-5
    check(err <= tol and bool(torch.isfinite(y).all())
          and tuple(y.shape) == (m, qt.d_out),
          f"{what}: err {err} > {tol} (shape {tuple(y.shape)})")
    return x, err, tol


def kernel_ln(x, lnw, lnb, eps):
    """The lm_head kernels' own LayerNorm of the rows x (bf16-valued f32),
    read back through the logits kernel with an identity Q4_1 weight
    (levels 0 and 1, scale 1, min 0): each logit is then exactly one LN
    element, in the X' numerics (M <= 8) and the dequant-then-dot ones."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import lm_head_logits_gmax_commit
    from biogpt_tpu_torch.quant import codecs
    from biogpt_tpu_torch.quant.layouts import QuantizedTensor

    M, D = x.shape
    dev, bf16 = x.device, torch.bfloat16
    eye = torch.eye(D, dtype=torch.uint8, device=dev)
    qt = QuantizedTensor(   # split-half packing: byte row i = rows i, i + D/2
        levels=(eye[:D // 2] | (eye[D // 2:] << 4)).contiguous(),
        scales=torch.ones(D // 32, D, dtype=bf16, device=dev),
        mins=torch.zeros(D // 32, D, dtype=bf16, device=dev),
        qtype=codecs.GGML_TYPE_Q4_1, packed=True)
    kc = torch.zeros(1, M, 8, 8, dtype=bf16, device=dev)
    rows = torch.zeros(M, 1, 8, dtype=bf16, device=dev)
    past = torch.zeros(M, dtype=torch.int32, device=dev)
    xn, _, _, _ = lm_head_logits_gmax_commit(x, lnw, lnb, qt, D, kc, kc.clone(),
                                             rows, rows, past, eps)
    return xn


def lm_head_expect(x, lnw, lnb, qt, eps, what: str) -> dict:
    """What the lm_head tails' outputs are held to.

    ``plain``: the plain version's logits (M, d_out), ``lm_head_logits_plain``
    on the same inputs. ``tol``: f32 summation order, 1e-5 of their
    magnitude. The two LayerNorms sum in different orders (and the kernel's
    compiler may fuse a multiply-add), so an element whose f32 value lies
    next to a bf16 rounding boundary can round the other way: one bf16 ulp,
    which moves a logit by up to ~1e-3 of its magnitude (seen on the H100
    at M=32). Such a flip is checked on its own: the two values must be
    bf16 neighbours, and the plain f32 value within 2^-17 of its row's
    largest magnitude of the boundary between them. ``row_tol`` (M,) is
    ``tol`` plus, for each flipped element of the row, its ulp times its
    weight row's largest magnitude: every row is held to the plain version
    within it. The rows with a flip (``flipped``) are held besides, at
    ``tol``, to ``ref``: logits computed from the kernel's own LayerNorm."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import (lm_head_logits_plain,
                                                      wide_weight, xprime_logits)

    plain = lm_head_logits_plain(x, lnw, lnb, qt, eps)
    tol = 1e-5 * plain.abs().max().item() + 1e-5
    xk = kernel_ln(x, lnw, lnb, eps)
    xf = x.to(torch.float32)
    xc = xf - xf.mean(-1, keepdim=True)
    y = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
         * lnw.to(torch.float32) + lnb.to(torch.float32))
    yb = y.to(torch.bfloat16)
    flips = xk.to(torch.bfloat16) != yb
    if bool(flips.any()):
        apart = (xk.to(torch.bfloat16).view(torch.int16).int()
                 - yb.view(torch.int16).int()).abs()
        edge = (y - (xk + yb.float()) / 2).abs()
        window = 2 ** -17 * y.abs().amax(-1, keepdim=True).expand_as(y)
        check(bool((apart[flips] == 1).all()
                   and (edge[flips] <= window[flips]).all()),
              f"{what}: LayerNorm differs beyond a bf16 rounding flip")
    w = wide_weight(qt)
    # X' (M <= 8) leaves the scale products unrounded: allow 2^-7 over the
    # bf16-rounded weights' magnitude
    ulp = torch.where(flips, (xk - yb.float()).abs(), torch.zeros_like(xk))
    row_tol = tol + ulp @ (w.abs().amax(-1) * (1 + 2 ** -7))
    ref = xprime_logits(xk, qt) if x.shape[0] <= 8 else xk @ w
    return {"plain": plain, "tol": tol, "row_tol": row_tol,
            "flipped": flips.any(-1), "ref": ref, "flips": int(flips.sum())}


def ids_within(ids, mv, logits, tol, n_valid: int, what: str) -> tuple:
    """Check a tail's ids and max logits against the argmax fold of
    ``logits`` (M, d_out): max logits within ``tol`` (a float or (M,)),
    ids equal on the rows whose top-2 gap exceeds twice it -> (max error,
    decided rows)."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import argmax_fold, pick_tile

    tol = torch.as_tensor(tol, dtype=torch.float32, device=logits.device)
    tol = tol.expand(logits.shape[0])
    pids, pmv = argmax_fold(logits, n_valid, pick_tile(logits.shape[1]))
    top2 = torch.topk(logits[:, :n_valid], 2).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    err = (mv - pmv).abs()
    check(bool((ids == pids)[decided].all()) and bool((err <= tol).all()),
          f"{what}: ids {ids.tolist()} vs {pids.tolist()} on decided rows "
          f"{decided.tolist()}, max err {err.max().item()} (tol {tol.tolist()})")
    return err.max().item(), int(decided.sum())


def tail_ids_within(ids, mv, exp: dict, n_valid: int, what: str) -> tuple:
    """A tail's ids and max logits against the plain version within each
    row's tolerance and, on rows with an LN flip, against the kernel-LN
    reference within ``tol`` (see :func:`lm_head_expect`)."""
    out = ids_within(ids, mv, exp["plain"], exp["row_tol"], n_valid, what)
    f = exp["flipped"]
    if bool(f.any()):
        ids_within(ids[f], mv[f], exp["ref"][f], exp["tol"], n_valid,
                   what + " (kernel-LN reference, flipped rows)")
    return out


class Ctx:
    """What the phases share: the card, a seeded generator, the 347M shapes
    and the records of the ``kernels`` line."""

    def __init__(self):
        from biogpt_tpu_torch.config import BioGptConfig

        self.dev = torch.device("cuda")
        self.cfg = BioGptConfig()
        self.V_PAD = -(-self.cfg.n_vocab // 128) * 128
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(1234)
        self.results = {}        # kernel -> its timed Q4_0 record
        self.fmt_results = {}    # (kernel, format) -> the timed record
        self.formats = {}        # kernel -> formats held on the card
        self.launches = {}
        self.lockstep_ids = {}   # the uniform lockstep serves' ids, per cache

    def randn(self, *shape):
        return torch.randn(*shape, generator=self.gen, device=self.dev)

    def rand_qt(self, d_in, d_out, lead=(), mins=False, fmt=None):
        """Random planes of a (d_in, d_out) weight as the engines prepare
        them: ``fmt`` "q4_0", "q4_1", "q5_0", "q5_1" (packed nibbles, and
        for Q5 a fifth-bit plane; random bytes are valid levels) or "q8_0"
        (int8 levels -128..127); by default Q4_1 with ``mins``, else Q4_0.
        The scales shrink with the level range (8, 16 or 128 levels each
        side), so every format's weights have the same magnitude."""
        from biogpt_tpu_torch.quant.layouts import QuantizedTensor

        fmt = fmt or ("q4_1" if mins else "q4_0")
        qtype, bits = FORMATS[fmt]
        mins = fmt.endswith("_1")
        if bits == 8:
            lv = torch.randint(-128, 128, lead + (d_in, d_out),
                               generator=self.gen, device=self.dev,
                               dtype=torch.int32).to(torch.int8)
        else:
            rows = d_in // 2 + (d_in // 8 if bits == 5 else 0)
            lv = torch.randint(0, 256, lead + (rows, d_out),
                               generator=self.gen, device=self.dev,
                               dtype=torch.int32).to(torch.uint8)
        sshape = lead + (d_in // 32, d_out)
        shrink = {4: 1.0, 5: 0.5, 8: 1 / 16}[bits]
        sc = (torch.rand(sshape, generator=self.gen, device=self.dev) * 0.015
              + 0.005) * shrink
        mn = (-(torch.rand(sshape, generator=self.gen, device=self.dev) * 0.15
                + 0.05)).to(torch.bfloat16) if mins else None
        return QuantizedTensor(levels=lv, scales=sc.to(torch.bfloat16),
                               mins=mn, qtype=qtype, packed=bits != 8)

    def rand_layers(self, mins=False, n_layer=None):
        """Layer-stacked random planes of 347M's widths, ``n_layer`` deep
        (by default 347M's 24) -> (layers, their bytes)."""
        c = self.cfg
        D, F, L = c.d_model, c.d_ff, n_layer or c.n_layer
        layers = {n: {"w": 1 + 0.1 * self.randn(L, D), "b": 0.1 * self.randn(L, D)}
                  for n in ("ln0", "ln1")}
        for name, d_in, d_out in (("qkv", D, 3 * D), ("o", D, D),
                                  ("fc1", D, F), ("fc2", F, D)):
            layers[name] = {"w": self.rand_qt(d_in, d_out, (L,), mins),
                            "b": 0.02 * self.randn(L, d_out)}
        return layers, layers_bytes(layers)

    def emit(self, rec: dict) -> None:
        """Print a kernel record and note the format it held on the card."""
        if "format" in rec:
            self.formats.setdefault(rec["kernel"], set()).add(rec["format"])
        print(json.dumps(rec), flush=True)


def qbytes(qt):
    return sum(t.numel() * t.element_size()
               for t in (qt.levels, qt.scales, qt.mins) if t is not None)


PROJECTIONS = ("qkv", "o", "fc1", "fc2")


def layers_bytes(layers) -> int:
    """Bytes of the layer planes, biases and LayerNorm parameters."""
    L, D = layers["ln0"]["w"].shape
    return sum(qbytes(layers[n]["w"]) + layers[n]["b"].numel() * 4
               for n in PROJECTIONS) + 4 * L * D * 4


def with_weights(layers, fn) -> dict:
    """``layers`` with ``fn`` applied to each projection's planes."""
    out = dict(layers)
    for n in PROJECTIONS:
        out[n] = {"w": fn(layers[n]["w"]), "b": layers[n]["b"]}
    return out


def in_format(fmt: str, lv, scales, mins):
    """Centered int8 levels (..., d_in, d_out) with their scale (and min)
    planes as ``fmt`` planes the kernels take: packed (split-half nibbles,
    and for Q5 the fifth-bit plane) or, for Q8_0, unpacked; bf16 scales."""
    from biogpt_tpu_torch.quant.layouts import (QuantizedTensor,
                                                pack_nibble_planes)

    qtype, bits = FORMATS[fmt]
    out = QuantizedTensor(
        levels=lv, scales=scales.to(torch.bfloat16),
        mins=None if mins is None else mins.to(torch.bfloat16), qtype=qtype)
    if bits == 8:
        return out
    dev = lv.device
    return pack_nibble_planes(out.map(lambda a: a.cpu())).map(
        lambda a: a.to(dev))


def reencode(qt, fmt: str):
    """The Q4 planes ``qt``'s own levels, scales and mins written in
    ``fmt`` (Q5_0 and Q8_0 from Q4_0, Q5_1 from Q4_1): the same weights
    exactly, so a dequant-then-dot kernel gives bit-equal results."""
    from biogpt_tpu_torch.quant.layouts import unpack_levels

    return in_format(fmt, unpack_levels(qt.levels, qt.qtype), qt.scales,
                     qt.mins)


def requantize(qt, fmt: str):
    """The weights of the Q4 planes ``qt`` re-quantized to ``fmt`` by the
    reference codec's rules (``codecs.quantize_blocks``: Q8_0 round(w /
    (amax/127)); Q5_0 from the block's signed largest value / -16; Q5_1
    over [min, max] in 31 steps; fp16 scales), on the card: the Q4 rows'
    model, its levels now spanning the format's whole range."""
    from biogpt_tpu_torch.quant.layouts import unpack_levels

    w = unpack_levels(qt.levels, qt.qtype).float() * qt.scales.float(
        ).repeat_interleave(32, dim=-2)
    if qt.mins is not None:
        w = w + qt.mins.float().repeat_interleave(32, dim=-2)
    *lead, d_in, d_out = w.shape
    b = w.reshape(*lead, d_in // 32, 32, d_out)

    def inv(d):
        inverse = torch.where(d != 0, 1 / torch.where(d != 0, d, 1), 0)
        return inverse[..., None, :]
    mins = None
    if fmt == "q8_0":
        d = b.abs().amax(-2) / 127
        x = b * inv(d)
        lv = torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))
    elif fmt == "q5_0":
        d = b.gather(-2, b.abs().argmax(-2, keepdim=True)).squeeze(-2) / -16
        lv = torch.floor(b * inv(d) + 16.5).clamp(0, 31) - 16
    else:
        mins, mx = b.amin(-2), b.amax(-2)
        d = (mx - mins) / 31
        lv = torch.floor((b - mins[..., None, :]) * inv(d) + 0.5).clamp(0, 31)
        mins = mins.half()
    return in_format(fmt, lv.to(torch.int8).reshape(w.shape), d.half(), mins)


# ------------------------------------------------- 2. single-stream kernels

def phase_single_kernels(c: Ctx) -> None:
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.decode_kernels import (decode_step_fused,
                                                     decode_step_fused_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        argmax_fold, lm_head_argmax, lm_head_argmax_plain, pick_tile, qmatmul,
        qmatmul_plain, qmatmul_wide, qmatmul_wide_plain)
    from biogpt_tpu_torch.quant.layouts import QuantizedTensor
    from biogpt_tpu_torch.runtime.engine import _bucket
    from biogpt_tpu_torch.tools.kernel_bounds import bf16_step_cost

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, F, L, H = cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.n_head
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    shapes = [("qkv", D, 3 * D), ("o", D, D), ("fc1", D, F), ("fc2", F, D),
              ("lm_head", D, V_PAD)]
    for name, d_in, d_out in shapes:
        for mins in (False, True):
            qt = c.rand_qt(d_in, d_out, mins=mins)
            fmt = "q4_1" if mins else "q4_0"
            for m, kern, plain, kname in (
                    (1, qmatmul, qmatmul_plain, "qmatmul"),
                    (8, qmatmul, qmatmul_plain, "qmatmul"),
                    *((m, qmatmul_wide, qmatmul_wide_plain, "qmatmul_wide")
                      for m in WIDE_ROWS)):
                what = f"{kname} {name} m={m} {fmt}"
                if kname == "qmatmul_wide":
                    x, err, tol = hold_wide(c, qt, m, what)
                else:
                    x = c.randn(m, d_in)
                    y = kern(x, qt)
                    ref = plain(x, qt)
                    torch.cuda.synchronize()
                    err = (y - ref).abs().max().item()
                    # f32 summation order only: 1e-5 of the output's
                    # magnitude
                    tol = 1e-5 * ref.abs().max().item() + 1e-5
                    check(err <= tol and bool(torch.isfinite(y).all()),
                          f"{what}: err {err} > {tol}")
                c.formats.setdefault(kname, set()).add(fmt)
                # timed: Q4_0 at M = 1, 8, 16, 32, the lm_head at M = 32
                # in Q4_1 too
                if (m not in (1, 8, 16, 32)
                        or mins and (name, m) != ("lm_head", 32)):
                    continue
                rec = {"kernel": kname, "shape": name, "m": m, "format": fmt,
                       "max_abs_err": err, "tol": tol}

                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(
                        qt, torch.bfloat16)
                timed(rec, lambda: kern(x, qt), lambda: plain(x, qt),
                      lib_call, qbytes(qt) + x.numel() * 4 + m * d_out * 4,
                      2 * m * d_in * d_out, reps=50, plain_reps=5,
                      flush=flush)
                if kname == "qmatmul_wide" and not mins:
                    rec["trace"] = wide_trace(lambda: kern(x, qt), what)
                key = (kname, name, m)
                if not mins and key in (("qmatmul", "lm_head", 1),
                                        ("qmatmul_wide", "fc1", 32)):
                    c.results[kname] = rec
                c.emit(rec)

    # decode_step_fused over 24 layers at three cache lengths; the short
    # and the long context timed and traced (Q4_0; Q4_1 the short one),
    # the position also given as a (1,) tensor on the card
    for mins in (False, True):
        layers, wbytes = c.rand_layers(mins)
        S = cfg.n_positions
        kc = c.randn(L, 1, S, D).to(torch.bfloat16)
        vc = c.randn(L, 1, S, D).to(torch.bfloat16)
        for past in (1, 100, 900):
            window = min(_bucket(past + 1, 128), S)
            x0 = c.randn(1, D)
            run = lambda: decode_step_fused(x0, layers, kc, vc, past, n_head=H,
                                            window=window, ln_eps=cfg.ln_eps)
            plain = lambda: decode_step_fused_plain(
                x0, layers, kc, vc, past, n_head=H, window=window,
                ln_eps=cfg.ln_eps)
            fmt = "q4_1" if mins else "q4_0"
            what = f"decode_step_fused past={past} {fmt}"
            rec = {"kernel": "decode_step_fused", "layers": L, "past": past,
                   "window": window, "format": fmt}
            got = held_step(run, plain, what, rec)
            on_card = decode_step_fused(
                x0, layers, kc, vc,
                torch.tensor([past], dtype=torch.int32, device=dev),
                n_head=H, window=window, ln_eps=cfg.ln_eps)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(a, b)) for a, b in zip(got, on_card)),
                  f"{what}: the position as a (1,) tensor on the card gives "
                  "other results than the host's int")
            if past > 1 and (not mins or past == 100):
                timed(rec, run, plain, None,
                      *bf16_step_cost(cfg, [past], window, wbytes))
                rec["trace"] = b1_trace(run, L, what)["span_ms"]
                if past == 100 and not mins:
                    c.results["decode_step_fused"] = rec
            c.emit(rec)
        del layers, kc, vc

    # lm_head_argmax, m = 1, plus a forced tie and an all-NaN row
    for mins in (False, True):
        qt = c.rand_qt(D, V_PAD, mins=mins)
        lnw = 1 + 0.1 * c.randn(D)
        lnb = 0.1 * c.randn(D)
        x = c.randn(1, D)
        fmt = "q4_1" if mins else "q4_0"
        ids, mv = lm_head_argmax(x, lnw, lnb, qt, cfg.n_vocab, cfg.ln_eps)
        what = f"lm_head_argmax {fmt}"
        exp = lm_head_expect(x, lnw, lnb, qt, cfg.ln_eps, what)
        torch.cuda.synchronize()
        err, decided = tail_ids_within(ids, mv, exp, cfg.n_vocab, what)
        rec = {"kernel": "lm_head_argmax", "m": 1, "format": fmt,
               "max_abs_err": err, "tol": exp["tol"],
               "row_tol": exp["row_tol"].tolist(), "ids_decided": decided,
               "ln_flips": exp["flips"]}
        if not mins:
            # forced tie: duplicate the winning column into a lower one
            win = int(argmax_fold(exp["plain"], cfg.n_vocab,
                                  pick_tile(V_PAD))[0][0])
            low = 5 if win > 5 else win + 1
            tied = QuantizedTensor(levels=qt.levels.clone(),
                                   scales=qt.scales.clone(), mins=None,
                                   qtype=qt.qtype, packed=True)
            tied.levels[:, low] = tied.levels[:, win]
            tied.scales[:, low] = tied.scales[:, win]
            tid, _ = lm_head_argmax(x, lnw, lnb, tied, cfg.n_vocab, cfg.ln_eps)
            check(int(tid[0]) == min(low, win),
                  f"lm_head_argmax tie: {int(tid[0])} != {min(low, win)}")
            nid, nmv = lm_head_argmax(torch.full_like(x, float("nan")), lnw,
                                      lnb, qt, cfg.n_vocab, cfg.ln_eps)
            check(int(nid[0]) == cfg.n_vocab - 1 and bool(torch.isnan(nmv[0])),
                  f"lm_head_argmax NaN row: {int(nid[0])}, {float(nmv[0])}")

            def lib_call():
                xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb,
                                                    cfg.ln_eps)
                logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
                return torch.argmax(logits[:, :cfg.n_vocab], dim=-1)
            timed(rec, lambda: lm_head_argmax(x, lnw, lnb, qt, cfg.n_vocab,
                                              cfg.ln_eps),
                  lambda: lm_head_argmax_plain(x, lnw, lnb, qt, cfg.n_vocab,
                                               cfg.ln_eps),
                  lib_call, qbytes(qt) + D * 4 + 2 * D * 4 + 8, 2 * D * V_PAD,
                  reps=50, plain_reps=5, flush=flush)
            # the CLI's greedy tail: the streaming GEMV and the fold only
            rec["trace"] = tail_trace(
                lambda: lm_head_argmax(x, lnw, lnb, qt, cfg.n_vocab,
                                       cfg.ln_eps),
                f"lm_head_argmax M=1 {fmt}", small=True)["kernels"]
            c.results["lm_head_argmax"] = rec
        c.emit(rec)
        hold_small_tails(c, qt, lnw, lnb, fmt, flush if not mins else None)
    del flush_buf


def qmm_route_kernel(qt, m: int) -> str:
    """The kernel ``qmatmul``'s route launches for m rows of ``qt``
    (``qmatmul_kernels.qmm_plan``: warps 0 is the streaming GEMV's M <= 8
    path)."""
    from biogpt_tpu_torch.ops import qmatmul_kernels as qk

    plan = qk.qmm_plan(m, qt.d_in, qt.d_out,
                       torch.cuda.get_device_properties(0).multi_processor_count)
    return "qgemv_stream_kernel" if plan[2] == 0 else "qmatmul_kernel"


def qmm_trace(run, what: str, kernel: str) -> dict:
    """One ``qmatmul`` call traced: one launch of its route's kernel
    (``qmatmul_kernel`` or ``qgemv_stream_kernel``) in the trace and by the
    wrapper's count (``qmatmul``), none of the two-launch scalar GEMV it
    replaced -> {kernel: [launches, device ms]} without the trace's spins.
    A trace that lost the kernel's record (the tracer dropped it once in
    480 such traces on the H100, the wrapper having counted its launch) is
    taken again, up to three times. Every attempt's counts go into the
    failure."""
    attempts = []
    for _ in range(3):
        launches = {}
        names = kernel_trace(run, counted=launches)
        n = launches_of(names, kernel)
        old = sum(launches_of(names, k) for k in WIDE_NEVER)
        counted = launches.get("qmatmul", 0)
        attempts.append({kernel: n, "counted": counted, "old": old,
                         "spins": launches_of(names, "spin_kernel")})
        if n == 1 or old or counted != 1:
            break
    check(n == 1 and counted == 1 and old == 0,
          f"{what}: {n} launches of {kernel} in the trace and {counted} "
          f"counted (want 1 each), {old} of {WIDE_NEVER}; attempts {attempts}")
    return {k: v for k, v in names.items() if "spin_kernel" not in k}


def phase_qmatmul_kernels(c: Ctx) -> None:
    """Row 1, ``qmatmul`` (``csrc/qmatmul.cu``, one launch a call), held at
    every M from 1 to 8 in every format on the five 347M shapes, the TP
    ranks' local lm_head widths (42,496 / 2 and / 4), a 4096 -> 4096 plane
    and widths whose Q5 fifth-bit plane ends inside a stage's rows (d_in
    640 and 1600, on both routes: 640 -> 2560 streams, 640 -> 10,624,
    1600 -> 6400 and 1600 -> 42,496 take qmatmul's kernel), each call
    within 1e-5 of the output's magnitude (f32 summation order only) and
    traced to one launch of its route's kernel (:func:`qmm_trace`);
    timed in Q4_0 at M = 1 and 8 on each of the five shapes beside its
    bound, its plain version and ``x_bf16 @ dequantize(W)`` (L2 flushed
    before each call)."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.qmatmul_kernels import qmatmul, qmatmul_plain

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, F = cfg.d_model, cfg.d_ff
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    shapes = (("qkv", D, 3 * D), ("o", D, D), ("fc1", D, F), ("fc2", F, D),
              ("lm_head", D, V_PAD), ("lm_head/2", D, V_PAD // 2),
              ("lm_head/4", D, V_PAD // 4), ("4096x4096", F, F),
              ("640x2560", 640, 2560), ("640x10624", 640, V_PAD // 4),
              ("1600x6400", 1600, 6400), ("1600x42496", 1600, V_PAD))
    for fmt in FORMATS:
        for name, d_in, d_out in shapes:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            worst, traces = 0.0, {}
            for m in QMM_ROWS:
                x = c.randn(m, d_in)
                what = f"qmatmul {name} m={m} {fmt}"
                y, ref = qmatmul(x, qt), qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = 1e-5 * ref.abs().max().item() + 1e-5
                check(err <= tol and bool(torch.isfinite(y).all()),
                      f"{what}: err {err} > {tol}")
                worst = max(worst, err / tol)
                traces[m] = qmm_trace(lambda: qmatmul(x, qt), what,
                                      qmm_route_kernel(qt, m))
                if fmt != "q4_0" or m not in (1, 8) or name not in (
                        "qkv", "o", "fc1", "fc2", "lm_head"):
                    continue
                rec = {"kernel": "qmatmul", "sub_row": "shape", "shape": name,
                       "m": m, "format": fmt, "max_abs_err": err, "tol": tol,
                       "route": qmm_route_kernel(qt, m), "trace": traces[m]}

                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(qt,
                                                             torch.bfloat16)
                timed(rec, lambda: qmatmul(x, qt), lambda: qmatmul_plain(x, qt),
                      lib_call, qbytes(qt) + m * d_in * 4 + m * d_out * 4,
                      2 * m * d_in * d_out, reps=50, plain_reps=3, flush=flush)
                c.emit(rec)
            c.formats.setdefault("qmatmul", set()).add(fmt)
            print(json.dumps({"qmatmul_hold": name, "d_in": d_in,
                              "d_out": d_out, "format": fmt,
                              "rows": list(QMM_ROWS),
                              "worst_err_over_tol": worst,
                              "kernels": sorted({k for t in traces.values()
                                                 for k in t})}), flush=True)
            del qt
    del flush_buf


# ------------------------------------------------ 3. batched serving kernels

def ragged_past(B: int, dead=(), beyond=()) -> list:
    """Per-slot positions 1 + 13 b, dead slots at 0, and slots past the
    window of 512 at 600."""
    past = [1 + 13 * b for b in range(B)]
    for b in dead:
        past[b] = 0
    for b in beyond:
        past[b] = 600
    return past


def phase_serving_kernels(c: Ctx) -> None:
    from biogpt_tpu_torch.ops.decode_kernels import (
        decode_step_fused, decode_step_fused_batched_plain, kv_commit,
        kv_commit_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import bf16_step_cost

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, L, H, V = cfg.d_model, cfg.n_layer, cfg.n_head, cfg.n_vocab
    W = 512

    # batched decode step: B=8 with a slot past the window, B=32
    for mins in (False, True):
        layers, wbytes = c.rand_layers(mins)
        fmt = "q4_1" if mins else "q4_0"
        cases = ((8, ragged_past(8, dead=(2, 5), beyond=(7,))),
                 (32, ragged_past(32, dead=(7, 19))))
        for B, past in cases if not mins else cases[1:]:
            S = c.cfg.n_positions
            kc = c.randn(L, B, S, D).to(torch.bfloat16)
            vc = c.randn(L, B, S, D).to(torch.bfloat16)
            x0 = c.randn(B, D)
            pt = torch.tensor(past, dtype=torch.int32, device=dev)
            run = lambda: decode_step_fused(x0, layers, kc, vc, pt, n_head=H,
                                            window=W, ln_eps=cfg.ln_eps)
            plain = lambda: decode_step_fused_batched_plain(
                x0, layers, kc, vc, pt, n_head=H, window=W, ln_eps=cfg.ln_eps)
            x, kr, vr = run()
            xp, krp, vrp = plain()
            torch.cuda.synchronize()
            what = f"decode_step_fused B={B} {fmt}"
            err = hidden_within(x, xp, what)
            rows = max(rows_within(kr, krp, what + " k"),
                       rows_within(vr, vrp, what + " v"))
            if B == 32:
                names = gemv_trace(run, L, f"batched bf16 B=32 {fmt}")
                if not mins:   # where one B=32 step's device time goes
                    print(json.dumps({"step_breakdown": "batched bf16 B=32 "
                                      "q4_0", "kernels": names}), flush=True)
            rec = {"kernel": "decode_step_fused_batched", "layers": L, "B": B,
                   "past": past, "window": W, "format": fmt,
                   "max_abs_err": err, "tol": 3e-3 * xp.abs().max().item(),
                   "rows_err_over_tol": rows}
            if not mins:
                timed(rec, run, plain, None,
                      *bf16_step_cost(cfg, past, W, wbytes))
                if B == 32:
                    c.results["decode_step_fused_batched"] = rec
            c.emit(rec)
            del kc, vc
        del layers

    # KV commit at B=32: bit-equal
    B, S = 32, 512
    kc = c.randn(L, B, S, D).to(torch.bfloat16)
    vc = c.randn(L, B, S, D).to(torch.bfloat16)
    kr = c.randn(L, B, D).to(torch.bfloat16)
    vr = c.randn(L, B, D).to(torch.bfloat16)
    past = ragged_past(B, dead=(7, 19))
    pt = torch.tensor(past, dtype=torch.int32, device=dev)
    krt, vrt = kr.transpose(0, 1), vr.transpose(0, 1)
    k1, v1 = kv_commit(kc.clone(), vc.clone(), krt, vrt, pt)
    k2, v2 = kv_commit_plain(kc.clone(), vc.clone(), krt, vrt, pt)
    torch.cuda.synchronize()
    same = bool(torch.equal(k1, k2)) and bool(torch.equal(v1, v2))
    check(same, "kv_commit B=32: caches differ from the plain commit")
    slots = torch.arange(B, device=dev)
    pos = pt.long()

    def commit_lib():
        kc[:, slots, pos] = kr
        vc[:, slots, pos] = vr
    rec = {"kernel": "kv_commit", "B": B, "L": L, "past": past,
           "max_abs_err": 0.0 if same else float("nan"), "tol": 0.0}
    timed(rec, lambda: kv_commit(kc, vc, krt, vrt, pt),
          lambda: kv_commit_plain(kc, vc, krt, vrt, pt), commit_lib,
          4 * L * B * D * 2 + B * 4, 0, reps=50)
    c.results["kv_commit"] = rec
    c.emit(rec)
    # row 10 under the port's rule (PERF.md): a kernel slower than its
    # one-call yardstick, or over twice its bound, is redesigned; beside it
    # the window of an empty launch (a zero-cycle spin), which no kernel
    # timed this way undercuts
    floor = time_ms(lambda: torch.cuda._sleep(0), 50)
    print(json.dumps({"kv_commit_rule": {
        "kernel_ms": rec["kernel_ms"], "index_store_ms": rec["library_ms"],
        "bound_ms": rec["bound_ms"], "empty_launch_ms": floor,
        "no_slower_than_index_store": rec["kernel_ms"] <= rec["library_ms"],
        "within_twice_bound": rec["kernel_ms"] <= 2 * rec["bound_ms"]}}),
        flush=True)
    del kc, vc, k1, v1, k2, v2

    # the two tails with their commit, M = 8 and M = 32
    qt = c.rand_qt(D, V_PAD)
    lnw = 1 + 0.1 * c.randn(D)
    lnb = 0.1 * c.randn(D)
    for M in (8, 16, 32):
        recs = hold_tails(c, qt, lnw, lnb, M, "q4_0")
        if M == 32:
            c.results.update(recs)
    # and on Q4_1 planes (the <BITS=4, HAS_MIN> instantiations)
    hold_tails(c, c.rand_qt(D, V_PAD, mins=True), lnw, lnb, 32, "q4_1")


def hold_small_tails(c: Ctx, qt, lnw, lnb, fmt: str, flush=None) -> None:
    """The M <= 8 lm_head tails (the streaming GEMV, X' numerics) at each
    of ``SMALL_TAIL_ROWS``: ``lm_head_argmax`` and the sampled tail's
    logits and group maxima against the plain versions
    (:func:`lm_head_expect`); above one row a forced tie in row 0 (the
    kernel's winning column copied into a lower one: the lower index wins)
    and a NaN row M - 1 ((n_valid - 1, NaN), its logits NaN); with
    ``flush`` the greedy tail timed at M = 8 and traced."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        lm_head_argmax, lm_head_argmax_plain, lm_head_logits_gmax_commit)
    from biogpt_tpu_torch.quant.layouts import QuantizedTensor

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, V, eps = cfg.d_model, cfg.n_vocab, cfg.ln_eps
    bf16 = torch.bfloat16

    def sampled(x, w):
        M = x.shape[0]
        kc = torch.zeros(1, M, 8, 8, dtype=bf16, device=dev)
        rows = torch.zeros(M, 1, 8, dtype=bf16, device=dev)
        past = torch.zeros(M, dtype=torch.int32, device=dev)
        lo, gm, _, _ = lm_head_logits_gmax_commit(x, lnw, lnb, w, V, kc,
                                                  kc.clone(), rows, rows,
                                                  past, eps)
        return lo, gm
    for M in SMALL_TAIL_ROWS:
        x = c.randn(M, D)
        what = f"lm_head_argmax M={M} {fmt}"
        ids, mv = lm_head_argmax(x, lnw, lnb, qt, V, eps)
        exp = lm_head_expect(x, lnw, lnb, qt, eps, what)
        torch.cuda.synchronize()
        err, decided = tail_ids_within(ids, mv, exp, V, what)
        lo, gm = sampled(x, qt)
        rerr = (lo[:, :V] - exp["plain"][:, :V]).abs().amax(-1)
        own = lo.reshape(M, -1, 128).amax(-1)
        check(bool((rerr <= exp["row_tol"]).all()) and bool(torch.equal(gm, own))
              and bool((lo[:, V:] == -1e30).all()),
              f"lm_head_logits_gmax M={M} {fmt}: logits err {rerr.tolist()} "
              f"(tol {exp['row_tol'].tolist()}), gmax equal to its logits' "
              f"group maxima: {bool(torch.equal(gm, own))}")
        rec = {"kernel": "lm_head_argmax", "m": M, "format": fmt,
               "max_abs_err": err, "tol": exp["tol"], "ids_decided": decided,
               "ln_flips": exp["flips"],
               "sampled_logits_err": rerr.max().item()}
        if M > 1:
            win = int(ids[0])
            low = 5 if win > 5 else win + 1
            tied = QuantizedTensor(
                levels=qt.levels.clone(), scales=qt.scales.clone(),
                mins=None if qt.mins is None else qt.mins.clone(),
                qtype=qt.qtype, packed=qt.packed)
            for t in (tied.levels, tied.scales, tied.mins):
                if t is not None:
                    t[:, low] = t[:, win]
            xt = x.clone()
            xt[M - 1] = float("nan")
            tid, tmv = lm_head_argmax(xt, lnw, lnb, tied, V, eps)
            tlo, tgm = sampled(xt, tied)
            torch.cuda.synchronize()
            check(int(tid[0]) == min(low, win)
                  and int(tid[M - 1]) == V - 1 and bool(torch.isnan(tmv[M - 1]))
                  and bool(torch.isnan(tlo[M - 1, :V]).all())
                  and bool(torch.isnan(tgm[M - 1, :V // 128]).all())
                  and bool(torch.isfinite(tgm[:M - 1]).all()),
                  f"{what}: tie row 0 id {int(tid[0])} (want {min(low, win)}), "
                  f"NaN row id {int(tid[M - 1])} max {float(tmv[M - 1])}")
            rec.update(tie_id=int(tid[0]), nan_row_id=int(tid[M - 1]))
        if flush is not None and M == 8:
            def lib_call():
                xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, eps)
                logits = xn.to(bf16) @ dequantize(qt, bf16)
                return torch.argmax(logits[:, :V], dim=-1)
            timed(rec, lambda: lm_head_argmax(x, lnw, lnb, qt, V, eps),
                  lambda: lm_head_argmax_plain(x, lnw, lnb, qt, V, eps),
                  lib_call, qbytes(qt) + M * D * 4 + 2 * D * 4 + M * 8,
                  2 * M * D * V_PAD, reps=50, plain_reps=5, flush=flush)
            rec["trace"] = tail_trace(
                lambda: lm_head_argmax(x, lnw, lnb, qt, V, eps),
                f"lm_head_argmax M={M} {fmt}", small=True)["kernels"]
        c.emit(rec)
    c.formats.setdefault("lm_head_logits_gmax_commit", set()).add(fmt)


def hold_tails(c: Ctx, qt, lnw, lnb, M: int, fmt: str) -> dict:
    """The greedy and sampled lm_head tails with their KV commit at M rows,
    and ``lm_head_argmax`` at M (timed above M = 8), against their plain
    versions on random rows and caches, timed beside their bounds and
    one-call yardsticks; above M = 8 each tail traced (:func:`tail_trace`)
    -> {kernel: record} of the two tails."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        lm_head_argmax, lm_head_argmax_commit, lm_head_argmax_commit_plain,
        lm_head_argmax_plain, lm_head_logits_gmax_commit,
        lm_head_logits_gmax_commit_plain)

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, L, V = cfg.d_model, cfg.n_layer, cfg.n_vocab
    S = 512
    recs = {}
    x = c.randn(M, D)
    kc = c.randn(L, M, S, D).to(torch.bfloat16)
    vc = c.randn(L, M, S, D).to(torch.bfloat16)
    krt = c.randn(M, L, D).to(torch.bfloat16)
    vrt = c.randn(M, L, D).to(torch.bfloat16)
    past = ragged_past(M)
    pt = torch.tensor(past, dtype=torch.int32, device=dev)
    slots = torch.arange(M, device=dev)
    pos = pt.long()
    commit_bytes = 4 * L * M * D * 2 + M * 4
    # held to the plain version's logits (see lm_head_expect); ids
    # compared where the top-2 gap exceeds the tolerance
    exp = lm_head_expect(x, lnw, lnb, qt, cfg.ln_eps,
                         f"lm_head tails M={M} {fmt}")
    tol, row_tol = exp["tol"], exp["row_tol"]

    # greedy: ids, winning logits and caches against the plain tail
    ids, mv, k1, v1 = lm_head_argmax_commit(
        x, lnw, lnb, qt, V, kc.clone(), vc.clone(), krt, vrt, pt,
        cfg.ln_eps)
    _, _, k2, v2 = lm_head_argmax_commit_plain(
        x, lnw, lnb, qt, V, kc.clone(), vc.clone(), krt, vrt, pt,
        cfg.ln_eps)
    torch.cuda.synchronize()
    err, decided = tail_ids_within(ids, mv, exp, V,
                                   f"lm_head_argmax_commit M={M} {fmt}")
    check(bool(torch.equal(k1, k2)) and bool(torch.equal(v1, v2)),
          f"lm_head_argmax_commit M={M} {fmt}: caches differ")
    aid, amv = lm_head_argmax(x, lnw, lnb, qt, V, cfg.ln_eps)
    aerr, adecided = tail_ids_within(aid, amv, exp, V,
                                     f"lm_head_argmax M={M} {fmt}")
    c.formats.setdefault("lm_head_argmax", set()).add(fmt)
    if M > 8:   # row 3 at M > 8: the tail without its commit, timed
        def argmax_only_lib():
            xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
            logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
            return torch.argmax(logits[:, :V], dim=-1)
        rec = {"kernel": "lm_head_argmax", "m": M, "format": fmt,
               "max_abs_err": aerr, "tol": tol, "ids_decided": adecided,
               "ln_flips": exp["flips"]}
        timed(rec, lambda: lm_head_argmax(x, lnw, lnb, qt, V, cfg.ln_eps),
              lambda: lm_head_argmax_plain(x, lnw, lnb, qt, V, cfg.ln_eps),
              argmax_only_lib, qbytes(qt) + M * D * 4 + 2 * D * 4 + M * 8,
              2 * M * D * V_PAD)
        c.emit(rec)

    def argmax_lib():
        xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
        logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
        kc[:, slots, pos] = krt.transpose(0, 1)
        vc[:, slots, pos] = vrt.transpose(0, 1)
        return torch.argmax(logits[:, :V], dim=-1)
    rec = {"kernel": "lm_head_argmax_commit", "m": M, "format": fmt,
           "past": past,
           "max_abs_err": err, "tol": tol, "row_tol": row_tol.tolist(),
           "ids_decided": decided, "ln_flips": exp["flips"]}
    timed(rec, lambda: lm_head_argmax_commit(
              x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
          lambda: lm_head_argmax_commit_plain(
              x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
          argmax_lib, qbytes(qt) + M * D * 4 + 2 * D * 4 + M * 8
          + commit_bytes, 2 * M * D * V_PAD)
    rec["trace"] = tail_trace(lambda: lm_head_argmax_commit(
        x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
        f"lm_head_argmax_commit M={M} {fmt}", small=M <= 8)["kernels"]
    recs["lm_head_argmax_commit"] = rec
    c.emit(rec)

    # sampled: logits, their group maxima, pad columns, caches
    lo, gm, k1, v1 = lm_head_logits_gmax_commit(
        x, lnw, lnb, qt, V, kc.clone(), vc.clone(), krt, vrt, pt,
        cfg.ln_eps)
    _, _, k2, v2 = lm_head_logits_gmax_commit_plain(
        x, lnw, lnb, qt, V, kc.clone(), vc.clone(), krt, vrt, pt,
        cfg.ln_eps)
    torch.cuda.synchronize()
    rerr = (lo[:, :V] - exp["plain"][:, :V]).abs().amax(-1)
    err = rerr.max().item()
    own = lo.reshape(M, -1, 128).amax(-1)
    check(bool((rerr <= row_tol).all()) and bool(torch.equal(gm, own))
          and bool((lo[:, V:] == -1e30).all()),
          f"lm_head_logits_gmax_commit M={M} {fmt}: logits err "
          f"{rerr.tolist()} "
          f"(tol {row_tol.tolist()}), gmax equal to its logits' group "
          f"maxima: {bool(torch.equal(gm, own))}")
    f = exp["flipped"]
    if bool(f.any()):
        ferr = (lo[f, :V] - exp["ref"][f, :V]).abs().max().item()
        check(ferr <= tol, f"lm_head_logits_gmax_commit M={M} {fmt}: flipped "
              f"rows' logits err {ferr} from the kernel-LN reference "
              f"(tol {tol})")
    check(bool(torch.equal(k1, k2)) and bool(torch.equal(v1, v2)),
          f"lm_head_logits_gmax_commit M={M} {fmt}: caches differ")

    def gmax_lib():
        xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
        logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
        kc[:, slots, pos] = krt.transpose(0, 1)
        vc[:, slots, pos] = vrt.transpose(0, 1)
        return logits.float().reshape(M, -1, 128).amax(-1)
    rec = {"kernel": "lm_head_logits_gmax_commit", "m": M,
           "format": fmt, "past": past,
           "max_abs_err": err, "tol": tol, "row_tol": row_tol.tolist(),
           "ln_flips": exp["flips"]}
    timed(rec, lambda: lm_head_logits_gmax_commit(
              x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
          lambda: lm_head_logits_gmax_commit_plain(
              x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
          gmax_lib, qbytes(qt) + M * D * 4 + 2 * D * 4
          + M * V_PAD * 4 + M * (V_PAD // 128) * 4 + commit_bytes,
          2 * M * D * V_PAD)
    rec["trace"] = tail_trace(lambda: lm_head_logits_gmax_commit(
        x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
        f"lm_head_logits_gmax_commit M={M} {fmt}", small=M <= 8)["kernels"]
    recs["lm_head_logits_gmax_commit"] = rec
    c.emit(rec)
    del kc, vc, k1, v1, k2, v2
    return recs


# ------------------------------------- 4. refill prefill and int8 kernels

def rand_int8_cache(c: Ctx, L: int, B: int, S: int, D: int | None = None):
    """int8 levels (L, B, S, D) (D: d_model, or a TP shard's row) and f32
    row scales (L, B, 1, S) whose dequantized rows have about unit
    magnitude."""
    D = D or c.cfg.d_model
    lv = torch.randint(-127, 128, (L, B, S, D), generator=c.gen, device=c.dev,
                       dtype=torch.int32).to(torch.int8)
    sc = torch.rand(L, B, 1, S, generator=c.gen, device=c.dev) * 0.01 + 0.005
    return lv, sc


def padded_prompts(c: Ctx, R: int, T: int):
    """x0 (R*T, D) of R prompts of ragged real lengths 1..T padded to T:
    real rows random, padding rows one shared pad vector plus a position
    term, as padded embeddings are -> (x0, lengths)."""
    D = c.cfg.d_model
    lens = torch.randint(1, T + 1, (R,), generator=c.gen, device=c.dev)
    x0 = c.randn(R, T, D)
    pad = c.randn(D)[None, None, :] + 0.1 * c.randn(1, T, D)
    padding = torch.arange(T, device=c.dev)[None, :] >= lens[:, None]
    x0 = torch.where(padding[..., None], pad.expand(R, T, D), x0)
    return x0.reshape(R * T, D).contiguous(), lens.tolist()


def per_op_params(c: Ctx, layers) -> dict:
    """A full-size params dict around ``layers`` for the per-op forward."""
    cfg = c.cfg
    D = cfg.d_model
    return {"embed_tokens": 0.02 * c.randn(cfg.n_vocab, D),
            "embed_positions": 0.02 * c.randn(cfg.n_positions + 2, D),
            "layers": layers,
            "final_ln": {"w": 1 + 0.1 * c.randn(D), "b": 0.1 * c.randn(D)},
            "lm_head": c.rand_qt(D, c.V_PAD)}


def phase_refill_int8_kernels(c: Ctx) -> None:
    from biogpt_tpu_torch.models.biogpt import forward
    from biogpt_tpu_torch.ops.decode_kernels import (
        decode_step_fused, decode_step_fused_batched_plain,
        decode_step_fused_plain, kv_commit_quant, kv_commit_quant_plain)
    from biogpt_tpu_torch.ops.prefill_kernels import (prefill_fused,
                                                      prefill_fused_plain)
    from biogpt_tpu_torch.runtime.cache import init_cache
    from biogpt_tpu_torch.tools.kernel_bounds import (int8_step_cost,
                                                      prefill_cost)

    cfg, dev = c.cfg, c.dev
    D, L, H, S = cfg.d_model, cfg.n_layer, cfg.n_head, cfg.n_positions

    # prefill_fused at the refill shapes, ragged real lengths
    for mins in (False, True):
        layers, wbytes = c.rand_layers(mins)
        fmt = "q4_1" if mins else "q4_0"
        params = None if mins else per_op_params(c, layers)
        for R, T in ((32, 32), (8, 128), (1, 512)):
            x0, lens = padded_prompts(c, R, T)
            run = lambda: prefill_fused(x0, layers, rows=R, padded=T,
                                        n_head=H, ln_eps=cfg.ln_eps)
            plain = lambda: prefill_fused_plain(x0, layers, rows=R, padded=T,
                                                n_head=H, ln_eps=cfg.ln_eps)
            x, kr, vr = run()
            xp, krp, vrp = plain()
            torch.cuda.synchronize()
            what = f"prefill_fused {R}x{T} {fmt}"
            err = hidden_within(x, xp, what)
            rows = max(rows_within(kr, krp, what + " k"),
                       rows_within(vr, vrp, what + " v"))
            rec = {"kernel": "prefill_fused", "layers": L, "R": R, "T": T,
                   "lengths": lens, "format": fmt, "max_abs_err": err,
                   "tol": 3e-3 * xp.abs().max().item(),
                   "rows_err_over_tol": rows}
            if not mins:
                timed(rec, run, plain, None, *prefill_cost(cfg, R, T, wbytes),
                      reps=10)
                # where its time goes: the chain's kernels by role
                rec["trace"] = prefill_trace(
                    run, L, f"prefill_fused {R}x{T} {fmt}")["roles_ms"]
                # the path it replaces: the per-op refill of the same group
                ids = torch.randint(4, cfg.n_vocab, (R, T), generator=c.gen,
                                    device=dev)
                last = torch.tensor([n - 1 for n in lens], device=dev)

                def per_op():
                    small = init_cache(cfg, batch=R, max_len=T,
                                       dtype=torch.bfloat16, device=dev)
                    return forward(params, ids, small, 0, cfg,
                                   compute_dtype=torch.bfloat16,
                                   allow_kernels=False, last_index=last)
                rec["per_op_ms"] = time_ms(per_op, 5)
                rec["per_op_ms_range"] = SPREAD[per_op]
                if (R, T) == (32, 32):
                    c.results["prefill_fused"] = rec
            c.emit(rec)
        del layers, params

    # the int8 decode step: B=1 (past 100, window 128, and past 900,
    # window 1024); B=8 and B=32 (window 512, ragged positions, dead slots,
    # one slot past the window); timed on Q4_0 planes (B=1 traced), held on
    # Q4_1 planes too (B=1 and B=32; B=1 past 100 timed)
    W = 512
    for mins in (False, True):
        layers, wbytes = c.rand_layers(mins)
        fmt = "q4_1" if mins else "q4_0"
        kc, ks = rand_int8_cache(c, L, 1, S)
        vc, vs = rand_int8_cache(c, L, 1, S)
        x0 = c.randn(1, D)
        for past, window in ((100, 128), (900, 1024)):
            run = lambda: decode_step_fused(
                x0, layers, kc, vc, past, n_head=H, window=window,
                ln_eps=cfg.ln_eps, k_scales=ks, v_scales=vs)
            plain = lambda: decode_step_fused_plain(
                x0, layers, kc, vc, past, n_head=H, window=window,
                ln_eps=cfg.ln_eps, k_scales=ks, v_scales=vs)
            what = f"decode_step_fused int8 B=1 past={past} {fmt}"
            rec = {"kernel": "decode_step_fused_int8", "layers": L,
                   "past": past, "window": window, "format": fmt}
            held_step(run, plain, what, rec, int8=True)
            if not mins or past == 100:
                timed(rec, run, plain, None,
                      *int8_step_cost(cfg, [past], window, wbytes))
                rec["trace"] = b1_trace(run, L, what)["span_ms"]
                if past == 100 and not mins:
                    c.results["decode_step_fused_int8"] = rec
            c.emit(rec)
        del kc, vc, ks, vs

        cases = ((8, ragged_past(8, dead=(2, 5), beyond=(7,))),
                 (32, ragged_past(32, dead=(7, 19))))
        for B, past in cases if not mins else cases[1:]:
            kc, ks = rand_int8_cache(c, L, B, S)
            vc, vs = rand_int8_cache(c, L, B, S)
            x0 = c.randn(B, D)
            pt = torch.tensor(past, dtype=torch.int32, device=dev)
            run = lambda: decode_step_fused(x0, layers, kc, vc, pt, n_head=H,
                                            window=W, ln_eps=cfg.ln_eps,
                                            k_scales=ks, v_scales=vs)
            plain = lambda: decode_step_fused_batched_plain(
                x0, layers, kc, vc, pt, n_head=H, window=W, ln_eps=cfg.ln_eps,
                k_scales=ks, v_scales=vs)
            rec = {"kernel": "decode_step_fused_batched_int8", "layers": L,
                   "B": B, "past": past, "window": W, "format": fmt}
            held_step(run, plain, f"decode_step_fused int8 B={B} {fmt}", rec,
                      int8=True)
            if B == 32:
                gemv_trace(run, L, f"batched int8 B=32 {fmt}")
            if not mins:
                timed(rec, run, plain, None,
                      *int8_step_cost(cfg, past, W, wbytes))
                if B == 32:
                    c.results["decode_step_fused_batched_int8"] = rec
            c.emit(rec)
            del kc, vc, ks, vs
        del layers

    # kv_commit_quant at B=32: bit-equal, and clamped outside [0, S)
    B, S = 32, 512
    kc, ks = rand_int8_cache(c, L, B, S)
    vc, vs = rand_int8_cache(c, L, B, S)
    kq = torch.randint(-127, 128, (L, B, D), generator=c.gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    vq = torch.randint(-127, 128, (L, B, D), generator=c.gen, device=dev,
                       dtype=torch.int32).to(torch.int8)
    ksc = torch.rand(L, B, generator=c.gen, device=dev)
    vsc = torch.rand(L, B, generator=c.gen, device=dev)
    rows = (kq.transpose(0, 1), vq.transpose(0, 1),
            ksc.transpose(0, 1)[..., None], vsc.transpose(0, 1)[..., None])
    same = True
    for past in (ragged_past(B, dead=(7, 19)),
                 [-3, S + 5] + ragged_past(B - 2)):
        pt = torch.tensor(past, dtype=torch.int32, device=dev)
        got = kv_commit_quant(kc.clone(), vc.clone(), ks.clone(), vs.clone(),
                              *rows, pt)
        want = kv_commit_quant_plain(kc.clone(), vc.clone(), ks.clone(),
                                     vs.clone(), *rows, pt)
        torch.cuda.synchronize()
        same = same and all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    check(same, "kv_commit_quant B=32: caches differ from the plain commit "
          "(positions in range, or clamped)")
    past = ragged_past(B, dead=(7, 19))
    pt = torch.tensor(past, dtype=torch.int32, device=dev)
    slots, pos = torch.arange(B, device=dev), pt.long()

    def commit_lib():
        kc[:, slots, pos] = kq
        vc[:, slots, pos] = vq
        ks[:, slots, 0, pos] = ksc
        vs[:, slots, 0, pos] = vsc
    rec = {"kernel": "kv_commit_quant", "B": B, "L": L, "past": past,
           "max_abs_err": 0.0 if same else float("nan"), "tol": 0.0}
    timed(rec, lambda: kv_commit_quant(kc, vc, ks, vs, *rows, pt),
          lambda: kv_commit_quant_plain(kc, vc, ks, vs, *rows, pt),
          commit_lib, 4 * L * B * (D + 4) + B * 4, 0, reps=50)
    c.results["kv_commit_quant"] = rec
    c.emit(rec)
    del kc, vc, ks, vs
    hold_commit_rows(c)


def commit_rows_case(c: Ctx, L: int, B: int, D: int):
    """The f32 K and V rows (L, B, D) of a commit hold: random rows, and in
    slot 0 rows whose every element divides to an exact .5 tie (absmax 127
    and odd halves; absmax 254 and odd integers), a zero row, rows holding
    a NaN, an inf and a -inf."""
    kr, vr = 3 * c.randn(L, B, D), c.randn(L, B, D)
    ar = torch.arange(D, device=c.dev, dtype=torch.float32) % 254 - 127
    kr[0, 0] = ar + 0.5
    kr[0, 0, 0] = 127.0
    vr[0, 0] = 2 * ar + 1
    vr[0, 0, 0] = 254.0
    kr[1, 0] = 0.0
    kr[2, 0, 5] = float("nan")
    vr[3, 0, 7] = float("inf")
    vr[4, 0, 9] = -float("inf")
    return kr, vr


def bits_equal(got, want) -> bool:
    """The tensors equal bit for bit (f32 through their bits: NaN scales)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return all(bool(torch.equal(bits(a), bits(b))) for a, b in zip(got, want))


def hold_commit_rows(c: Ctx) -> None:
    """Row 11's fused mode, ``kv_commit_quant_rows`` (the int8 steps'
    commit with the rows' quantization folded in), against its plain
    version on the card (``quantize_rows``, then ``kv_commit_quant_plain``)
    bit for bit, levels and the scales' bits, on :func:`commit_rows_case`'s
    rows: at B=32 with positions on the device (ragged with dead slots, and
    clamped: -3 and S + 5) and at B=1 with the host's position (100, -3, S
    + 5) and a (1,) tensor; timed on random rows at B=32 and at B=1 (the
    host's position) beside its bound and ``quantize_rows`` + the index
    store."""
    from biogpt_tpu_torch.ops.decode_kernels import (
        kv_commit_quant_rows, kv_commit_quant_rows_plain)
    from biogpt_tpu_torch.runtime.cache import quantize_rows

    cfg, dev = c.cfg, c.dev
    D, L, S = cfg.d_model, cfg.n_layer, 512
    for B in (32, 1):
        kc, ks = rand_int8_cache(c, L, B, S)
        vc, vs = rand_int8_cache(c, L, B, S)
        kr, vr = commit_rows_case(c, L, B, D)
        if B == 32:
            cases = [ragged_past(B, dead=(7, 19)),
                     [-3, S + 5] + ragged_past(B - 2)]
            cases = [torch.tensor(p, dtype=torch.int32, device=dev)
                     for p in cases]
        else:
            cases = [100, -3, S + 5,
                     torch.tensor([S + 5], dtype=torch.int32, device=dev)]
        same = True
        for past in cases:
            got = kv_commit_quant_rows(kc.clone(), vc.clone(), ks.clone(),
                                       vs.clone(), kr, vr, past)
            want = kv_commit_quant_rows_plain(kc.clone(), vc.clone(),
                                              ks.clone(), vs.clone(), kr, vr,
                                              past)
            torch.cuda.synchronize()
            ok = bits_equal(got, want)
            check(ok, f"kv_commit_quant_rows B={B} past "
                  f"{past if isinstance(past, int) else past[:3].tolist()}: "
                  "caches differ from the plain commit")
            same = same and ok
        # timed on the rows a step gives (the special rows above take the
        # divide's slow path)
        kr, vr = c.randn(L, B, D), c.randn(L, B, D)
        past = cases[0]
        if B == 32:
            slots, pos = torch.arange(B, device=dev), past.long()
        else:
            slots, pos = torch.arange(1, device=dev), torch.tensor([past],
                                                                   device=dev)

        def commit_lib():
            kq, ksc = quantize_rows(kr)
            vq, vsc = quantize_rows(vr)
            kc[:, slots, pos] = kq
            vc[:, slots, pos] = vq
            ks[:, slots, 0, pos] = ksc
            vs[:, slots, 0, pos] = vsc
        rec = {"kernel": "kv_commit_quant_rows", "B": B, "L": L,
               "past": past.tolist() if B == 32 else past,
               "max_abs_err": 0.0 if same else float("nan"), "tol": 0.0}
        timed(rec, lambda: kv_commit_quant_rows(kc, vc, ks, vs, kr, vr, past),
              lambda: kv_commit_quant_rows_plain(kc, vc, ks, vs, kr, vr, past),
              commit_lib, 2 * L * B * D * 4 + 2 * L * B * (D + 4)
              + (B * 4 if B == 32 else 0), 0, reps=50)
        # a trace that lost the kernel's record, the wrapper having counted
        # its launch, is taken again, up to three times
        for _ in range(3):
            launches = {}
            rec["trace"] = {k: v for k, v in kernel_trace(
                lambda: kv_commit_quant_rows(kc, vc, ks, vs, kr, vr, past),
                counted=launches).items() if "spin_kernel" not in k}
            counted = launches.get("kv_commit_quant_rows", 0)
            if rec["trace"] or counted != 1:
                break
        check(launches_of(rec["trace"], "kv_commit_quant_rows_kernel") == 1
              and len(rec["trace"]) == 1 and counted == 1,
              f"kv_commit_quant_rows B={B}: launched {rec['trace']}, "
              f"{counted} counted")
        if B == 32:
            c.results["kv_commit_quant_rows"] = rec
        c.emit(rec)
        del kc, vc, ks, vs


# ------------------------------------------------- 5. paged and staged steps

def phase_paged_staged_kernels(c: Ctx) -> None:
    """The paged and staged steps round p relative to the same running max
    over the same KV blocks as their plain versions, unlike the split
    kernels; yet over 24 layers (and over one) their errors measured as
    large as the split kernels' (H100): the bf16 roundings of h, q, p and
    the context row that f32 summation order flips dominate both. So they
    keep the decode steps' limits (:func:`hidden_within`,
    :func:`rows_within`)."""
    from biogpt_tpu_torch.ops.decode_kernels import (
        decode_step_fused, decode_step_fused_paged_plain,
        decode_step_fused_staged_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import (bf16_step_cost,
                                                      int8_step_cost)

    cfg, dev = c.cfg, c.dev
    D, L, H, S = cfg.d_model, cfg.n_layer, cfg.n_head, cfg.n_positions
    W = 512
    timed_past = ragged_past(32, dead=(7, 19))
    beyond_past = ragged_past(32, dead=(7, 19), beyond=(30,))

    for mins in (False, True):
        layers, wbytes = c.rand_layers(mins)
        fmt = "q4_1" if mins else "q4_0"
        for quant in (False, True):
            name = ("decode_step_fused_paged_int8" if quant
                    else "decode_step_fused_paged")
            cases = [(1, [100]), (1, [600]), (32, beyond_past),
                     (32, timed_past)]
            for B, past in cases if not mins else cases[2:3]:
                if quant:
                    kc, ks = rand_int8_cache(c, L, B, S)
                    vc, vs = rand_int8_cache(c, L, B, S)
                    scales = dict(k_scales=ks, v_scales=vs)
                else:
                    kc = c.randn(L, B, S, D).to(torch.bfloat16)
                    vc = c.randn(L, B, S, D).to(torch.bfloat16)
                    scales = {}
                x0 = c.randn(B, D)
                pt = torch.tensor(past, dtype=torch.int32, device=dev)
                run = lambda: decode_step_fused(
                    x0, layers, kc, vc, pt, n_head=H, window=W,
                    ln_eps=cfg.ln_eps, per_slot_kv=True, **scales)
                plain = lambda: decode_step_fused_paged_plain(
                    x0, layers, kc, vc, pt, n_head=H, window=W,
                    ln_eps=cfg.ln_eps, **scales)
                rec = {"kernel": name, "layers": L, "B": B, "past": past,
                       "window": W, "format": fmt}
                x, kr, vr = held_step(run, plain, f"{name} B={B} {fmt}", rec,
                                      int8=quant)
                if B == 32:
                    gemv_trace(run, L, f"{name} B=32 {fmt}")
                if B == 32 and not mins:
                    # the paged step against the lockstep (split-KV) CUDA
                    # step on the same inputs: the split kernels' limits
                    xb, krb, vrb = decode_step_fused(
                        x0, layers, kc, vc, pt, n_head=H, window=W,
                        ln_eps=cfg.ln_eps, **scales)
                    torch.cuda.synchronize()
                    what = f"{name} B=32 vs the batched CUDA step"
                    rec["vs_batched_cuda_err"] = hidden_within(x, xb, what)
                    rec["vs_batched_cuda_rows_err_over_tol"] = max(
                        rows_within(kr, krb, what + " k"),
                        rows_within(vr, vrb, what + " v"))
                if past is timed_past and not mins:
                    cost = (int8_step_cost if quant else bf16_step_cost)(
                        cfg, past, W, wbytes)
                    timed(rec, run, plain, None, *cost)
                    c.results[name] = rec
                c.emit(rec)
                del kc, vc, scales

        # the staged step: B=32, 16 staging rows, chunk-start positions
        # ragged (dead slots at 0), step 0, 7 and 15 of the chunk (Q4_1:
        # step 7)
        B, C = 32, 16
        kc = c.randn(L, B, S, D).to(torch.bfloat16)
        vc = c.randn(L, B, S, D).to(torch.bfloat16)
        k_st = c.randn(L, B, C, D).to(torch.bfloat16)
        v_st = c.randn(L, B, C, D).to(torch.bfloat16)
        x0 = c.randn(B, D)
        for step_i in (0, 7, 15) if not mins else (7,):
            past = [p + step_i for p in timed_past]
            pt = torch.tensor(past, dtype=torch.int32, device=dev)
            run = lambda: decode_step_fused(
                x0, layers, kc, vc, pt, n_head=H, window=W, ln_eps=cfg.ln_eps,
                k_stage=k_st, v_stage=v_st, step_i=step_i)
            plain = lambda: decode_step_fused_staged_plain(
                x0, layers, kc, vc, pt, k_st, v_st, step_i, n_head=H,
                window=W, ln_eps=cfg.ln_eps)
            rec = {"kernel": "decode_step_fused_staged", "layers": L, "B": B,
                   "past": past, "window": W, "stage_rows": C,
                   "step_i": step_i, "format": fmt}
            held_step(run, plain,
                      f"decode_step_fused_staged step_i={step_i} {fmt}", rec)
            if step_i == 7:
                gemv_trace(run, L, f"staged B=32 step 7 {fmt}")
            if step_i == 7 and not mins:
                timed(rec, run, plain, None,
                      *bf16_step_cost(cfg, past, W, wbytes, step_i))
                c.results["decode_step_fused_staged"] = rec
            c.emit(rec)
        del k_st, v_st
        if not mins:
            # a chunk of 80: at step 70 the staged rows fill more than a
            # CTA's range and continue over the slot's next CTAs
            C, step_i = 80, 70
            k_st = c.randn(L, B, C, D).to(torch.bfloat16)
            v_st = c.randn(L, B, C, D).to(torch.bfloat16)
            past = [p + step_i for p in timed_past]
            pt = torch.tensor(past, dtype=torch.int32, device=dev)
            run = lambda: decode_step_fused(
                x0, layers, kc, vc, pt, n_head=H, window=W, ln_eps=cfg.ln_eps,
                k_stage=k_st, v_stage=v_st, step_i=step_i)
            plain = lambda: decode_step_fused_staged_plain(
                x0, layers, kc, vc, pt, k_st, v_st, step_i, n_head=H,
                window=W, ln_eps=cfg.ln_eps)
            rec = {"kernel": "decode_step_fused_staged", "layers": L, "B": B,
                   "past": past, "window": W, "stage_rows": C,
                   "step_i": step_i, "format": fmt}
            held_step(run, plain,
                      f"decode_step_fused_staged step_i={step_i} of {C}", rec)
            gemv_trace(run, L, f"staged B=32 step {step_i} of {C} {fmt}")
            c.emit(rec)
            del k_st, v_st
        del kc, vc, layers


# ------------------------------------ 5a. the batched steps' attention

def attn_operands(c: Ctx, B: int, W: int, S: int, past: list, mode: str,
                  step_i: int = 0, rising: bool = False,
                  stage_rows: int | None = None,
                  block_steps: float | None = None) -> tuple:
    """One layer's attention inputs in ``mode`` (:data:`BREAKDOWN_MODES`):
    qkv rows (B, 3D) f32, this layer's (B, S, D) caches (bf16, or int8 with
    (B, 1, S) scales) and, staged, ``stage_rows`` staging rows (16 by
    default) at ``step_i``; the KV block of the mode's step; ``rising``:
    the longest slot's last 300 live rows' K four times larger, so its
    running max rises in late blocks -> (keyword arguments of
    ``batched_attention``, the largest |v| the call may weigh).
    ``block_steps`` (a step d) makes the scores constant in each KV block
    and falling by d from block to block (q the first element of each
    head, that element of each cache row -j d in block j, the staged rows
    -(blocks) d), and every |v| at most 1 with the first element of each
    head's V 1: each block's p then rounds the same way in every row, so p
    rounded against anything but the prefix max moves that element of the
    context by up to 2^-9 (:func:`attn_expect`'s faults)."""
    from biogpt_tpu_torch.ops.decode_kernels import kv_block, kv_block_paged

    D, H = c.cfg.d_model, c.cfg.n_head
    Dk = D // H
    C = stage_rows or BREAKDOWN_STAGE[0]
    kw = dict(qkv=c.randn(B, 3 * D), n_head=H, window=W,
              past=torch.tensor(past, dtype=torch.int32, device=c.dev),
              kvb=kv_block_paged(W) if mode.startswith("paged")
              else kv_block(W, D, batch=B))
    if block_steps is not None:
        kw["qkv"] = torch.rand(B, 3 * D, generator=c.gen, device=c.dev) * 2 - 1
        kw["qkv"][:, :D] = 0
        kw["qkv"][:, :D:Dk] = math.sqrt(Dk)   # q: 1 at each head's first
    if mode.endswith("int8"):
        kc, ks = rand_int8_cache(c, 1, B, S)
        vc, vs = rand_int8_cache(c, 1, B, S)
        kw.update(k_cache=kc[0], v_cache=vc[0], k_scales=ks[0],
                  v_scales=vs[0])
        if block_steps is not None:
            # K: level -16 j at each head's first, the row's scale d / 16;
            # V: level 127 there, the row's scale 1/127
            j = (torch.arange(S, device=c.dev) // kw["kvb"]).to(torch.int8)
            kw["k_cache"][:, :, ::Dk] = (-16 * j)[None, :, None]
            kw["k_scales"].fill_(block_steps / 16)
            kw["v_cache"][:, :, ::Dk] = 127
            kw["v_scales"].fill_(1 / 127)
        vmax = (kw["v_cache"].float().abs()
                * kw["v_scales"].transpose(1, 2)).max().item()
    else:
        kw.update(k_cache=c.randn(B, S, D).to(torch.bfloat16),
                  v_cache=c.randn(B, S, D).to(torch.bfloat16))
        if block_steps is not None:
            j = (torch.arange(S, device=c.dev) // kw["kvb"]).float()
            kw["k_cache"][:, :, ::Dk] = (-block_steps * j).to(
                torch.bfloat16)[None, :, None]
            kw["v_cache"] = (torch.rand(B, S, D, generator=c.gen,
                                        device=c.dev) * 2 - 1).to(
                torch.bfloat16)
            kw["v_cache"][:, :, ::Dk] = 1
        vmax = kw["v_cache"].float().abs().max().item()
    if mode.startswith("staged"):
        kw.update(k_stage=c.randn(B, C, D).to(torch.bfloat16),
                  v_stage=c.randn(B, C, D).to(torch.bfloat16),
                  step_i=step_i)
        if block_steps is not None:
            kw["k_stage"][:, :, ::Dk] = -block_steps * (W // kw["kvb"])
            kw["v_stage"] = (torch.rand(B, C, D, generator=c.gen,
                                        device=c.dev) * 2 - 1).to(
                torch.bfloat16)
            kw["v_stage"][:, :, ::Dk] = 1
        vmax = max(vmax, kw["v_stage"].float().abs().max().item())
    if rising:
        b = max(range(B), key=lambda i: past[i])
        hi = min(past[b] - step_i, W)
        if "k_scales" in kw:
            kw["k_scales"][b, :, hi - 300:hi] *= 4
        else:
            kw["k_cache"][b, hi - 300:hi] *= 4
    vmax = max(vmax, kw["qkv"][:, 2 * D:].abs().max().item())
    return kw, vmax


def attn_expect(kw: dict, vmax: float, rows_cap: int) -> dict:
    """What ``batched_attention``'s context is held to, element by element,
    and what two faults would read, from the TPU kernel's arithmetic in
    torch (the plain fold's scores, prefix maxima and bf16 p; ``rows_cap``
    rows a CTA, as the kernel's plan) -> {"tol": (B, D), "model": (B, D),
    "faults": {name: (B, D) context}, "band_rows": rows in a flip band}.

    The limit is the sum of three terms:
      - f32 order: 2^-24 (W + C + 2) 4 of the largest |v|, the bound that
        tests/test_torch_attn_split.py holds the split order to when both
        sides take the same scores (each term exact to a few f32 ulps, at
        most W + C + 1 rows add, exp(M_j - M_last) for the fold's product
        of per-block factors);
      - the scores: the kernel and torch sum q . k in different orders, so
        a score and its prefix max each differ by up to 2^-18 Dk |q|.|k|
        between them (2 Dk 2^-24 of the row's |q|.|k|); with the exp's
        own error (2 ulps each side) and the subtraction's, each raw p
        moves by a relative e_r (twice that sum, for margin). The
        denominator and each block's exp(M_j - M_fin) move with it:
        e (|context| + sum_r |w_r v_r|) with e the largest e_r;
      - the flips: where p (int8: p times its V scale) lies within e_r of a
        bf16 rounding boundary, the two sides may round it to neighbouring
        bf16 values: that row's gap times its weight and |v|.
    The faults: ``cta_dropped``, the second CTA's partial (l, acc) left
    out of every slot that has one; ``local_max``, each row's p rounded
    against the maximum of its block's rows in its own CTA (as the old
    split kernel rounded against its split's max) instead of the prefix
    max."""
    from biogpt_tpu_torch.ops.decode_kernels import fake_quant_rows

    qkv, kc, vc = kw["qkv"], kw["k_cache"], kw["v_cache"]
    B, S, D = kc.shape
    H = kw["n_head"]
    Dk = D // H
    W = min(kw["window"], S)
    kvb = kw["kvb"]
    dev = qkv.device
    quant = kw.get("k_scales") is not None
    staged = kw.get("k_stage") is not None
    step = int(kw.get("step_i", 0)) if staged else 0
    C = kw["k_stage"].shape[1] if staged else 0
    q = (qkv[:, :D] * (1.0 / math.sqrt(Dk))).to(torch.bfloat16).float()
    q = q.view(B, H, Dk)
    k, v = qkv[:, D:2 * D], qkv[:, 2 * D:]
    if quant:
        k, v = fake_quant_rows(k), fake_quant_rows(v)
    # every row of a slot: its W window rows, then its C staged rows
    kr = kc[:, :W].float()
    vr = vc[:, :W].float()
    if staged:
        kr = torch.cat([kr, kw["k_stage"].float()], 1)
        vr = torch.cat([vr, kw["v_stage"].float()], 1)
    kr, vr = kr.view(B, W + C, H, Dk), vr.view(B, W + C, H, Dk)
    sc = torch.einsum("bhd,bwhd->bhw", q, kr)
    mag = torch.einsum("bhd,bwhd->bhw", q.abs(), kr.abs())
    vs = torch.ones(B, 1, W + C, device=dev)
    if quant:
        sc[..., :W] *= kw["k_scales"][:, :, :W]
        mag[..., :W] *= kw["k_scales"][:, :, :W]
        vs[..., :W] = kw["v_scales"][:, :, :W]
    live = (kw["past"].long() - step).clamp(0, W)
    r = torch.arange(W + C, device=dev)
    cache = r[None, :] < W
    valid = torch.where(cache, r[None, :] < live[:, None],
                        r[None, :] - W < step)[:, None, :]     # (B, 1, W+C)
    nbw = W // kvb
    blk = torch.where(cache[0], r // kvb, torch.full_like(r, nbw))
    masked = torch.where(valid, sc, torch.full_like(sc, -1e30))
    bmax = torch.full((B, H, nbw + 1), -1e30, device=dev).scatter_reduce(
        2, blk.expand(B, H, -1), masked, "amax")
    pref = torch.cummax(bmax, -1).values
    mj = pref[..., blk]
    m_last = pref[..., -1]
    cur = (q * k.view(B, H, Dk)).sum(-1)
    m_fin = torch.maximum(m_last, cur)
    p = torch.where(valid, torch.exp(sc - mj), torch.zeros_like(sc))
    pv = p * vs
    w = pv.to(torch.bfloat16).float()
    g = torch.where(valid, torch.exp(mj - m_fin[..., None]),
                    torch.zeros_like(sc))
    pc = torch.exp(cur - m_fin)
    den = (p * g).sum(-1) + pc
    vcur = v.view(B, H, Dk)

    def context(wt, keep=None):
        num = torch.einsum("bhw,bwhd->bhd", wt * g, vr)
        d = den
        if keep is not None:
            num = torch.einsum("bhw,bwhd->bhd", wt * g * keep, vr)
            d = (p * g * keep).sum(-1) + pc
        return ((num + pc[..., None] * vcur) / d[..., None]).reshape(B, D)

    # the rows' range in the slot's sequence (cache rows, then staged rows
    # from the live count on), the CTA of each
    pos = torch.where(cache, r[None, :].expand(B, -1),
                      live[:, None] + r[None, :] - W)
    cta = pos // rows_cap
    # the scores' and exp's room, relative to p
    amax = torch.where(valid, mag, torch.zeros_like(mag)).amax(
        -1, keepdim=True)
    e = 2 * (2 * Dk * 2 ** -24 * (mag + amax)
             + 2 ** -23 * (sc - mj).abs() + 2 ** -21 + 2 ** -23)
    e = torch.where(valid, e, torch.zeros_like(e))
    lo = (pv * (1 - e)).to(torch.bfloat16).float()
    hi = (pv * (1 + e)).to(torch.bfloat16).float()
    gap = (hi - lo).abs()
    weigh = g / den[..., None]
    flips = torch.einsum("bhw,bwhd->bhd", gap * weigh, vr.abs())
    model = context(w)
    wv = torch.einsum("bhw,bwhd->bhd", w * weigh, vr.abs())
    scores = e.amax(-1)[..., None] * (model.view(B, H, Dk).abs() + wv)
    f32 = 2 ** -24 * (W + C + 2) * 4 * vmax
    tol = f32 + scores.reshape(B, D) + flips.reshape(B, D)
    # the faults
    dropped = context(w, keep=(cta != 1)[:, None, :].float())
    grp = blk[None, :] * (W + C) + cta                            # (B, W+C)
    own = torch.full((B, H, (nbw + 1) * (W + C)), -1e30,
                     device=dev).scatter_reduce(
        2, grp[:, None, :].expand(B, H, -1), masked, "amax")
    own = own.gather(2, grp[:, None, :].expand(B, H, -1))
    w_loc = ((torch.where(valid, torch.exp(sc - own), torch.zeros_like(sc))
              * vs).to(torch.bfloat16).float()
             * torch.where(valid, torch.exp(own - mj), torch.zeros_like(sc)))
    local = context(w_loc)
    return {"tol": tol, "model": model,
            "faults": {"cta_dropped": dropped, "local_max": local},
            "band_rows": int((gap > 0).sum()), "f32_term": f32,
            "two_ctas": bool((cta[valid[:, 0, :]] >= 1).any())}


def hold_attention(c: Ctx, what: str, kw: dict, vmax: float,
                   rows_cap: int, faults_seen=()) -> dict:
    """``batched_attention`` against its plain version on the same inputs:
    every context element within :func:`attn_expect`'s limit, the K/V rows
    out equal. Beside it, what each of :func:`attn_expect`'s faults would
    read against the plain version, as the largest ratio of its error to
    the limit: the faults named in ``faults_seen`` must read above 1 (the
    hold would catch them), and a dropped CTA must wherever a slot has a
    second CTA -> the record."""
    from biogpt_tpu_torch.ops.decode_kernels import (batched_attention,
                                                     batched_attention_plain)

    ctx, kr, vr = batched_attention(**kw)
    ctxp, krp, vrp = batched_attention_plain(**kw)
    exp = attn_expect(kw, vmax, rows_cap)
    torch.cuda.synchronize()
    tol = exp["tol"]
    d = (ctx - ctxp).abs()
    err, over = d.max().item(), (d / tol).max().item()
    same = bool(torch.equal(kr, krp)) and bool(torch.equal(vr, vrp))
    check(over <= 1 and bool(torch.isfinite(ctx).all()),
          f"{what}: context err {err}, {over} of its limit")
    check(same, f"{what}: K/V rows differ from the plain version's")
    reads = {k: ((f - ctxp).abs() / tol).max().item()
             for k, f in exp["faults"].items()}
    seen = set(faults_seen) | ({"cta_dropped"} if exp["two_ctas"] else set())
    for k in seen:
        check(reads[k] > 1, f"{what}: the {k} fault reads {reads[k]} of the "
              "limit, which would not catch it")
    return {"kernel": "batched_attention", "max_abs_err": err,
            "err_over_tol": over, "tol": tol.max().item(),
            "tol_min": tol.min().item(), "f32_term": exp["f32_term"],
            "band_rows": exp["band_rows"],
            "model_err_over_tol": ((exp["model"] - ctxp).abs()
                                   / tol).max().item(),
            "fault_reads_over_tol": reads, "faults_held": sorted(seen),
            "rows_equal": same}


def phase_attention_kernels(c: Ctx, smi: str) -> None:
    """The batched steps' attention alone (``batched_attention``: one
    launch of ``attn_batched_kernel``) against its plain version
    (:func:`hold_attention`), every mode (lockstep and paged KV blocks,
    bf16 and int8; staged rows at steps 0, 7, 15 and 70 of 80): B=32
    ragged at window 512 and at the uniform serve's window 128, each timed
    beside its bound and one ``scaled_dot_product_attention`` call on the
    same rows; B=8 with a slot past the window; window 1024 (eight 128-row
    blocks) with slots at 1000 live rows, whose running max rises in late
    blocks, and past the window; and at window 1024 with scores constant in
    each block and falling (``block_steps``), where p rounded against
    anything but the prefix max reads over the limit. Then each batched
    step at both shapes (:func:`step_breakdown`), the staged step under
    two plans (:func:`staged_plans`) and the lockstep bf16 step's timing
    windows (:func:`step_spread`)."""
    from biogpt_tpu_torch.ops.decode_kernels import (attn_plan,
                                                     batched_attention,
                                                     batched_attention_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import attn_call_cost

    cfg = c.cfg
    L, H, D = cfg.n_layer, cfg.n_head, cfg.d_model
    card = torch.cuda.get_device_name(0)
    shapes = breakdown_shapes(c)
    past1024 = ragged_past(32, dead=(7, 19))
    past1024[30], past1024[31] = 1000, 1100
    st_step = {"staged bf16": 7}
    cases = [(shape, mode, st_step.get(mode, 0), {})
             for shape in shapes for mode in BREAKDOWN_MODES]
    cases += [("B=32 window 512 ragged", "staged bf16", i, {})
              for i in (0, 15)]
    # more staged rows than a CTA's range: they continue over more CTAs
    cases += [("B=32 window 512 ragged", "staged bf16", 70,
               {"stage_rows": 80})]
    cases += [("B=8 window 512, a slot past it", mode,
               st_step.get(mode, 0), {}) for mode in BREAKDOWN_MODES]
    cases += [("B=32 window 1024", mode, 15 if mode.startswith("staged")
               else 0, {"rising": True})
              for mode in ("lockstep bf16", "paged int8", "staged bf16")]
    # scores constant in each block, falling block to block: a p rounded
    # against anything but the prefix max must read over the limit
    cases += [("B=32 window 1024", mode, step,
               {"block_steps": BLOCK_STEP, "stage_rows": C})
              for mode, step, C in (("lockstep bf16", 0, None),
                                    ("paged int8", 0, None),
                                    ("staged bf16", 15, None),
                                    ("staged bf16", 70, 80))]
    shapes["B=8 window 512, a slot past it"] = (
        8, 512, cfg.n_positions, ragged_past(8, dead=(2, 5), beyond=(7,)))
    shapes["B=32 window 1024"] = (32, 1024, cfg.n_positions, past1024)
    sdpa = {}
    for shape, mode, step_i, opts in cases:
        B, W, S, past = shapes[shape]
        if mode.startswith("staged"):
            past = [p + step_i for p in past]
        kw, vmax = attn_operands(c, B, W, S, past, mode, step_i, **opts)
        what = (f"batched_attention {mode} {shape} step_i={step_i}"
                + "".join(f" {k}={v}" for k, v in opts.items()))
        cluster, rows_cap = attn_plan(W, kw["kvb"], step_i)
        rec = hold_attention(c, what, kw, vmax, rows_cap,
                             ("local_max",) if "block_steps" in opts else ())
        rec.update(mode=mode, shape=shape, B=B, window=W, past=past,
                   step_i=step_i, kvb=kw["kvb"], cluster=cluster,
                   rows_cap=rows_cap, **opts)
        timed_case = shape in breakdown_shapes(c) and not opts and (
            not mode.startswith("staged") or step_i == 7)
        if timed_case:
            key = (shape, mode.startswith("staged"))
            if key not in sdpa:
                sdpa[key] = sdpa_call(c, B, W, S, past, layers=1)
            timed(rec, lambda: batched_attention(**kw),
                  lambda: batched_attention_plain(**kw), sdpa[key],
                  *attn_call_cost(cfg, past, W, mode.endswith("int8"),
                                  step_i), reps=50)
            # a step launches it once a layer
            rec.update(card=card, card_stamp=smi,
                       layers_ms=L * rec["kernel_ms"],
                       layers_bound_ms=L * rec["bound_ms"],
                       layers_library_ms=L * rec["library_ms"])
            if mode == "lockstep bf16" and shape.startswith("B=32 window 512"):
                c.results["batched_attention"] = rec
        print(json.dumps(rec), flush=True)
        del kw

    layers, _ = c.rand_layers()
    sdpa = {}
    for shape in breakdown_shapes(c):
        for mode in BREAKDOWN_MODES:
            step_breakdown(c, smi, mode, shape, layers, sdpa)
    staged_plans(c, smi, layers)
    del layers
    step_spread(c, smi)


# ------------------------------- 5b. the batched steps' projection GEMV

GEMV_SHAPES = (("qkv", True, "none", False), ("o", False, "none", True),
               ("fc1", True, "gelu", False), ("fc2", False, "none", True))
# (projection, d_in, d_out, LayerNorm, act, residual) at widths whose split
# count (ceil(d_in / 256), one cluster) does not divide a column tile's
# M * 64 sums: d_model 768's qkv (3 splits) and fc2 (d_ff 3072, 12), and
# d_model 640's fc1 (3 splits, the last block with two idle warps)
GEMV_ODD_WIDTHS = (("qkv", 768, 2304, True, "none", False),
                   ("fc2", 3072, 768, False, "none", True),
                   ("fc1", 640, 2560, True, "gelu", False))
GELU_SLOPE = 1.1289   # the largest |GELU'(x)|


def xprime_weight(qt):
    """The weight the X' product multiplies by, in f32 and unrounded:
    (level - offset) * scale [+ min] -> (d_in, d_out)."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import _offset, _raw_levels

    w = ((_raw_levels(qt).float() - _offset(qt))
         * qt.scales.float().repeat_interleave(32, dim=0))
    if qt.mins is not None:
        w = w + qt.mins.float().repeat_interleave(32, dim=0)
    return w


def gemv_expect(x, qt, bias, lnw, lnb, act: str, res, eps: float,
                b1: bool = False) -> dict:
    """What ``decode_gemv``'s (``b1``: ``decode_gemv_b1``'s) output is held
    to: the plain version's, row by row within f32 summation order, 1e-5
    of the product's magnitude --
    plus, with a LayerNorm prologue, for every element of the row that the
    two LayerNorms may round to different bf16 values, the gap between its
    two roundings times its weight row's largest magnitude; after GELU,
    times GELU's largest slope. The kernel's statistics sum in another
    order than torch's, which moves an f32 LayerNorm value by about 1e-7
    of its row's largest magnitude: an element within 2^-19 of it (16
    times that) of a bf16 rounding boundary may round the other way."""
    from biogpt_tpu_torch.ops.decode_kernels import (decode_gemv_b1_plain,
                                                     decode_gemv_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import wide_weight

    fn = decode_gemv_b1_plain if b1 else decode_gemv_plain
    plain = fn(x, qt, bias, ln_w=lnw, ln_b=lnb, ln_eps=eps, act=act,
               residual=res)
    pre = fn(x, qt, None, ln_w=lnw, ln_b=lnb, ln_eps=eps)
    tol = 1e-5 * max(pre.abs().max().item(), plain.abs().max().item()) + 1e-5
    row_tol = torch.full((x.shape[0],), tol, device=x.device)
    flips = 0
    if lnw is not None:
        xc = x - x.mean(-1, keepdim=True)
        y = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
             * lnw.float() + lnb.float())
        d = 2 ** -19 * y.abs().amax(-1, keepdim=True)
        lo, hi = (y - d).to(torch.bfloat16), (y + d).to(torch.bfloat16)
        gap = torch.where(lo != hi, (hi.float() - lo.float()).abs(),
                          torch.zeros_like(y))
        flips = int((lo != hi).sum())
        w = xprime_weight(qt) if b1 else wide_weight(qt)
        row_tol = row_tol + gap @ w.abs().amax(-1)
    if act == "gelu":
        row_tol = row_tol * GELU_SLOPE
    return {"plain": plain, "tol": tol, "row_tol": row_tol,
            "ln_flip_candidates": flips}


def held_gemv(c: Ctx, qt, d_in: int, d_out: int, ln: bool, act: str,
              resid: bool, M: int, what: str, bias: bool = True):
    """``decode_gemv`` at M rows (``decode_gemv_b1`` at M = 1) on random
    inputs against its plain version (:func:`gemv_expect`), with a bias or
    (``bias=False``) none -> (record of the hold, the call's keywords, x)."""
    from biogpt_tpu_torch.ops.decode_kernels import decode_gemv, decode_gemv_b1

    cfg = c.cfg
    bias = 0.02 * c.randn(d_out) if bias else None
    lnw, lnb = ((1 + 0.1 * c.randn(d_in), 0.1 * c.randn(d_in)) if ln
                else (None, None))
    x = c.randn(M, d_in)
    res = c.randn(M, d_out) if resid else None
    kw = dict(ln_w=lnw, ln_b=lnb, ln_eps=cfg.ln_eps, act=act, residual=res)
    y = (decode_gemv_b1 if M == 1 else decode_gemv)(x, qt, bias, **kw)
    exp = gemv_expect(x, qt, bias, lnw, lnb, act, res, cfg.ln_eps, M == 1)
    torch.cuda.synchronize()
    rerr = (y - exp["plain"]).abs().amax(-1)
    check(bool((rerr <= exp["row_tol"]).all())
          and bool(torch.isfinite(y).all()),
          f"{what}: row errors {rerr.tolist()} over "
          f"{exp['row_tol'].tolist()}")
    rec = {"max_abs_err": rerr.max().item(), "tol": exp["tol"],
           "row_tol_max": exp["row_tol"].max().item(),
           "ln_flip_candidates": exp["ln_flip_candidates"]}
    return rec, dict(kw, bias=bias), x


def phase_gemv_kernels(c: Ctx) -> None:
    """The batched steps' projection alone (``decode_gemv``: the
    tensor-core GEMV with its LayerNorm prologue and its bias, GELU or
    residual epilogue) at each 347M projection shape, M = 8, 16 and 32, in
    every format, against its plain version (:func:`held_gemv`), timed
    beside its bound and the one-call yardstick ``x_bf16 @ dequantize(W,
    bf16)`` (timed only; the port never calls it), the L2 flushed before
    each call; then held, untimed, at the widths of ``GEMV_ODD_WIDTHS``,
    whose split-K slices are uneven."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.decode_kernels import (decode_gemv,
                                                     decode_gemv_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import projection_shape

    cfg, dev = c.cfg, c.dev
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for fmt in FORMATS:
        for name, ln, act, resid in GEMV_SHAPES:
            d_in, d_out = projection_shape(cfg, name)
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            for M in (8, 16, 32):
                held, kw, x = held_gemv(c, qt, d_in, d_out, ln, act, resid, M,
                                        f"decode_gemv {name} M={M} {fmt}")
                rec = {"kernel": "decode_gemv", "projection": name,
                       "shape": f"{d_in} -> {d_out}", "m": M, "format": fmt,
                       **held}

                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(qt,
                                                             torch.bfloat16)
                nbytes = (qbytes(qt) + d_out * 4 + (2 * d_in * 4 if ln else 0)
                          + M * d_in * 4 + M * d_out * 4 * (2 if resid else 1))
                timed(rec, lambda: decode_gemv(x, qt, **kw),
                      lambda: decode_gemv_plain(x, qt, **kw), lib_call,
                      nbytes, 2 * M * d_in * d_out, reps=50, plain_reps=5,
                      flush=flush)
                if (fmt, name, M) == ("q4_0", "fc1", 32):
                    c.results["decode_gemv"] = rec
                c.emit(rec)
    del flush_buf
    for name, d_in, d_out, ln, act, resid in GEMV_ODD_WIDTHS:
        for fmt in FORMATS:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            worst = {}
            for M in (8, 16, 32):
                held, _, _ = held_gemv(
                    c, qt, d_in, d_out, ln, act, resid, M,
                    f"decode_gemv {name} {d_in} -> {d_out} M={M} {fmt}")
                worst[M] = held["max_abs_err"] / held["row_tol_max"]
            print(json.dumps({"decode_gemv_odd_width": name,
                              "shape": f"{d_in} -> {d_out}",
                              "splits": -(-d_in // 256), "format": fmt,
                              "err_over_row_tol_by_m": worst}), flush=True)
    # qmatmul_wide at the same widths (their splits of d_in uneven too), on
    # an 8192 -> 1024 plane (d_in past one cluster of one group a warp) and
    # a 32768 -> 1024 one (past 16 splits of two groups a warp)
    from biogpt_tpu_torch.ops.qmatmul_kernels import stream_plan

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, d_in, d_out, *_ in GEMV_ODD_WIDTHS + (("wide", 8192, 1024),
                                                    ("wide", 32768, 1024)):
        for fmt in FORMATS:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            worst = {}
            for M in WIDE_ROWS:
                _, err, tol = hold_wide(
                    c, qt, M, f"qmatmul_wide {d_in} -> {d_out} M={M} {fmt}")
                worst[M] = err / tol
            c.formats.setdefault("qmatmul_wide", set()).add(fmt)
            print(json.dumps({"qmatmul_wide_width": name,
                              "shape": f"{d_in} -> {d_out}",
                              "plan_by_m": {M: stream_plan(M, d_in, d_out,
                                                           n_sm)
                                            for M in WIDE_ROWS},
                              "format": fmt, "err_over_tol_by_m": worst}),
                  flush=True)


def phase_b1_gemv_kernels(c: Ctx) -> None:
    """The B=1 step's projection alone (``decode_gemv_b1``: the M=1 GEMV
    with the X' numerics, its LayerNorm prologue computed in each block,
    and its bias, GELU or residual epilogue) at each 347M projection
    shape, in every format, against its plain version (:func:`held_gemv`),
    timed beside its bound and the one-call yardstick ``x_bf16 @
    dequantize(W, bf16)`` (timed only; the port never calls it), the L2
    flushed before each call; then held, untimed, at the widths of
    ``GEMV_ODD_WIDTHS``, whose split-K slices are uneven."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.decode_kernels import (decode_gemv_b1,
                                                     decode_gemv_b1_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import (gemv_cost,
                                                      projection_shape)

    cfg, dev = c.cfg, c.dev
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for fmt in FORMATS:
        for name, ln, act, resid in GEMV_SHAPES:
            d_in, d_out = projection_shape(cfg, name)
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            held, kw, x = held_gemv(c, qt, d_in, d_out, ln, act, resid, 1,
                                    f"decode_gemv_b1 {name} {fmt}")
            rec = {"kernel": "decode_gemv_b1", "projection": name,
                   "shape": f"{d_in} -> {d_out}", "m": 1, "format": fmt,
                   **held}

            def lib_call():
                return x.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
            nbytes, flops, _ = gemv_cost(cfg, name, 1, fmt)
            timed(rec, lambda: decode_gemv_b1(x, qt, **kw),
                  lambda: decode_gemv_b1_plain(x, qt, **kw), lib_call,
                  nbytes, flops, reps=50, plain_reps=5, flush=flush)
            if (fmt, name) == ("q4_0", "fc1"):
                c.results["decode_gemv_b1"] = rec
            c.emit(rec)
    del flush_buf
    for name, d_in, d_out, ln, act, resid in GEMV_ODD_WIDTHS:
        for fmt in FORMATS:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            held, _, _ = held_gemv(
                c, qt, d_in, d_out, ln, act, resid, 1,
                f"decode_gemv_b1 {name} {d_in} -> {d_out} {fmt}")
            print(json.dumps({"decode_gemv_b1_odd_width": name,
                              "shape": f"{d_in} -> {d_out}",
                              "splits": -(-d_in // 256), "format": fmt,
                              "err_over_row_tol":
                              held["max_abs_err"] / held["row_tol_max"]}),
                  flush=True)


# ------------------------------ 5d. the refill kernel's GEMM alone

# the refill kernel's four GEMMs: (projection, epilogue)
PREFILL_GEMMS = (("qkv", "qkv"), ("o", "resid"), ("fc1", "gelu"),
                 ("fc2", "resid"))
# the rows they take: the 32 x 32 and 8 x 128 waves, one 512-token prompt
# (timed at 1024), and uneven counts: a part-filled 128-row tile, a
# 9-token prompt padded to 8 x 9, one small group
PREFILL_GEMM_ROWS = (1024, 512, 200, 72, 8)
# (projection, epilogue, d_in, d_out) at widths 256 does not divide, which
# take 128-column tiles in every epilogue (d_model 384 and 640)
PREFILL_GEMM_ODD_WIDTHS = (("qkv", "qkv", 384, 1152), ("o", "resid", 384, 384),
                           ("fc1", "gelu", 640, 1920), ("qkv", "qkv", 640, 1920))
# a narrower model whose qkv width (3 x 384) 256 does not divide: (d_model,
# heads, d_ff, layers), held through the whole refill kernel (d_ff 2048:
# the layer gate takes d_in past 1024 in whole 1024-row chunks)
PREFILL_ODD_MODEL = (384, 6, 2048, 2)


def held_prefill_gemm(c: Ctx, qt, epi: str, M: int, what: str):
    """``prefill_gemm`` at M rows on random inputs against its plain version
    -> (record of the hold, the call's arguments). The two sum the same
    exact products in other orders: f32 outputs within 1e-5 of the
    product's magnitude (``tol``); bf16 outputs within that (times the q
    scale, or GELU's largest slope), plus, for each element whose plain
    f32 value lies within that of a bf16 rounding boundary (so the two
    may round to neighbouring values), the gap between those neighbours."""
    from biogpt_tpu_torch.ops.prefill_kernels import (prefill_gemm,
                                                      prefill_gemm_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import qmatmul_wide_plain

    d_in, d_out = qt.d_in, qt.d_out
    a = c.randn(M, d_in).to(torch.bfloat16)
    kw = dict(epi=epi, x=c.randn(M, d_out) if epi == "resid" else None,
              scale=0.125 if epi == "qkv" else None)
    bias = 0.02 * c.randn(d_out)
    got = prefill_gemm(a, qt, bias, **kw)
    want = prefill_gemm_plain(a, qt, bias, **kw)
    y = qmatmul_wide_plain(a, qt)
    torch.cuda.synchronize()
    tol = 1e-5 * y.abs().max().item() + 1e-5
    # the plain version's f32 values before their bf16 rounding
    yb = y + bias
    if epi == "qkv":
        D = d_out // 3
        pairs, scales = zip(got, want), (0.125, 1.0, 1.0)
        pre = (yb[:, :D] * 0.125, yb[:, D:2 * D], yb[:, 2 * D:])
    elif epi == "gelu":
        pairs, scales = [(got, want)], (GELU_SLOPE,)
        pre = (torch.nn.functional.gelu(yb),)
    else:
        pairs, scales, pre = [(got, want)], (1.0,), (None,)
    worst = 0.0
    for (g, w), sc, v in zip(pairs, scales, pre):
        g, w = g.float(), w.float()
        lim = tol * sc
        if v is not None:
            lo = (v - lim).to(torch.bfloat16).float()
            hi = (v + lim).to(torch.bfloat16).float()
            lim = lim + (hi - lo).abs()
        ratio = ((g - w).abs() / lim).max().item()
        check(ratio <= 1 and bool(torch.isfinite(g).all()),
              f"{what}: error {ratio} of its limit")
        worst = max(worst, ratio)
    rec = {"max_abs_err": max((g.float() - w.float()).abs().max().item()
                              for g, w in (zip(got, want) if epi == "qkv"
                                           else [(got, want)])),
           "tol": tol, "err_over_limit": worst}
    return rec, (a, bias, kw)


def phase_prefill_gemm_kernels(c: Ctx) -> None:
    """The refill kernel's GEMM alone (``prefill_gemm``: the wgmma GEMM with
    its qkv, residual or GELU epilogue) at each 347M projection, at the
    rows of ``PREFILL_GEMM_ROWS``, in every format, against its plain
    version (:func:`held_prefill_gemm`); at 1024 rows timed beside its
    bound and the one-call yardstick ``a_bf16 @ dequantize(W, bf16)``
    (timed only; the port never calls it), the L2 flushed before each
    call."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.prefill_kernels import (prefill_gemm,
                                                      prefill_gemm_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import (prefill_gemm_cost,
                                                      projection_shape)

    cfg, dev = c.cfg, c.dev
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    for fmt in FORMATS:
        for name, epi in PREFILL_GEMMS:
            qt = c.rand_qt(*projection_shape(cfg, name), fmt=fmt)
            for M in PREFILL_GEMM_ROWS:
                held, (a, bias, kw) = held_prefill_gemm(
                    c, qt, epi, M, f"prefill_gemm {name} M={M} {fmt}")
                rec = {"kernel": "prefill_gemm", "projection": name,
                       "epi": epi, "shape": f"{qt.d_in} -> {qt.d_out}",
                       "m": M, "format": fmt, **held}
                if M == 1024:
                    def lib_call():
                        return a @ dequantize(qt, torch.bfloat16)
                    nbytes, flops = prefill_gemm_cost(cfg, name, M, fmt)
                    timed(rec, lambda: prefill_gemm(a, qt, bias, **kw),
                          lambda: prefill_gemm_plain(a, qt, bias, **kw),
                          lib_call, nbytes, flops, reps=50, plain_reps=5,
                          flush=flush)
                    if (fmt, name) == ("q4_0", "fc2"):
                        c.results["prefill_gemm"] = rec
                    c.emit(rec)
                else:
                    c.formats.setdefault("prefill_gemm", set()).add(fmt)
                    print(json.dumps(rec), flush=True)
    del flush_buf
    for name, epi, d_in, d_out in PREFILL_GEMM_ODD_WIDTHS:
        for fmt in FORMATS:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            worst = {}
            for M in (1024, 72, 8):
                held, _ = held_prefill_gemm(
                    c, qt, epi, M,
                    f"prefill_gemm {name} {d_in} -> {d_out} M={M} {fmt}")
                worst[M] = held["err_over_limit"]
            print(json.dumps({"prefill_gemm_odd_width": name, "epi": epi,
                              "shape": f"{d_in} -> {d_out}", "format": fmt,
                              "err_over_limit_by_m": worst}), flush=True)
    hold_prefill_odd_model(c)


def hold_prefill_odd_model(c: Ctx) -> None:
    """``prefill_fused`` on random layers of ``PREFILL_ODD_MODEL`` at 4 x 32
    rows against its plain version, at the limits of the 347M holds
    (:func:`hidden_within`, :func:`rows_within`), on the models those
    limits were set on: random Q4_0 (Q4_1 for the formats with mins)
    planes, and for the other formats the same weights re-quantized
    (``requantize``, as ``phase_format_kernels`` holds them), after the
    Q4 planes re-encoded exactly in the format gave the Q4 kernel's
    results bit for bit."""
    from biogpt_tpu_torch.ops.prefill_kernels import (prefill_fused,
                                                      prefill_fused_plain)

    D, H, F, L = PREFILL_ODD_MODEL
    R, T = 4, 32
    eps = c.cfg.ln_eps
    for fmt in FORMATS:
        mins = fmt.endswith("_1")
        src = {n: {"w": 1 + 0.1 * c.randn(L, D), "b": 0.1 * c.randn(L, D)}
               for n in ("ln0", "ln1")}
        for name, d_in, d_out in (("qkv", D, 3 * D), ("o", D, D),
                                  ("fc1", D, F), ("fc2", F, D)):
            src[name] = {"w": c.rand_qt(d_in, d_out, (L,), mins),
                         "b": 0.02 * c.randn(L, d_out)}
        x0 = c.randn(R * T, D)

        def run(layers):
            return prefill_fused(x0, layers, rows=R, padded=T, n_head=H,
                                 ln_eps=eps)
        what = f"prefill_fused d_model {D} {R}x{T} {fmt}"
        rec = {"prefill_fused_odd_model": D, "heads": H, "d_ff": F,
               "layers": L, "R": R, "T": T, "format": fmt}
        layers = src
        if fmt not in ("q4_0", "q4_1"):
            a = run(src)
            b = run(with_weights(src, lambda qt: reencode(qt, fmt)))
            torch.cuda.synchronize()
            rec["reencoded_bit_equal"] = all(bool(torch.equal(u, v))
                                             for u, v in zip(a, b))
            check(rec["reencoded_bit_equal"],
                  f"{what}: re-encoded Q4 planes not bit-equal to the Q4 "
                  f"kernel (x differs by {(a[0] - b[0]).abs().max().item()})")
            layers = with_weights(src, lambda qt: requantize(qt, fmt))
        x, kr, vr = run(layers)
        xp, krp, vrp = prefill_fused_plain(x0, layers, rows=R, padded=T,
                                           n_head=H, ln_eps=eps)
        torch.cuda.synchronize()
        rec.update(max_abs_err=hidden_within(x, xp, what),
                   tol=3e-3 * xp.abs().max().item(),
                   rows_err_over_tol=max(rows_within(kr, krp, what + " k"),
                                         rows_within(vr, vrp, what + " v")))
        print(json.dumps(rec), flush=True)


# ------------------------------------ 6. the Q5_0, Q5_1 and Q8_0 kernels

def hold_equivalence(c: Ctx, src, same, fmt: str) -> None:
    """The CUDA steps on the Q4 planes ``src`` and on ``same``, their exact
    re-encoding in ``fmt``: bit-equal through the dequant-then-dot chains
    (the batched and paged steps at B=32, ``prefill_fused`` 32 x 32),
    where a level is (level - offset) * scale in every format, and for
    Q5_1 (Q4_1's levels, offset and mins unchanged) through the X' B=1
    step too."""
    from biogpt_tpu_torch.ops.decode_kernels import decode_step_fused
    from biogpt_tpu_torch.ops.prefill_kernels import prefill_fused

    cfg, dev = c.cfg, c.dev
    D, H, S = cfg.d_model, cfg.n_head, cfg.n_positions
    L = src["qkv"]["w"].levels.shape[0]
    past = torch.tensor(ragged_past(32, dead=(7, 19)), dtype=torch.int32,
                        device=dev)
    kc = c.randn(L, 32, S, D).to(torch.bfloat16)
    vc = c.randn(L, 32, S, D).to(torch.bfloat16)
    x32, x1 = c.randn(32, D), c.randn(1, D)
    x0, _ = padded_prompts(c, 32, 32)
    runs = {
        "batched B=32": lambda lyr: decode_step_fused(
            x32, lyr, kc, vc, past, n_head=H, window=512, ln_eps=cfg.ln_eps),
        "paged B=32": lambda lyr: decode_step_fused(
            x32, lyr, kc, vc, past, n_head=H, window=512, ln_eps=cfg.ln_eps,
            per_slot_kv=True),
        "prefill 32x32": lambda lyr: prefill_fused(
            x0, lyr, rows=32, padded=32, n_head=H, ln_eps=cfg.ln_eps)}
    if fmt == "q5_1":
        runs["B=1"] = lambda lyr: decode_step_fused(
            x1, lyr, kc[:, :1].contiguous(), vc[:, :1].contiguous(), 100,
            n_head=H, window=128, ln_eps=cfg.ln_eps)
    rec = {"equivalence": f"{fmt} re-encoded Q4 planes vs the Q4 kernels",
           "format": fmt}
    for name, run in runs.items():
        a, b = run(src), run(same)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(u, v)) for u, v in zip(a, b))
        check(equal, f"{fmt} re-encoded Q4 planes, {name}: not bit-equal to "
              f"the Q4 kernels (x differs by "
              f"{(a[0] - b[0]).abs().max().item()})")
        rec[name] = equal
    print(json.dumps(rec), flush=True)


def phase_format_kernels(c: Ctx, fmt: str) -> None:
    """Every kernel that reads weights, in format ``fmt``, against its plain
    version at 347M shapes with the Q4 rows' limits, and timed beside its
    bound (and, for the GEMVs and tails, a one-call yardstick): the GEMVs
    at every projection shape (m = 1, 8, 16, 32), ``lm_head_argmax`` at
    m = 1 and both tails at M = 32, the B=1 and batched steps (bf16 and
    int8 KV), the paged steps (bf16 and int8), the staged step (step 7 of
    16) and ``prefill_fused`` (32 x 32, and 8 x 128 held only); the steps
    and the refill ``FORMAT_DEPTH`` layers deep."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.decode_kernels import (
        decode_step_fused, decode_step_fused_batched_plain,
        decode_step_fused_paged_plain, decode_step_fused_plain,
        decode_step_fused_staged_plain)
    from biogpt_tpu_torch.ops.prefill_kernels import (prefill_fused,
                                                      prefill_fused_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        lm_head_argmax, lm_head_argmax_plain, qmatmul, qmatmul_plain,
        qmatmul_wide, qmatmul_wide_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import (bf16_step_cost,
                                                      int8_step_cost,
                                                      prefill_cost)

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, F, H, S = cfg.d_model, cfg.d_ff, cfg.n_head, cfg.n_positions
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def keep(name, rec):
        c.fmt_results[(name, fmt)] = rec
        c.emit(rec)

    # the GEMVs: f32 summation order only, 1e-5 of the output's magnitude
    for name, d_in, d_out in (("qkv", D, 3 * D), ("o", D, D), ("fc1", D, F),
                              ("fc2", F, D), ("lm_head", D, V_PAD)):
        qt = c.rand_qt(d_in, d_out, fmt=fmt)
        for m, kern, plain, kname in (
                (1, qmatmul, qmatmul_plain, "qmatmul"),
                (8, qmatmul, qmatmul_plain, "qmatmul"),
                *((m, qmatmul_wide, qmatmul_wide_plain, "qmatmul_wide")
                  for m in WIDE_ROWS)):
            what = f"{kname} {name} m={m} {fmt}"
            if kname == "qmatmul_wide":
                x, err, tol = hold_wide(c, qt, m, what)
            else:
                x = c.randn(m, d_in)
                y = kern(x, qt)
                ref = plain(x, qt)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = 1e-5 * ref.abs().max().item() + 1e-5
                check(err <= tol and bool(torch.isfinite(y).all()),
                      f"{what}: err {err} > {tol}")
            c.formats.setdefault(kname, set()).add(fmt)
            if (kname, name, m) not in (("qmatmul", "lm_head", 1),
                                        ("qmatmul_wide", "fc1", 32),
                                        ("qmatmul_wide", "lm_head", 16),
                                        ("qmatmul_wide", "lm_head", 32)):
                continue
            rec = {"kernel": kname, "shape": name, "m": m, "format": fmt,
                   "max_abs_err": err, "tol": tol}

            def lib_call():
                return x.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
            timed(rec, lambda: kern(x, qt), lambda: plain(x, qt), lib_call,
                  qbytes(qt) + x.numel() * 4 + m * d_out * 4,
                  2 * m * d_in * d_out, reps=50, plain_reps=5, flush=flush)
            if name == "fc1":
                keep(kname, rec)
            else:
                c.emit(rec)

    # lm_head_argmax at m = 1; the tails (and the argmax) at M = 32
    qt = c.rand_qt(D, V_PAD, fmt=fmt)
    lnw = 1 + 0.1 * c.randn(D)
    lnb = 0.1 * c.randn(D)
    x = c.randn(1, D)
    ids, mv = lm_head_argmax(x, lnw, lnb, qt, cfg.n_vocab, cfg.ln_eps)
    what = f"lm_head_argmax {fmt}"
    exp = lm_head_expect(x, lnw, lnb, qt, cfg.ln_eps, what)
    torch.cuda.synchronize()
    err, decided = tail_ids_within(ids, mv, exp, cfg.n_vocab, what)
    rec = {"kernel": "lm_head_argmax", "m": 1, "format": fmt,
           "max_abs_err": err, "tol": exp["tol"],
           "row_tol": exp["row_tol"].tolist(), "ids_decided": decided,
           "ln_flips": exp["flips"]}

    def argmax_lib():
        xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
        logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
        return torch.argmax(logits[:, :cfg.n_vocab], dim=-1)
    timed(rec, lambda: lm_head_argmax(x, lnw, lnb, qt, cfg.n_vocab,
                                      cfg.ln_eps),
          lambda: lm_head_argmax_plain(x, lnw, lnb, qt, cfg.n_vocab,
                                       cfg.ln_eps),
          argmax_lib, qbytes(qt) + D * 4 + 2 * D * 4 + 8, 2 * D * V_PAD,
          reps=50, plain_reps=5, flush=flush)
    keep("lm_head_argmax", rec)
    hold_small_tails(c, qt, lnw, lnb, fmt)
    hold_tails(c, qt, lnw, lnb, 8, fmt)
    for name, rec in hold_tails(c, qt, lnw, lnb, 32, fmt).items():
        c.fmt_results[(name, fmt)] = rec
    del flush_buf, qt

    # the steps over 24 layers on the Q4 rows' random model re-quantized
    # to fmt: the hidden state's limit, 3e-3 of its magnitude, was set on
    # that model, whose residual stream grows with the weights' mean (the
    # random Q4_0 levels average -0.5); random Q8_0 levels, mean ~0, left
    # it 3.5-4.6 times smaller at the same absolute error (chip run, see
    # PERF.md). The same Q4 planes re-encoded exactly must give the Q4
    # kernels' results bit for bit where the numerics are the same.
    L = FORMAT_DEPTH
    cfg = dataclasses.replace(cfg, n_layer=L)   # the bounds' depth
    src, _ = c.rand_layers(mins=fmt.endswith("_1"), n_layer=L)
    hold_equivalence(c, src, with_weights(src, lambda qt: reencode(qt, fmt)),
                     fmt)
    layers = with_weights(src, lambda qt: requantize(qt, fmt))
    wbytes = layers_bytes(layers)
    del src
    W = 512
    past32 = ragged_past(32, dead=(7, 19))
    pt32 = torch.tensor(past32, dtype=torch.int32, device=dev)
    for quant in (False, True):
        sfx = "_int8" if quant else ""
        for B in (1, 32):
            if quant:
                kc, ks = rand_int8_cache(c, L, B, S)
                vc, vs = rand_int8_cache(c, L, B, S)
                scales = dict(k_scales=ks, v_scales=vs)
            else:
                kc = c.randn(L, B, S, D).to(torch.bfloat16)
                vc = c.randn(L, B, S, D).to(torch.bfloat16)
                scales = {}
            x0 = c.randn(B, D)
            cost = int8_step_cost if quant else bf16_step_cost
            if B == 1:   # the single stream: past 100 (timed, traced), 900
                name = "decode_step_fused" + sfx
                for past, window in ((100, 128), (900, 1024)):
                    run = lambda: decode_step_fused(
                        x0, layers, kc, vc, past, n_head=H, window=window,
                        ln_eps=cfg.ln_eps, **scales)
                    plain = lambda: decode_step_fused_plain(
                        x0, layers, kc, vc, past, n_head=H, window=window,
                        ln_eps=cfg.ln_eps, **scales)
                    what = f"{name} B=1 past={past} {fmt}"
                    rec = {"kernel": name, "layers": L, "past": past,
                           "window": window, "format": fmt}
                    held_step(run, plain, what, rec, int8=quant)
                    if past == 100:
                        timed(rec, run, plain, None,
                              *cost(cfg, [past], window, wbytes))
                        rec["trace"] = b1_trace(run, L, what)["span_ms"]
                        keep(name, rec)
                    else:
                        c.emit(rec)
                del kc, vc, scales
                continue
            # B=32 ragged, window 512: batched, then paged
            for name, paged, plain_step in (
                    ("decode_step_fused_batched" + sfx, False,
                     decode_step_fused_batched_plain),
                    ("decode_step_fused_paged" + sfx, True,
                     decode_step_fused_paged_plain)):
                run = lambda: decode_step_fused(
                    x0, layers, kc, vc, pt32, n_head=H, window=W,
                    ln_eps=cfg.ln_eps, per_slot_kv=paged, **scales)
                plain = lambda: plain_step(
                    x0, layers, kc, vc, pt32, n_head=H, window=W,
                    ln_eps=cfg.ln_eps, **scales)
                rec = {"kernel": name, "layers": L, "B": 32, "past": past32,
                       "window": W, "format": fmt}
                held_step(run, plain, f"{name} B=32 {fmt}", rec, int8=quant)
                gemv_trace(run, L, f"{name} B=32 {fmt}")
                timed(rec, run, plain, None, *cost(cfg, past32, W, wbytes))
                keep(name, rec)
            del kc, vc, scales

    # the staged step: step 7 of a 16-row chunk
    B, C, step_i = 32, 16, 7
    kc = c.randn(L, B, S, D).to(torch.bfloat16)
    vc = c.randn(L, B, S, D).to(torch.bfloat16)
    k_st = c.randn(L, B, C, D).to(torch.bfloat16)
    v_st = c.randn(L, B, C, D).to(torch.bfloat16)
    x0 = c.randn(B, D)
    past = [p + step_i for p in past32]
    pt = torch.tensor(past, dtype=torch.int32, device=dev)
    run = lambda: decode_step_fused(
        x0, layers, kc, vc, pt, n_head=H, window=W, ln_eps=cfg.ln_eps,
        k_stage=k_st, v_stage=v_st, step_i=step_i)
    plain = lambda: decode_step_fused_staged_plain(
        x0, layers, kc, vc, pt, k_st, v_st, step_i, n_head=H, window=W,
        ln_eps=cfg.ln_eps)
    rec = {"kernel": "decode_step_fused_staged", "layers": L, "B": B,
           "past": past, "window": W, "stage_rows": C, "step_i": step_i,
           "format": fmt}
    held_step(run, plain, f"decode_step_fused_staged step_i={step_i} {fmt}",
              rec)
    gemv_trace(run, L, f"staged B=32 step 7 {fmt}")
    timed(rec, run, plain, None,
          *bf16_step_cost(cfg, past, W, wbytes, step_i))
    keep("decode_step_fused_staged", rec)
    del kc, vc, k_st, v_st

    # prefill_fused: the uniform refill wave (timed) and the mixed one
    for R, T in ((32, 32), (8, 128)):
        x0, lens = padded_prompts(c, R, T)
        run = lambda: prefill_fused(x0, layers, rows=R, padded=T, n_head=H,
                                    ln_eps=cfg.ln_eps)
        plain = lambda: prefill_fused_plain(x0, layers, rows=R, padded=T,
                                            n_head=H, ln_eps=cfg.ln_eps)
        rec = {"kernel": "prefill_fused", "layers": L, "R": R, "T": T,
               "lengths": lens, "format": fmt}
        held_step(run, plain, f"prefill_fused {R}x{T} {fmt}", rec)
        if (R, T) == (32, 32):
            timed(rec, run, plain, None, *prefill_cost(cfg, R, T, wbytes),
                  reps=10)
            c.fmt_results[("prefill_fused", fmt)] = rec
        c.emit(rec)
    del layers


# ------------------------------------------------- 7. single stream, e2e

def teacher_forced_single(c: Ctx, eng, prompt: list, steps: int,
                          fmt: str) -> None:
    """``steps`` teacher-forced B=1 decode steps after ``prompt``: the
    kernels (the fused step, ``lm_head_argmax``) against the plain path on
    the engine's own weights, the plain rows committed."""
    from biogpt_tpu_torch.ops import embedding_lookup
    from biogpt_tpu_torch.ops.decode_kernels import (decode_step_fused,
                                                     decode_step_fused_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        layer_norm_bf16, lm_head_argmax, xprime_logits)

    cfg, dev = c.cfg, c.dev
    D, H = cfg.d_model, cfg.n_head
    cache = eng.new_cache()
    logits, cache, past = eng.prefill(cache, prompt)
    tok = torch.argmax(logits, -1).reshape(1, 1)
    P = eng.params
    worst = 0.0
    for step in range(steps):
        emb = embedding_lookup(tok, P["embed_tokens"]) * math.sqrt(D)
        pos = torch.full((1, 1), past + cfg.pos_offset, device=dev)
        x0 = (emb + embedding_lookup(pos, P["embed_positions"])).reshape(1, D)
        window = eng._window(past + 1)
        xk, krk, vrk = decode_step_fused(x0, P["layers"], cache.k, cache.v,
                                         past, n_head=H, window=window,
                                         ln_eps=cfg.ln_eps)
        xp, krp, vrp = decode_step_fused_plain(
            x0, P["layers"], cache.k, cache.v, past, n_head=H, window=window,
            ln_eps=cfg.ln_eps)
        idk, _ = lm_head_argmax(xk, P["final_ln"]["w"], P["final_ln"]["b"],
                                P["lm_head"], cfg.n_vocab, cfg.ln_eps)
        lp = xprime_logits(layer_norm_bf16(xp, P["final_ln"]["w"],
                                           P["final_ln"]["b"], cfg.ln_eps),
                           P["lm_head"])[0, :cfg.n_vocab]
        top2 = torch.topk(lp, 2).values
        what = f"teacher-forced {fmt} step {step}"
        err = hidden_within(xk, xp, what)
        worst = max(worst, err / max(3e-3 * xp.abs().max().item(), 1e-30),
                    rows_within(krk, krp, what + " k"),
                    rows_within(vrk, vrp, what + " v"))
        gap = (top2[0] - top2[1]).item()
        if gap > 2e-2 * lp.abs().max().item():
            check(int(idk[0]) == int(torch.argmax(lp)),
                  f"{what}: argmax {int(idk[0])} vs {int(torch.argmax(lp))} "
                  f"(gap {gap})")
        cache.k[:, :, past] = krp
        cache.v[:, :, past] = vrp
        tok = torch.argmax(lp).reshape(1, 1)
        past += 1
    log(f"teacher-forced {fmt}, {steps} steps: worst err/tol {worst:.3f}")


def phase_cli(c: Ctx, path: str, smi: str) -> None:
    from biogpt_tpu_torch.cli import main as cli_main
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs

    runs = [["-p", "cells", "--temp", "0"],                    # 6 tokens
            ["-p", "tumour cells grow", "--temp", "0"],        # 16
            ["-p", "the protein binds the receptor in the membrane of "
                   "tumour cells", "--temp", "0"],             # 45
            ["-p", "the protein binds the receptor", "--temp", "0.9",
             "-s", "1"]]                                       # 9-32
    cuda_lib.reset_launch_counts()
    for argv in runs:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["-m", path, "-n", "128", "--no-stop-at-eos", *argv])
        text = out.getvalue().strip()
        log(f"cli {argv}: rc={rc} {time.perf_counter() - t0:.1f} s, "
            f"{len(text)} chars of text")
        check(rc == 0 and len(text) > 0, f"cli {argv} rc={rc}")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"single-stream path launches: {launches}")
    single = ("qmatmul", "qmatmul_wide", "lm_head_argmax",
              "decode_step_fused", "decode_gemv_b1", "kv_commit")
    for k in single:
        check(launches[k] > 0, f"kernel {k} was not launched on its path")
    check(launches["decode_gemv_b1"] == 4 * c.cfg.n_layer
          * launches["decode_step_fused"],
          f"single stream: {launches['decode_gemv_b1']} M=1 GEMVs for "
          f"{launches['decode_step_fused']} steps")
    count_route(c, launches, single, "q4_0")

    # the int8 KV cache: CLI --kv-quant greedy, 128 new tokens
    cuda_lib.reset_launch_counts()
    out = io.StringIO()
    argv = ["-p", "the protein binds the receptor", "--temp", "0",
            "--kv-quant"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["-m", path, "-n", "128", "--no-stop-at-eos", *argv])
    text = out.getvalue().strip()
    log(f"cli {argv}: rc={rc} {time.perf_counter() - t0:.1f} s, "
        f"{len(text)} chars of text")
    check(rc == 0 and len(text) > 0, f"cli {argv} rc={rc}")
    launches = dict(cuda_lib.LAUNCHES)
    log(f"single-stream int8 path launches: {launches}")
    int8_single = ("decode_step_fused_int8", "lm_head_argmax",
                   "decode_gemv_b1", "kv_commit_quant_rows")
    for k in int8_single:
        check(launches[k] > 0, f"kernel {k} was not launched on the "
              "--kv-quant path")
    check(launches["kv_commit_quant_rows"]
          == launches["decode_step_fused_int8"],
          f"--kv-quant: {launches['kv_commit_quant_rows']} commits for "
          f"{launches['decode_step_fused_int8']} steps")
    count_route(c, launches, int8_single, "q4_0")
    check(launches["decode_step_fused"] == 0,
          "--kv-quant ran the bf16 decode step")
    config, _, _, params = load_params(path, device="cuda")

    # teacher-forced decode: kernels vs the plain path on the engine's weights
    eng = Engine(config, params, device="cuda")
    prompt = [2] + list(range(40, 52))
    teacher_forced_single(c, eng, prompt, 8, "q4_0")

    commit_traces(c, Engine(config, params, kv_quant=True,
                            device="cuda").params, config)

    # decode rate of a 128-token greedy generation, bf16 and int8 KV, on
    # one warm engine: its generations 1-2 run the chunks eagerly, the 3rd
    # captures them, the 4th (the rate) only replays
    g = GenerationParams(n_predict=128, temp=0.0, stop_at_eos=False, seed=0)
    for kv_quant in (False, True):
        e = eng if not kv_quant else Engine(config, params, kv_quant=True,
                                            device="cuda")
        per_gen = [e.generate(prompt, g)
                   for _ in range(ChunkGraphs.EAGER_RUNS + 2)]
        res = per_gen[-1]
        ms = res.timings["ms_per_token"]
        step = c.results["decode_step_fused_int8" if kv_quant
                         else "decode_step_fused"]
        print(json.dumps({"decode_ms_per_token": ms, "tokens_per_s": 1e3 / ms,
                          "engine": "warm, every chunk a graph replay",
                          "ms_per_token_by_generation": [
                              r.timings["ms_per_token"] for r in per_gen],
                          "kv_cache": "int8" if kv_quant else "bf16",
                          "new_tokens": res.timings["n_new"],
                          "step_device_ms_past_100": step["kernel_ms"],
                          "step_host_ms_past_100": step["kernel_host_ms"],
                          "card": torch.cuda.get_device_name(0),
                          "card_stamp": smi}), flush=True)
        check(res.timings["n_new"] == 128, "greedy generation stopped early")


def commit_traces(c: Ctx, P: dict, config) -> None:
    """The int8 steps' commit on their paths: one greedy step
    (``forward_fused_decode_greedy``) of the lockstep and the paged step at
    B=32 (positions on the device) and of the single stream (B=1, the
    host's position) on an int8 cache, traced: one launch of
    ``kv_commit_quant_rows_kernel``, after the step's last GEMV; no
    ``kv_commit_quant_kernel``, and no PyTorch kernel after the step's first
    GEMV (none of ``quantize_rows``' elementwise launches)."""
    from biogpt_tpu_torch.models.biogpt import forward_fused_decode_greedy
    from biogpt_tpu_torch.runtime.cache import init_cache

    for B, per_slot, what in ((32, False, "lockstep"), (32, True, "paged"),
                              (1, False, "single stream")):
        cache = init_cache(config, batch=B, max_len=512, dtype=torch.int8,
                           device=c.dev)
        toks = torch.randint(4, config.n_vocab - 2, (B, 1), generator=c.gen,
                             device=c.dev)
        past = (torch.randint(8, 73, (B,), generator=c.gen, device=c.dev,
                              dtype=torch.int32) if B > 1 else 100)
        # a trace short of the step's GEMV or commit records (the wrapper
        # counts its own) is taken again, up to three times
        for _ in range(3):
            seq: list = []
            launches: dict = {}
            kernel_trace(lambda: forward_fused_decode_greedy(
                P, toks, cache, past, config, kv_window=128,
                per_slot_kv=per_slot), seq, counted=launches)
            names = [n for n, _, _ in seq if "spin_kernel" not in n]
            gemvs = [i for i, n in enumerate(names)  # the step's, not the tail's
                     if "qgemv_b1_kernel" in n or "qgemv_mma_kernel" in n]
            commits = [i for i, n in enumerate(names)
                       if "kv_commit_quant_rows_kernel" in n]
            n_gemv = launches.get("decode_gemv", 0) + launches.get(
                "decode_gemv_b1", 0)
            if len(gemvs) >= n_gemv and len(commits) >= launches.get(
                    "kv_commit_quant_rows", 0):
                break
        torch_after = [n for n in names[gemvs[0]:] if "at::" in n] \
            if gemvs else names
        ok = (len(commits) == 1 and bool(gemvs) and commits[0] > gemvs[-1]
              and not torch_after
              and not any("kv_commit_quant_kernel" in n for n in names))
        check(ok, f"int8 {what} step B={B}: the commit's launches "
              f"{[n[:60] for n in names[gemvs[-1] if gemvs else 0:]]}")
        print(json.dumps({"commit_trace": what, "B": B,
                          "after_last_gemv": [n[:80] for n in
                                              names[gemvs[-1] + 1:]]
                          if gemvs else names,
                          "torch_kernels_after_first_gemv": len(torch_after)}),
              flush=True)
        del cache


# -------------------------------------------------------- 8. serving, e2e

# kernels each serving path must launch: bf16 KV, int8 KV
SERVING_KERNELS = {
    False: ("decode_step_fused_batched", "decode_gemv", "batched_attention",
            "kv_commit", "lm_head_argmax_commit",
            "lm_head_logits_gmax_commit", "prefill_fused", "prefill_gemm"),
    True: ("decode_step_fused_batched_int8", "decode_gemv",
           "batched_attention", "kv_commit_quant_rows", "prefill_fused",
           "prefill_gemm", "lm_head_argmax", "qmatmul_wide"),
}


def span_meter(eng) -> dict:
    """Record CUDA events around every refill group and decode chunk that
    ``eng.serve`` enqueues (instance attributes wrapping its methods;
    ``del`` them to restore) -> {"refill": [...], "chunk": [...]} of
    (start, end) event pairs."""
    spans = {"refill": [], "chunk": []}

    def wrap(name, key):
        real = getattr(eng, name)

        def timed_call(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real(*a, **k)
            e.record()
            spans[key].append((s, e))
            return out
        setattr(eng, name, timed_call)
    wrap("_prefill_group", "refill")
    wrap("_run_chunk", "chunk")
    return spans


def http_round(srv, rng, V: int) -> tuple:
    """8 concurrent /generate requests (half greedy, half temp 0.9 / top-k
    40 / top-p 0.9; prompts of 5-25 and 100-124 tokens), one SSE stream and
    GET /stats -> (generated tokens, wall s, stats)."""
    import urllib.request

    base = f"http://{srv.host}:{srv.port}"
    bodies = []
    for i in range(8):
        n = int(rng.integers(5, 26) if i % 2 == 0 else rng.integers(100, 125))
        body = {"prompt_ids": [2] + rng.integers(4, V - 2, size=n - 1).tolist(),
                "n_predict": 48}
        if i >= 4:
            body.update(temp=0.9, top_k=40, top_p=0.9)
        bodies.append(body)
    out = [None] * 8

    def post(i):
        req = urllib.request.Request(
            f"{base}/generate", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        out[i] = json.loads(urllib.request.urlopen(req, timeout=300).read())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for i, r in enumerate(out):
        check(r is not None and len(r["new_ids"]) == 48
              and all(0 <= t < V for t in r["new_ids"]),
              f"http request {i}: {None if r is None else len(r['new_ids'])} "
              "new tokens")
    # one SSE stream
    sse = {"prompt_ids": [2, 40, 41, 42, 43], "n_predict": 16, "stream": True,
           "temp": 0.9, "top_k": 40, "top_p": 0.9}
    resp = urllib.request.urlopen(urllib.request.Request(
        f"{base}/generate", data=json.dumps(sse).encode(),
        headers={"Content-Type": "application/json"}), timeout=300)
    events = [json.loads(line[len(b"data: "):]) for line in
              resp.read().splitlines() if line.startswith(b"data: ")]
    streamed = [e["token_id"] for e in events if "token_id" in e]
    check(bool(events) and events[-1].get("done")
          and events[-1]["new_ids"] == streamed and len(streamed) == 16,
          f"SSE stream: {len(streamed)} tokens, last event {events[-1:]}")
    stats = json.loads(urllib.request.urlopen(f"{base}/stats",
                                              timeout=60).read())
    check(stats["batch_slots"] == 32 and stats["requests_completed"] >= 9,
          f"/stats: {stats}")
    return sum(len(r["new_ids"]) for r in out if r), wall, stats


def refill_and_teacher_forced(c: Ctx, eng, rng, kv_quant: bool, steps: int,
                              fmt: str) -> None:
    """One refill wave of the uniform serve's shape through the per-op
    forward and, on a bf16 cache, through the prefill kernel (its logits
    held to the per-op ones); then ``steps`` teacher-forced B=32 steps
    from that wave, the kernels against the plain path on the engine's
    own weights, committing with the plain commit."""
    from biogpt_tpu_torch.models.biogpt import forward, forward_prefill_fused
    from biogpt_tpu_torch.ops import embedding_lookup
    from biogpt_tpu_torch.ops.decode_kernels import (
        decode_step_fused, decode_step_fused_batched_plain, kv_commit_plain,
        kv_commit_quant_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import (lm_head_argmax,
                                                      lm_head_logits_plain)
    from biogpt_tpu_torch.runtime.cache import (init_cache, merge_rows,
                                                quantize_rows)

    P, cfg, dev, config = eng.params, c.cfg, c.dev, eng.config
    D, H, B, V = cfg.d_model, cfg.n_head, eng.B, config.n_vocab
    kv = "int8" if kv_quant else "bf16"
    # one refill wave of the uniform run's shape (32 prompts of 4-23
    # tokens padded to 32), through the prefill kernel and the per-op
    # forward (tests/test_pallas_prefill.py's limits)
    lens = [int(n) for n in rng.integers(4, 24, size=B)]
    ids = torch.zeros(B, 32, dtype=torch.long)
    for b, n in enumerate(lens):
        ids[b, :n] = torch.from_numpy(rng.integers(4, V - 2, size=n))
    ids = ids.to(dev)
    last = torch.tensor([n - 1 for n in lens], device=dev)
    small = init_cache(config, batch=B, max_len=32, dtype=eng.cache_dtype,
                       device=dev)
    logits, small = forward(P, ids, small, 0, config,
                            compute_dtype=torch.bfloat16, allow_kernels=False,
                            last_index=last)
    if not kv_quant:
        lk, _ = forward_prefill_fused(P, ids, config, last)
        top2 = torch.topk(logits, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2e-2 * logits.abs().amax(-1)
        same = (torch.argmax(lk, -1) == torch.argmax(logits, -1))[decided]
        lerr = (lk - logits).abs() - (0.35 + 5e-2 * logits.abs())
        check(bool(same.all()) and bool((lerr <= 0).all()),
              f"refill wave {fmt}: prefill kernel vs per-op logits: argmax "
              f"equal on {int(same.sum())}/{int(decided.sum())} decided rows, "
              f"worst "
              f"excess over rtol 5e-2 + atol 0.35: {lerr.max().item()}")
        print(json.dumps({"refill_logits_check": "prefill_fused vs per-op",
                          "format": fmt, "rows": B,
                          "decided_rows": int(decided.sum()),
                          "argmax_equal": int(same.sum()),
                          "max_abs_diff": (lk - logits).abs().max().item(),
                          "logits_max_abs": logits.abs().max().item()}),
              flush=True)

    # teacher-forced B=32 steps from that wave: kernels vs the plain path
    # on the engine's weights, committing with the plain commit
    cache = eng.new_cache()
    merge_rows(cache, small, torch.arange(B, device=dev),
               torch.arange(B, device=dev))
    tok = torch.argmax(logits, -1)
    past = torch.tensor(lens, dtype=torch.int32, device=dev)
    fw, fb = P["final_ln"]["w"], P["final_ln"]["b"]
    scales = (dict(k_scales=cache.ks, v_scales=cache.vs) if kv_quant
              else {})
    worst = 0.0
    for step in range(steps):
        emb = embedding_lookup(tok[:, None], P["embed_tokens"]) * math.sqrt(D)
        pos = (past.long() + config.pos_offset)[:, None]
        x0 = (emb + embedding_lookup(pos, P["embed_positions"])).reshape(B, D)
        window = 128
        xk, krk, vrk = decode_step_fused(x0, P["layers"], cache.k, cache.v,
                                         past, n_head=H, window=window,
                                         ln_eps=cfg.ln_eps, **scales)
        xp, krp, vrp = decode_step_fused_batched_plain(
            x0, P["layers"], cache.k, cache.v, past, n_head=H, window=window,
            ln_eps=cfg.ln_eps, **scales)
        idk, _ = lm_head_argmax(xk, fw, fb, P["lm_head"], V, cfg.ln_eps)
        lp = lm_head_logits_plain(xp, fw, fb, P["lm_head"], cfg.ln_eps)[:, :V]
        top2 = torch.topk(lp, 2).values
        what = f"teacher-forced B={B} {kv} KV {fmt} step {step}"
        err = hidden_within(xk, xp, what)
        worst = max(worst, err / max(3e-3 * xp.abs().max().item(), 1e-30),
                    rows_within(krk, krp, what + " k"),
                    rows_within(vrk, vrp, what + " v"))
        decided = (top2[:, 0] - top2[:, 1]) > 2e-2 * lp.abs().amax(-1)
        ref = torch.argmax(lp, -1)
        wrong = int(((idk.long() != ref) & decided).sum())
        check(wrong == 0, f"{what}: argmax differs on {wrong} decided rows")
        if kv_quant:
            kq, ksc = quantize_rows(krp)
            vq, vsc = quantize_rows(vrp)
            kv_commit_quant_plain(cache.k, cache.v, cache.ks, cache.vs,
                                  kq.transpose(0, 1), vq.transpose(0, 1),
                                  ksc.transpose(0, 1)[..., None],
                                  vsc.transpose(0, 1)[..., None], past)
        else:
            kv_commit_plain(cache.k, cache.v, krp.transpose(0, 1),
                            vrp.transpose(0, 1), past)
        tok = ref
        past = past + 1
    log(f"teacher-forced B={B} {kv} KV {fmt}, {steps} steps: worst err/tol "
        f"{worst:.3f}")


def uniform_reqs(rng, V: int, n: int, Request) -> list:
    """phase_serving's uniform requests (bench.py:225-228): prompts of
    5-24 tokens, 48 new tokens each."""
    return [Request(prompt_ids=[2] + rng.integers(
        4, min(40000, V - 2), size=int(rng.integers(4, 24))).tolist(),
        n_predict=48, request_id=i) for i in range(n)]


def phase_serving(c: Ctx, path: str, smi: str, kv_quant: bool = False) -> None:
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.models.biogpt import forward_fused_decode_greedy
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.runtime.serving import (BatchedEngine, Request,
                                                  ServingScheduler)
    from biogpt_tpu_torch.server import BioGptServer
    from biogpt_tpu_torch.tools.kernel_bounds import bound, layer_flops

    config, _, _, params = load_params(path, device="cpu")
    B, V, card = 32, config.n_vocab, torch.cuda.get_device_name(0)
    kv = "int8" if kv_quant else "bf16"
    eng = BatchedEngine(config, params, max_batch=B, max_seq=512, chunk=16,
                        kv_quant=kv_quant, device="cuda")
    # the sampled tail's commit fusion is bf16-only; refills take the kernel
    check(eng._fused_greedy and eng._fused_sampled == (not kv_quant)
          and eng._prefill_fused,
          f"BatchedEngine ({kv} KV): the fused serving paths are not live")
    rng = np.random.default_rng(0)

    def make_reqs(n):
        return uniform_reqs(rng, V, n, Request)

    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    eng.serve(make_reqs(4), greedy)   # warm-up: allocator, first launches
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    reqs = make_reqs(3 * B)
    snap0 = eng.metrics.snapshot()
    spans = span_meter(eng)
    t0 = time.perf_counter()
    res = eng.serve(reqs, greedy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._prefill_group, eng._run_chunk
    snap1 = eng.metrics.snapshot()
    chunks = snap1["chunks_launched"] - snap0["chunks_launched"]
    steps = chunks * eng.chunk
    n_tok = sum(len(r.new_ids) for r in res.values())
    check(len(res) == 3 * B and all(len(r.new_ids) == 48 for r in res.values())
          and all(0 <= t < V for r in res.values() for t in r.new_ids),
          f"serve ({kv} KV): {len(res)} results, {n_tok} tokens")
    c.lockstep_ids[kv] = {i: r.ids for i, r in res.items()}
    # every step of the all-greedy serve ran the batched step and the
    # greedy tail once (M=32: the tensor-core GEMV), every refill group the
    # refill kernel with 4 L GEMMs
    step_k = "decode_step_fused_batched" + ("_int8" if kv_quant else "")
    tail_k = "lm_head_argmax" if kv_quant else "lm_head_argmax_commit"
    got = {k: cuda_lib.LAUNCHES[k] for k in (step_k, tail_k, "prefill_fused",
                                             "prefill_gemm")}
    refills = snap1["refill_programs"] - snap0["refill_programs"]
    check(got[step_k] == steps and got[tail_k] == steps
          and got["prefill_fused"] == refills
          and got["prefill_gemm"] == 4 * c.cfg.n_layer * refills,
          f"serve ({kv} KV) launches {got}: want {steps} steps and tails, "
          f"{refills} refills of {4 * c.cfg.n_layer} GEMMs")
    chunk_ms = sum(s.elapsed_time(e) for s, e in spans["chunk"])
    refill_ms = sum(s.elapsed_time(e) for s, e in spans["refill"])
    serve_rec = {"serve_uniform_greedy_tokens_per_s": n_tok / wall,
                 "kv_cache": kv, "requests": len(res), "new_tokens": n_tok,
                 "wall_s": wall, "decode_steps": steps,
                 "wall_per_step_ms": 1e3 * wall / steps, "batch_slots": B,
                 "chunk": eng.chunk,
                 "refill_programs": (snap1["refill_programs"]
                                     - snap0["refill_programs"]),
                 # the wall split: device spans of the decode chunks and of
                 # the refill groups (CUDA events around each), the rest
                 # host scheduling, drains and idle
                 "decode_chunks_device_ms": chunk_ms,
                 "refill_waves_device_ms": refill_ms,
                 "refill_wave_ms": [s.elapsed_time(e)
                                    for s, e in spans["refill"]],
                 "other_ms": 1e3 * wall - chunk_ms - refill_ms}

    sched = ServingScheduler(eng, GenerationParams(temp=0.0,
                                                   stop_at_eos=False))
    srv = BioGptServer(sched, tokenizer=None)
    srv.start()
    try:
        n_http, wall_http, stats = http_round(srv, rng, V)
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    log(f"serving path ({kv} KV) launches: {launches}")
    for k in SERVING_KERNELS[kv_quant]:
        check(launches[k] > 0, f"kernel {k} was not launched on its path "
              f"({kv} KV)")
    count_route(c, launches, SERVING_KERNELS[kv_quant], "q4_0")
    print(json.dumps({"http_mixed_tokens_per_s": n_http / wall_http,
                      "kv_cache": kv, "requests": 8, "new_tokens": n_http,
                      "wall_s": wall_http, "stats": stats, "card": card,
                      "card_stamp": smi}), flush=True)

    P, cfg, dev = eng.params, c.cfg, c.dev
    D, L = cfg.d_model, cfg.n_layer
    # device time of one greedy serving step at the uniform run's shape
    # (B=32, window 128, positions 5-72) beside that run's wall per step
    cache = eng.new_cache()
    past_host = rng.integers(5, 73, size=B)
    past = torch.from_numpy(past_host).to(dev, torch.int32)
    toks = torch.from_numpy(rng.integers(4, V - 2, size=(B, 1))).to(dev)
    def step():
        return forward_fused_decode_greedy(P, toks, cache, past, config,
                                           kv_window=128)
    serve_rec["step_device_ms"] = time_ms(step, 20)
    serve_rec["step_device_ms_range"] = SPREAD[step]
    # the step's bound: every plane once, each slot's live K/V rows (and
    # their scales) read and its new rows written, the tokens and
    # positions in, the ids out
    live = int(past_host.sum())
    row = D + 4 if kv_quant else 2 * D
    wbytes = (sum(qbytes(P["layers"][n]["w"]) + P["layers"][n]["b"].numel() * 4
                  for n in ("qkv", "o", "fc1", "fc2")) + 4 * L * D * 4
              + qbytes(P["lm_head"]) + 2 * D * 4)
    step_bytes = wbytes + 2 * L * (live + B) * row + B * 16
    step_flops = (L * (layer_flops(cfg, B) + 4 * live * D)
                  + 2 * B * D * P["lm_head"].d_out)
    serve_rec["step_bound_ms"], serve_rec["step_bound_by"] = bound(
        step_bytes, step_flops)
    serve_rec.update(card=card, card_stamp=smi)
    print(json.dumps(serve_rec), flush=True)
    del cache

    refill_and_teacher_forced(c, eng, rng, kv_quant, 8, "q4_0")


# ------------------------------------------- 9. paged and staged serving

def mixed_reqs(rng, V: int, n: int, Request) -> list:
    """n requests of 48 new tokens, prompts of 5-25 and 100-124 tokens in
    turn; every other pair sampled (temp 0.9, top-k 40, top-p 0.9), the
    rest greedy (the HTTP round's mix, as one serve)."""
    out = []
    for i in range(n):
        k = int(rng.integers(5, 26) if i % 2 == 0 else rng.integers(100, 125))
        kw = dict(temp=0.9, top_k=40, top_p=0.9) if i % 4 >= 2 else {}
        out.append(Request(prompt_ids=[2] + rng.integers(
            4, V - 2, size=k - 1).tolist(), n_predict=48, request_id=i, **kw))
    return out


def phase_paged_staged_serving(c: Ctx, path: str, smi: str) -> None:
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    config, _, _, params = load_params(path, device="cpu")
    B, V, card = 32, config.n_vocab, torch.cuda.get_device_name(0)
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    mixed_gen = GenerationParams(temp=0.0, stop_at_eos=False, seed=3)
    mixed_ids = {}   # the lockstep serves' greedy rows, per cache
    # (name, flags, kernels its uniform greedy serve launches, kernels its
    # mixed serve launches); the lockstep engines run the mixed serve only
    paths = (
        ("lockstep bf16", {}, None, ()),
        ("lockstep int8", dict(kv_quant=True), None, ()),
        ("paged bf16", dict(paged_kv=True),
         ("decode_step_fused_paged", "decode_gemv", "batched_attention",
          "lm_head_argmax_commit", "prefill_fused", "prefill_gemm"),
         ("decode_step_fused_paged", "decode_gemv", "batched_attention",
          "kv_commit", "qmatmul_wide")),
        ("paged int8", dict(paged_kv=True, kv_quant=True),
         ("decode_step_fused_paged_int8", "decode_gemv", "batched_attention",
          "kv_commit_quant_rows", "lm_head_argmax", "prefill_fused",
          "prefill_gemm"),
         ("decode_step_fused_paged_int8", "decode_gemv", "batched_attention",
          "kv_commit_quant_rows", "qmatmul_wide")),
        ("staged bf16", dict(staged_kv=True),
         ("decode_step_fused_staged", "decode_gemv", "batched_attention",
          "qmatmul_wide", "prefill_fused", "prefill_gemm"),
         ("decode_step_fused_staged", "decode_gemv", "batched_attention",
          "qmatmul_wide")),
    )
    for name, flags, uniform_kernels, mixed_kernels in paths:
        kv = "int8" if flags.get("kv_quant") else "bf16"
        eng = BatchedEngine(config, params, max_batch=B, max_seq=512, chunk=16,
                            device="cuda", **flags)
        check(eng._paged_kv == bool(flags.get("paged_kv"))
              and eng._staged_kv == bool(flags.get("staged_kv"))
              and eng._prefill_fused and eng._fused_greedy,
              f"BatchedEngine ({name}): the path is not live")
        rng = np.random.default_rng(0)

        def make_reqs(n):   # phase_serving's requests, in its order
            return uniform_reqs(rng, V, n, Request)
        eng.serve(make_reqs(4), greedy)   # warm-up
        rec = {"serving_path": name, "batch_slots": B, "chunk": eng.chunk,
               "card": card, "card_stamp": smi}
        if uniform_kernels is not None:
            reqs = make_reqs(3 * B)
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            spans = span_meter(eng)
            t0 = time.perf_counter()
            res = eng.serve(reqs, greedy)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del eng._prefill_group, eng._run_chunk
            launches = dict(cuda_lib.LAUNCHES)
            n_tok = sum(len(r.new_ids) for r in res.values())
            check(len(res) == 3 * B
                  and all(len(r.new_ids) == 48 for r in res.values())
                  and all(0 <= t < V for r in res.values() for t in r.new_ids)
                  and eng.metrics.snapshot()["health_failures"] == 0,
                  f"serve ({name}): {len(res)} results, {n_tok} tokens")
            same = sum(res[i].ids == c.lockstep_ids[kv][i] for i in res)
            for k in uniform_kernels:
                check(launches[k] > 0, f"kernel {k} was not launched on the "
                      f"{name} uniform serve")
            count_route(c, launches, uniform_kernels, "q4_0")
            log(f"{name} uniform serve launches: {launches}")
            rec.update(serve_uniform_greedy_tokens_per_s=n_tok / wall,
                       requests=len(res), new_tokens=n_tok, wall_s=wall,
                       decode_chunks_device_ms=sum(
                           s.elapsed_time(e) for s, e in spans["chunk"]),
                       refill_waves_device_ms=sum(
                           s.elapsed_time(e) for s, e in spans["refill"]),
                       greedy_ids_equal_lockstep=same)
        if flags.get("staged_kv"):
            # the staged step's tail: final LN, the lm_head at M = B in one
            # launch of the streaming GEMV, the argmax
            from biogpt_tpu_torch.models.biogpt import _final_logits
            from biogpt_tpu_torch.runtime.sampling import greedy

            xh = c.randn(B, config.d_model)
            rec["tail_trace"] = wide_trace(
                lambda: greedy(_final_logits(eng.params, xh, config,
                                             torch.bfloat16)),
                f"{name} serve's tail (lm_head M={B})")
        # the mixed-length serve, half greedy: tokens/s, and its greedy rows
        # against the lockstep engine's on the same requests
        reqs = mixed_reqs(np.random.default_rng(1), V, B, Request)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.serve(reqs, mixed_gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        n_tok = sum(len(r.new_ids) for r in res.values())
        check(len(res) == B and all(len(r.new_ids) == 48 for r in res.values())
              and all(0 <= t < V for r in res.values() for t in r.new_ids)
              and eng.metrics.snapshot()["health_failures"] == 0,
              f"mixed serve ({name}): {len(res)} results, {n_tok} tokens")
        for k in mixed_kernels:
            check(launches[k] > 0, f"kernel {k} was not launched on the {name} "
                  "mixed serve")
        count_route(c, launches, mixed_kernels, "q4_0")
        greedy_rows = [r.request_id for r in reqs if r.temp is None]
        if uniform_kernels is None:
            mixed_ids[kv] = {i: res[i].ids for i in greedy_rows}
        rec.update(kv_cache=kv, serve_mixed_tokens_per_s=n_tok / wall,
                   mixed_requests=B, mixed_new_tokens=n_tok,
                   mixed_wall_s=wall, mixed_greedy_rows=len(greedy_rows),
                   mixed_greedy_ids_equal_lockstep=sum(
                       res[i].ids == mixed_ids[kv][i] for i in greedy_rows))
        print(json.dumps(rec), flush=True)
        del eng


# ------------------------------------- 9a. the decode chunks as CUDA graphs

def replay_kernels(counted: dict, L: int, B: int) -> dict:
    """The kernel launches a graph's trace must show for the wrappers'
    counts ``counted`` that one replay adds (``ChunkGraphs.launches``), on
    a model ``L`` deep at B slots: each GEMV, attention and commit count
    its kernel; the B=1 step the paged attention CTA a layer; the batched,
    paged and staged steps the LayerNorm statistics of their qkv and fc1
    GEMVs (2 L); an lm_head tail the streaming GEMV at B <= 8, else the
    LayerNorm'd rows and the tensor-core GEMV; the refill kernel its two
    LayerNorms and its attention a layer (its GEMMs counted apart)."""
    tail = ({"qgemv_stream_kernel": 1} if B <= 8
            else {"lm_head_mma_kernel": 1, "ln_rows_kernel": 1})
    per = {"decode_gemv_b1": {"qgemv_b1_kernel": 1},
           "decode_gemv": {"qgemv_mma_kernel": 1},
           "batched_attention": {"attn_batched_kernel": 1},
           "kv_commit": {"kv_commit_kernel": 1},
           "kv_commit_quant_rows": {"kv_commit_quant_rows_kernel": 1},
           "qmatmul": {"qmatmul_kernel": 1},
           "qmatmul_wide": {"qgemv_stream_kernel": 1},
           "decode_step_fused": {"attn_paged_kernel": L},
           "decode_step_fused_int8": {"attn_paged_kernel": L},
           "lm_head_argmax": tail, "lm_head_argmax_commit": tail,
           "lm_head_logits_gmax_commit": tail,
           "prefill_fused": {"ln_rows_kernel": 2 * L,
                             "causal_attn_kernel": L},
           "prefill_gemm": {"prefill_gemm_kernel": 1}}
    for k in ("decode_step_fused_batched", "decode_step_fused_batched_int8",
              "decode_step_fused_paged", "decode_step_fused_paged_int8",
              "decode_step_fused_staged"):
        per[k] = {"row_stats_kernel": 2 * L}
    want = {}
    for k, n in counted.items():
        for kern, m in per[k].items():
            want[kern] = want.get(kern, 0) + n * m
    return want


# traces of a replay taken at most: the tracer can drop a window's
# records on an H100, more of them late in a long process (a whole step of
# a 4-step B=1 replay in three traces running, once)
REPLAY_TRACE_ATTEMPTS = 6


def replay_trace(runner, key, L: int, B: int, what: str) -> dict:
    """One replay of the graph of ``key`` under ``torch.profiler``: the
    counts the replay adds to ``cuda_lib.LAUNCHES`` are the graph's, and
    the trace shows each of their kernels as often as they say
    (:func:`replay_kernels`). A trace short of those records is taken
    again, up to ``REPLAY_TRACE_ATTEMPTS`` times in all."""
    attempts = []
    for _ in range(REPLAY_TRACE_ATTEMPTS):
        counted = {}
        names = kernel_trace(lambda: runner.run(key, None), counted=counted)
        counted = {k: n for k, n in counted.items() if n}
        want = replay_kernels(counted, L, B)
        got = {k: launches_of(names, k) for k in want}
        attempts.append({"counted": counted, "trace": got,
                         "records": sum(v[0] for v in names.values())})
        if got == want:
            break
    check(counted == runner.launches(key) and got == want,
          f"{what}: a replay counted {counted} (the graph's "
          f"{runner.launches(key)}), its trace {got}, want {want}; "
          f"attempts {attempts}")
    rec = {"replay_trace": what, "key": [str(k) for k in key],
           "counted": counted, "trace": got, "attempts": attempts}
    print(json.dumps(rec), flush=True)
    return rec


def strict_eager(runner) -> None:
    """Run each chunk body of ``runner`` (an engine's with capture off)
    under ``torch.cuda.set_sync_debug_mode("error")``: a body that makes
    the host wait on the card raises."""
    real = runner.run

    def run(key, body, sampled=False, capture=True):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(key, body, sampled, capture)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    runner.run = run


def caches_equal(a, b) -> bool:
    """Whether two KV caches' planes (levels and scales) are bit-equal."""
    planes = ("k", "v", "ks", "vs")
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n in planes
               if getattr(a, n, None) is not None)


def replay_ms(runner, key, steps: int, reset, reps: int = 5) -> float:
    """Device ms a step of the graph of ``key``: CUDA events around each of
    ``reps`` replays, each after ``reset()`` (the positions put back), the
    median over ``steps``."""
    times = []
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        runner.run(key, None)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times) / steps


def single_stream_pair(c: Ctx, config, params, smi: str, what: str,
                       kw: dict, n_predict: int, timed: bool) -> dict:
    """An ``Engine`` on the graph route beside one whose capture is off
    (its bodies under the sync check), built with ``kw``: greedy and then
    sampled, four generations of ``n_predict`` tokens from a 16-token
    prompt on each (on the graph route two eager, the capturing one, one
    that only replays: the prefill key and every chunk key) -> the
    engines. Ids equal, caches bit-equal, the prefill key captured and
    replayed, ms/token of each generation; where ``timed``, a 64-step
    graph's device ms a step and a traced replay of the 4-step one."""
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs

    L, card = config.n_layer, torch.cuda.get_device_name(0)
    prompt = [2] + list(range(40, 55))
    runs = ChunkGraphs.EAGER_RUNS + 2   # eager ones, capturing, replaying
    engines = {"graph": Engine(config, params, device="cuda", **kw),
               "eager": Engine(config, params, device="cuda", **kw)}
    engines["eager"].graphs.capture = False
    check(engines["graph"].graphs.capture,
          f"single stream {what}: the graph route is not live")
    strict_eager(engines["eager"].graphs)
    runner = engines["graph"].graphs
    prefill_key = ("prefill", engines["graph"].cache_dtype, 16, 128)
    for temp in (0.0, 0.9):
        gen = GenerationParams(n_predict=n_predict, temp=temp, top_k=40,
                               top_p=0.9, seed=11, stop_at_eos=False)
        label = f"single stream {what} {'greedy' if temp <= 0 else 'sampled'}"
        res = {route: [] for route in engines}
        for route, eng in engines.items():
            for _ in range(runs):
                before = (runner.captures, sum(runner.runs.values()),
                          runner.replays)
                res[route].append(eng.generate(prompt, gen))
                torch.cuda.synchronize()
            if route == "graph":   # its last generation only replayed
                replayed = (runner.captures == before[0]
                            and sum(runner.runs.values()) == before[1]
                            and runner.replays > before[2])
        g, e = res["graph"][-1], res["eager"][-1]
        same = all(r.ids == g.ids for rs in res.values() for r in rs)
        equal = caches_equal(engines["graph"]._cache,
                             engines["eager"]._cache)
        prefilled = runner.replayed.get(prefill_key, 0) > 0
        check(same and equal and replayed and prefilled
              and len(g.new_ids) == n_predict,
              f"{label}: graph ids equal the eager route's: {same}, "
              f"caches bit-equal: {equal}, the last generation only "
              f"replayed: {replayed}, the prefill replayed: {prefilled}")
        print(json.dumps({
            "graph_single_stream": label, "kv_cache": str(
                engines["graph"].cache_dtype),
            "ids_equal": same, "caches_bit_equal": equal,
            "last_generation_only_replays": replayed,
            "prefill_replays": runner.replayed.get(prefill_key, 0),
            "new_tokens": len(g.new_ids),
            "graph_ms_per_token": g.timings["ms_per_token"],
            "eager_ms_per_token": e.timings["ms_per_token"],
            "graph_prefill_s": g.timings["prefill_s"],
            "eager_prefill_s": e.timings["prefill_s"],
            "graph_route_ms_per_token_by_generation": [
                r.timings["ms_per_token"] for r in res["graph"]],
            "eager_ms_per_token_by_generation": [
                r.timings["ms_per_token"] for r in res["eager"]],
            "graphs": runner.stats(), "card": card, "card_stamp": smi}),
            flush=True)
    if timed:
        # after the comparisons: a 64-step graph's device time (the
        # position put back to the prompt's end) and a traced replay
        st = engines["graph"]._decode_state()
        for temp_key in ((True, None), (False, 40)):
            key = ("b1", engines["graph"].cache_dtype, *temp_key, 128, 64)
            label = (f"single stream {what} "
                     f"{'greedy' if temp_key[0] else 'sampled'}")
            print(json.dumps({
                "graph_replay": label, "steps": 64, "window": 128,
                "device_ms_per_step": replay_ms(
                    runner, key, 64, lambda: st.pos.fill_(len(prompt))),
                "card": card, "card_stamp": smi}), flush=True)
            st.pos.fill_(130)
            replay_trace(runner, key[:4] + (256, 4), L, 1, label)
    return engines


def refill_pairs(rng, V: int, rows: int, T: int, Request) -> list:
    """``rows`` (slot, request) pairs into slots 0, 1, ... of prompts
    whose longest has ``T`` tokens (the others 4 to T), greedy."""
    lens = [T] + [int(n) for n in rng.integers(4, T + 1, size=rows - 1)]
    return [(b, Request(prompt_ids=[2] + rng.integers(
        4, V - 2, size=n - 1).tolist(), n_predict=4, request_id=b))
        for b, n in enumerate(lens)]


# refill groups (rows, padded) of phase 9a's refill timing: three of the
# refill kernel's, the mixed serve's 16 x 128 and a 32 x 512 (the per-op
# forward), each one graph
REFILL_SHAPES = ((1, 16), (4, 32), (32, 32), (16, 128), (32, 512))


def refill_timing(c: Ctx, config, params, smi: str, kw: dict,
                  what: str) -> None:
    """The refill groups of :data:`REFILL_SHAPES` on a fresh graph-route
    engine and a fresh one whose capture is off: each run three times (two
    eager runs and the capture on the graph route), then five more: the
    host's wall a call (its inputs' copy and the enqueue, the card
    synchronized after) on both, and the device ms of the body (CUDA
    events around the call) on both; every key captured and replayed,
    the two engines' pool caches and slot vectors bit-equal after each
    shape; the eager body's peak of allocated bytes (its first run) and
    the graphs' pool bytes after each key's capture (the refill graphs'
    own, no decode chunk on this engine); a 32 x 32 replay traced against
    its counts."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    card, L, V = torch.cuda.get_device_name(0), config.n_layer, config.n_vocab
    engines = {route: BatchedEngine(config, params, max_batch=32, max_seq=512,
                                    chunk=16, device="cuda", **kw)
               for route in ("graph", "eager")}
    engines["eager"].graphs.capture = False
    runner = engines["graph"].graphs
    gen = GenerationParams(temp=0.0, stop_at_eos=False)
    out, keys = {}, {}
    for rows, T in REFILL_SHAPES:
        pairs = refill_pairs(np.random.default_rng(rows), V, rows, T, Request)
        rec = {}
        for route, eng in engines.items():
            st, cache = eng._slots(), eng._pool_cache()
            walls, devs = [], []
            for i in range(8):
                torch.cuda.synchronize()
                if i == 0:
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                s.record()
                eng._prefill_group(pairs, cache, eng.generator, gen, st)
                e.record()
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                if i == 0:
                    peak = torch.cuda.max_memory_allocated() - base
                if i >= 3:
                    walls.append(1e3 * host)
                    devs.append(s.elapsed_time(e))
            rec[route] = {"host_ms": statistics.median(walls),
                          "device_ms": statistics.median(devs),
                          "first_run_peak_bytes": peak}
        graph, eager = engines["graph"], engines["eager"]
        key = next(k for k in runner.graphs
                   if k[0] == "refill" and k[3:] == (rows, T))
        keys[f"{rows}x{T}"] = key
        equal = caches_equal(graph._cache, eager._cache) and all(
            torch.equal(getattr(graph._st, n), getattr(eager._st, n))
            for n in ("toks", "first_buf", "lengths", "temps", "top_ps",
                      "top_ks"))
        check(runner.replayed.get(key, 0) >= 5 and equal,
              f"refill timing {what} {rows}x{T}: key {key} replayed "
              f"{runner.replayed.get(key, 0)} times, pool caches and slot "
              f"vectors bit-equal to the eager engine's: {equal}")
        rec["route"] = key[1]
        rec["bit_equal_to_eager"] = equal
        rec["pool_bytes_after"] = runner.pool_bytes()
        out[f"{rows}x{T}"] = rec
        log(f"refill timing {what} {rows}x{T} ({key[1]}): host ms graph "
            f"{rec['graph']['host_ms']:.3f} / eager "
            f"{rec['eager']['host_ms']:.3f}, device ms "
            f"{rec['graph']['device_ms']:.3f} / "
            f"{rec['eager']['device_ms']:.3f}, eager peak "
            f"{rec['eager']['first_run_peak_bytes']} bytes, pool "
            f"{rec['pool_bytes_after']} bytes")
    peaks = [r["eager"]["first_run_peak_bytes"] for r in out.values()]
    print(json.dumps({
        "refill_graph_timing": what, "shapes": out,
        "pool_bytes_refill_graphs": runner.pool_bytes(),
        "largest_key_peak_bytes": max(peaks),
        "sum_of_key_peaks_bytes": sum(peaks),
        "graphs": runner.stats(), "card": card, "card_stamp": smi}),
        flush=True)
    replay_trace(runner, keys["32x32"], L, 32, f"refill {what} 32x32")
    del engines, runner


# refill groups (rows, padded) of phase 9a's pool check, in the order a
# serve meets them: REFILL_SHAPES, then the largest group a server of 32
# slots and 1024 positions forms
POOL_SHAPES = REFILL_SHAPES + ((32, 1024),)
# the longest prompt of the 32 x 1024 group: room left for new tokens
LONGEST_PROMPT = 1000


def refill_pool(c: Ctx, config, params, smi: str, kw: dict,
                what: str) -> None:
    """The refill keys of :data:`POOL_SHAPES` on one graph-route engine of
    32 slots and 1024 positions, in ascending order as a serve captures
    them: each key's three runs (two eager, the capture), the pool's bytes
    after it, then a replay whose pool cache must be bit-equal to the
    cache after the key's first, eager run. Then each key alone on a
    fresh runner: its eager peak of allocated bytes (its first run) and
    its own pool. The keys share the pool: the pool after all of them
    must lie nearer the largest key's own pool than the sum of the keys'
    own pools (the smaller keys add less than half of what their own
    pools hold)."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    V = config.n_vocab
    eng = BatchedEngine(config, params, max_batch=32, max_seq=1024, chunk=16,
                        device="cuda", **kw)
    gen = GenerationParams(temp=0.0, stop_at_eos=False)
    st, cache = eng._slots(), eng._pool_cache()

    def run(pairs):
        eng._prefill_group(pairs, cache, eng.generator, gen, st)
        torch.cuda.synchronize()

    planes = [n for n in ("k", "v", "ks", "vs")
              if getattr(cache, n, None) is not None]
    ascending, equal, dev_ms = {}, {}, {}
    for rows, T in POOL_SHAPES:
        name = f"{rows}x{T}"
        pairs = refill_pairs(np.random.default_rng(rows), V, rows,
                             min(T, LONGEST_PROMPT), Request)
        run(pairs)
        first = {n: getattr(cache, n).clone() for n in planes}
        for _ in range(ChunkGraphs.EAGER_RUNS):
            run(pairs)
        ascending[name] = eng.graphs.pool_bytes()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        replays0 = eng.graphs.replays
        s.record()
        eng._prefill_group(pairs, cache, eng.generator, gen, st)
        e.record()
        torch.cuda.synchronize()
        dev_ms[name] = s.elapsed_time(e)
        equal[name] = (eng.graphs.replays == replays0 + 1 and all(
            torch.equal(getattr(cache, n), t) for n, t in first.items()))
        del first
    runner = eng.graphs
    pool = runner.pool_bytes()
    own, peaks = {}, {}
    for rows, T in POOL_SHAPES:
        name = f"{rows}x{T}"
        pairs = refill_pairs(np.random.default_rng(rows), V, rows,
                             min(T, LONGEST_PROMPT), Request)
        eng.graphs = ChunkGraphs(eng.device, eng.generator)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run(pairs)
        peaks[name] = torch.cuda.max_memory_allocated() - base
        for _ in range(ChunkGraphs.EAGER_RUNS):
            run(pairs)
        own[name] = eng.graphs.pool_bytes()
        eng.graphs = None
        torch.cuda.empty_cache()
    eng.graphs = runner
    largest = max(own.values())
    shared = pool - largest < 0.5 * (sum(own.values()) - largest)
    check(all(equal.values()) and shared,
          f"refill pool {what}: a replay bit-equal to the key's eager run "
          f"{equal}; the pool after every key, in ascending order, "
          f"{pool} bytes against the largest key's own {largest} and the "
          f"sum of the keys' own {sum(own.values())}: nearer the largest: "
          f"{shared}")
    print(json.dumps({
        "refill_pool": what, "order": "ascending",
        "pool_bytes_after": ascending, "pool_bytes": pool,
        "own_pool_bytes": own, "eager_peak_bytes": peaks,
        "replay_bit_equal_to_eager": equal, "replay_device_ms": dev_ms,
        "card": torch.cuda.get_device_name(0), "card_stamp": smi}),
        flush=True)
    log(f"refill pool {what}: ascending {ascending}, own {own}, eager peak "
        f"{peaks}, 32 x 1024 replay {dev_ms['32x1024']:.1f} device ms")
    del eng, runner, st, cache
    torch.cuda.empty_cache()


def serve_pair(c: Ctx, config, params, smi: str, name: str, flags: dict,
               n_uniform: int, B: int = 32, mixed_n: int = 32,
               mixed_reps: int = 4) -> dict:
    """A ``BatchedEngine`` on the graph route beside one whose capture is
    off, built with ``flags``, each warmed up (``warmup()``, then one
    uniform serve of B requests, not measured: a process's first use of a
    shape is paid there): the uniform greedy serve (``n_uniform``
    requests: with 96 its second wave of 32 x 32 captures that refill key
    and its third replays it) and the mixed one (``mixed_n`` requests,
    half sampled) ``mixed_reps`` times (its refill keys, the 16 x 128 group
    among them, captured on the third, the last only replaying them),
    the last of each measured -> the engines. Ids equal, pool caches
    bit-equal, refill keys captured and replayed on the graph route in
    each serve kind (``n_uniform`` of at least 96) and in none on the
    other; tokens/s, wall and device ms a step of both routes."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    V, card = config.n_vocab, torch.cuda.get_device_name(0)
    engines = {route: BatchedEngine(config, params, max_batch=B,
                                    max_seq=512, chunk=16, device="cuda",
                                    **flags)
               for route in ("graph", "eager")}
    engines["eager"].graphs.capture = False
    check(engines["graph"].graphs.capture,
          f"serve {name}: the graph route is not live")
    for eng in engines.values():
        eng.warmup()   # the window-128 graphs of both tails
        eng.serve(uniform_reqs(np.random.default_rng(7), V, B, Request),
                  GenerationParams(temp=0.0, stop_at_eos=False))
    runner = engines["graph"].graphs

    def refill_replays(eng):
        return sum(n for k, n in eng.graphs.replayed.items()
                   if k[0] == "refill")
    for kind, make, gen, reps in (
            ("uniform greedy", lambda: uniform_reqs(
                np.random.default_rng(0), V, n_uniform, Request),
             GenerationParams(temp=0.0, stop_at_eos=False), 1),
            ("mixed", lambda: mixed_reqs(np.random.default_rng(1), V,
                                         mixed_n, Request),
             GenerationParams(temp=0.0, stop_at_eos=False, seed=3),
             mixed_reps)):
        out = {}
        for route, eng in engines.items():
            eng_refills0 = refill_replays(eng)
            for rep in range(reps):
                snap0 = eng.metrics.snapshot()
                captures0 = eng.graphs.captures
                replays0 = eng.graphs.replays
                spans = span_meter(eng)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = eng.serve(make(), gen)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                del eng._prefill_group, eng._run_chunk
                steps = eng.chunk * (
                    eng.metrics.snapshot()["chunks_launched"]
                    - snap0["chunks_launched"])
                out[route] = {
                    "ids": {i: r.ids for i, r in got.items()},
                    "tokens_per_s": sum(len(r.new_ids)
                                        for r in got.values()) / wall,
                    "wall_ms_per_step": 1e3 * wall / steps,
                    "chunk_device_ms_per_step": sum(
                        s.elapsed_time(e) for s, e in spans["chunk"])
                    / steps,
                    "refill_device_ms": sum(
                        s.elapsed_time(e) for s, e in spans["refill"]),
                    "refill_groups": len(spans["refill"]),
                    "captures_in_serve": eng.graphs.captures - captures0,
                    "replays_in_serve": eng.graphs.replays - replays0}
            out[route]["refill_replays_in_serves"] = (refill_replays(eng)
                                                      - eng_refills0)
        same = out["graph"]["ids"] == out["eager"]["ids"]
        equal = caches_equal(engines["graph"]._cache,
                             engines["eager"]._cache)
        replayed = (out["graph"]["replays_in_serve"] > 0
                    and out["eager"]["replays_in_serve"] == 0)
        refilled = (out["graph"]["refill_replays_in_serves"] > 0
                    or (kind == "uniform greedy" and n_uniform < 96))
        check(same and equal and replayed and refilled,
              f"serve {name} {kind}: graph ids equal the eager route's: "
              f"{same}, caches bit-equal: {equal}, only the graph route "
              f"replayed: {replayed}, refill keys replayed: {refilled}")
        print(json.dumps({
            "graph_serve": name, "serve": kind, "batch_slots": B,
            "chunk": 16, "requests": len(out["graph"]["ids"]),
            "repeats": reps, "ids_equal": same, "caches_bit_equal": equal,
            **{f"{route}_{k}": v for route, o in out.items()
               for k, v in o.items() if k != "ids"},
            "graphs": runner.stats(), "card": card, "card_stamp": smi}),
            flush=True)
    return engines


def strict_alone(c: Ctx, eng, pairs, gen) -> None:
    """One refill group and one chunk of each tail of an engine whose
    capture is off, alone (no drain thread runs) under the sync check."""
    strict_eager(eng.graphs)
    eng._prefill_group(pairs, eng._cache, eng.generator, gen, eng._st)
    live = torch.ones(eng.B, dtype=torch.bool, device=c.dev)
    for all_greedy in (True, False):
        eng._st.lengths.copy_(torch.tensor(serve_past(eng.B),
                                           dtype=torch.int32, device=c.dev))
        eng._run_chunk(eng._st, eng._cache, live, 128, all_greedy,
                       eng.generator)
    torch.cuda.synchronize()


def probe_held(rec: dict, what: str, steps: bool, form: bool) -> None:
    """The local-batch probe's verdict (:func:`local_batch_probe`): the
    refill's cache rows (and scales), every layer's K and V rows and, with
    ``steps``, each step's logits bit-equal in the group and in its first
    half; the logits bit-equal too, or, where ``form`` allows it (groups
    of 16 and 32 rows on the per-op route), the first op that differs the
    last-token
    lm_head, which takes its other form at 32 rows (the JAX package's
    rule, ``ops.qmatmul._DEQUANT_M_ROWS``)."""
    held = [k for k in rec if k.startswith("refill_cache")
            or (steps and k.startswith("step"))]
    first = rec["ops"]["first_differing"]
    switched = (form and first is not None
                and first["op"] == "matmul / einsum"
                and first["call"] == rec["ops"]["bit_equal_ops"])
    check(all(rec[k]["equal"] for k in held)
          and all(rec["layers_k_v_bit_equal"])
          and (rec["refill_logits"]["equal"] or switched),
          f"local-batch probe {what}: a refill row's results depend on its "
          f"group's rows: {json.dumps(rec)}")


def phase_graphs(c: Ctx, path: str, smi: str) -> None:
    """Decode chunks, refills and prefills as CUDA graphs
    (``runtime/graphs.py``) on the main file, each engine beside an engine
    whose capture is off (the eager route, its bodies under
    ``set_sync_debug_mode("error")``) on the same weights and requests.
    The single stream (:func:`single_stream_pair`): bf16 and int8 caches
    (150 tokens: chunks of 64 at window 128, 64 and 16 + 4 + 1 at 256) and
    the per-op route (an f16 cache; unpacked weights; 32 tokens), greedy
    and sampled, four generations each: ids equal, caches bit-equal, the
    prefill key replayed. The refill groups alone (:func:`refill_timing`,
    bf16 and int8): 1 x 16, 4 x 32, 32 x 32, 16 x 128 and 32 x 512, each
    captured and replayed, bit-equal to the eager route, host and device
    ms of both routes, each key's peak and the refill graphs' pool bytes
    after it, a replay traced against its counts; the pool in the order a
    serve captures its keys, to the largest group of 1024 positions
    (:func:`refill_pool`). The serves (:func:`serve_pair`): lockstep, paged (bf16, int8)
    and staged at B=32, the uniform greedy serve (96 requests lockstep, 32
    the rest) and the mixed one (32, half sampled, four times), and the
    per-op route (an f16 cache) at B=8: ids equal, pool caches bit-equal,
    refill keys captured and replayed, tokens/s, wall and device ms a
    step, a chunk graph's replay traced and timed, one refill group and
    one chunk of each tail alone under the sync check. The local-batch
    probe (:func:`local_batch_probe`) on the refill kernel's route and the
    per-op route, bf16 and int8. Every engine's captures, capture seconds
    and pool bytes."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.runtime.serving import Request

    config, _, _, params = load_params(path, device="cpu")
    L, V, card = config.n_layer, config.n_vocab, torch.cuda.get_device_name(0)
    for what, kw, n, timed in (
            ("bf16", {}, 150, True), ("int8", dict(kv_quant=True), 150, True),
            ("per-op f16 cache", dict(cache_dtype=torch.float16), 32, False),
            ("per-op unpacked", dict(pack_q4=False), 32, False)):
        engines = single_stream_pair(c, config, params, smi, what, kw, n,
                                     timed)
        del engines
    for kv, kw in (("bf16", {}), ("int8", dict(kv_quant=True))):
        refill_timing(c, config, params, smi, kw, kv)
        refill_pool(c, config, params, smi, kw, kv)

    routes = (("lockstep bf16", {}, 96), ("lockstep int8",
                                          dict(kv_quant=True), 96),
              ("paged bf16", dict(paged_kv=True), 32),
              ("paged int8", dict(paged_kv=True, kv_quant=True), 32),
              ("staged bf16", dict(staged_kv=True), 32))
    B = 32
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    for name, flags, n_uniform in routes:
        engines = serve_pair(c, config, params, smi, name, flags, n_uniform)
        runner = engines["graph"].graphs
        # after the comparisons: the greedy window-128 chunk graph's device
        # time (positions put back to the uniform serve's) and, lockstep
        # bf16, a traced replay
        st = engines["graph"]._st
        key = next(k for k in runner.graphs
                   if k[0] != "refill" and k[2] and k[3] == 128)
        past = torch.tensor(serve_past(B), dtype=torch.int32, device=c.dev)
        st.live.fill_(True)
        print(json.dumps({
            "graph_replay": f"serve {name}", "steps": 16, "window": 128,
            "device_ms_per_step": replay_ms(
                runner, key, 16, lambda: st.lengths.copy_(past)),
            "card": card, "card_stamp": smi}), flush=True)
        if name == "lockstep bf16":
            st.lengths.copy_(past)
            replay_trace(runner, key, L, B, f"serve {name}")
        if name.startswith("lockstep"):
            for fused in (True, False):
                rec = local_batch_probe(engines["graph"],
                                        np.random.default_rng(6), steps=0,
                                        fused=fused)
                probe_held(rec, f"{name} {rec['route']}", steps=False,
                           form=not fused)
                print(json.dumps({"local_batch_16_vs_32": name, **rec,
                                  "card": card, "card_stamp": smi}),
                      flush=True)
        strict_alone(c, engines["eager"], refill_pairs(
            np.random.default_rng(2), V, 4, 32, Request), greedy)
        del engines, runner, st
    # the per-op route's serve: an f16 cache (per-op steps and refills)
    engines = serve_pair(c, config, params, smi, "per-op f16 cache",
                         dict(cache_dtype=torch.float16), 16, B=8,
                         mixed_n=16)
    check(not engines["graph"]._fused_decode
          and not engines["graph"]._prefill_fused
          and any(k[0] == "refill" and k[1] == "per_op"
                  for k in engines["graph"].graphs.graphs),
          "serve per-op f16 cache: no per-op refill key was captured")
    strict_alone(c, engines["eager"], refill_pairs(
        np.random.default_rng(2), V, 4, 32, Request), greedy)
    del engines


# ------------------------------------ 10. Q5_0, Q5_1 and Q8_0 end to end

def count_route(c: Ctx, launches: dict, kernels, fmt: str,
                n_layer: int | None = None) -> None:
    """Add a main-path run's launches of ``kernels`` to the ``kernels``
    line's counts, and note that they drove a route in format ``fmt``; a
    route through the refill kernel of a model ``n_layer`` deep (347M's
    by default) launched its GEMM 4 L times a call."""
    L = n_layer or c.cfg.n_layer
    if "prefill_fused" in kernels:
        n = launches["prefill_fused"]
        check(launches["prefill_gemm"] == 4 * L * n,
              f"{fmt} route: {launches['prefill_gemm']} refill GEMM launches "
              f"for {n} prefill_fused calls (want {4 * L} each)")
    for k in kernels:
        c.launches[k] = c.launches.get(k, 0) + launches[k]
        c.formats.setdefault(k, set()).add(fmt)


def launched_exactly(c: Ctx, launches: dict, required: set, optional: set,
                     what: str, fmt: str, n_layer: int | None = None) -> None:
    """A run launched every kernel of its route (``required``), and no
    kernel outside it and the refills' lm_head GEMVs (``optional``); the
    route's launches count on the ``kernels`` line."""
    got = {k for k, n in launches.items() if n > 0}
    check(required <= got <= required | optional,
          f"{what}: launched {sorted(got)}, expected {sorted(required)} "
          f"(and perhaps {sorted(optional - required)})")
    count_route(c, launches, required, fmt, n_layer)


def phase_format_e2e(c: Ctx, fmt: str, smi: str) -> None:
    """A random model file in ``fmt``, 347M's widths ``FORMAT_DEPTH``
    layers deep, through the entry points: the CLI
    greedy, sampled and greedy with ``--kv-quant`` (32 new tokens); the
    uniform greedy ``serve()`` of 96 requests at B=32 with a bf16 and an
    int8 cache and through the paged and the staged engine, refilling
    through ``prefill_fused``. Each run launches exactly its route's
    kernels: a packed lm_head (Q4, Q5) takes the fused argmax tails, an
    unpacked Q8_0 one the lm_head GEMV and a torch argmax, as in the JAX
    engines. Then teacher-forced steps of the kernels against the plain
    path on the engine's own weights: B=1, and B=32 from a refill wave
    (bf16 and int8; the wave's prefill-kernel logits held to the per-op
    refill's)."""
    import numpy as np

    from biogpt_tpu_torch.cli import main as cli_main
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params, tree_map
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.runtime.engine import Engine, _pack_matmul_weights
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    qtype, bits = FORMATS[fmt]
    packed = bits != 8
    argmax_tail = {"lm_head_argmax"} if packed else set()
    refill_gemv = {"qmatmul", "qmatmul_wide"}   # the refill's lm_head, m = R
    card = torch.cuda.get_device_name(0)
    L = FORMAT_DEPTH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, f"biogpt347m-{L}layers-{fmt}.bin")
        t0 = time.perf_counter()
        write_random_quantized_model(
            path, dataclasses.replace(c.cfg, n_layer=L), qtype, seed=7)
        log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f} s")
        prompt = "the protein binds the receptor"   # 9-32 tokens
        # the single stream's steps commit at their device position
        # through kv_commit (bf16) or kv_commit_quant_rows (int8)
        for argv, required in (
                (["--temp", "0"], {"qmatmul", "qmatmul_wide",
                                   "decode_step_fused", "decode_gemv_b1",
                                   "kv_commit"} | argmax_tail),
                (["--temp", "0.9", "-s", "1"],
                 {"qmatmul", "qmatmul_wide", "decode_step_fused",
                  "decode_gemv_b1", "kv_commit"}),
                (["--temp", "0", "--kv-quant"],
                 {"qmatmul", "qmatmul_wide", "decode_step_fused_int8",
                  "decode_gemv_b1", "kv_commit_quant_rows"} | argmax_tail)):
            cuda_lib.reset_launch_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(["-m", path, "-p", prompt, "-n", "32",
                               "--no-stop-at-eos", *argv])
            text = out.getvalue().strip()
            log(f"cli {fmt} {argv}: rc={rc} {time.perf_counter() - t0:.1f} "
                f"s, {len(text)} chars of text")
            check(rc == 0 and len(text) > 0, f"cli {fmt} {argv} rc={rc}")
            launched_exactly(c, dict(cuda_lib.LAUNCHES), required, set(),
                             f"cli {fmt} {argv}", fmt, L)
        config, _, _, params = load_params(path, device="cpu")
    # the engines' weights, prepared once on the host and moved to the card
    # (each engine's own preparation then finds them prepared)
    params = tree_map(lambda a: a.to(c.dev), _pack_matmul_weights(params))
    lm = params["lm_head"]
    check(lm.packed == packed and lm.scales.dtype == torch.bfloat16
          and lm.levels.dtype == (torch.uint8 if packed else torch.int8),
          f"{fmt}: the engines' lm_head is not prepared as the JAX engines "
          f"prepare it (packed={lm.packed}, levels {lm.levels.dtype})")
    teacher_forced_single(c, Engine(config, params, device="cuda"),
                          [2] + list(range(40, 52)), 4, fmt)

    B, V = 32, config.n_vocab
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    routes = (
        ("lockstep bf16", {}, {"decode_step_fused_batched", "decode_gemv",
                               "batched_attention", "kv_commit"}
         | ({"lm_head_argmax_commit"} if packed else {"qmatmul_wide"})),
        ("lockstep int8", dict(kv_quant=True),
         {"decode_step_fused_batched_int8", "decode_gemv",
          "batched_attention", "kv_commit_quant_rows"}
         | (argmax_tail if packed else {"qmatmul_wide"})),
        ("paged bf16", dict(paged_kv=True), {"decode_step_fused_paged",
                                             "decode_gemv",
                                             "batched_attention", "kv_commit"}
         | ({"lm_head_argmax_commit"} if packed else {"qmatmul_wide"})),
        ("staged bf16", dict(staged_kv=True),
         {"decode_step_fused_staged", "decode_gemv", "batched_attention",
          "qmatmul_wide"}),
    )
    lockstep_ids = None
    for name, flags, step_kernels in routes:
        eng = BatchedEngine(config, params, max_batch=B, max_seq=512,
                            chunk=16, device="cuda", **flags)
        check(eng._prefill_fused and eng._fused_greedy == packed
              and eng._paged_kv == bool(flags.get("paged_kv"))
              and eng._staged_kv == bool(flags.get("staged_kv")),
              f"BatchedEngine ({name} {fmt}): the path is not live")
        rng = np.random.default_rng(0)

        def make_reqs(n):   # phase_serving's requests, in its order
            return uniform_reqs(rng, V, n, Request)
        eng.serve(make_reqs(4), greedy)   # warm-up
        reqs = make_reqs(3 * B)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.serve(reqs, greedy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.new_ids) for r in res.values())
        check(len(res) == 3 * B
              and all(len(r.new_ids) == 48 for r in res.values())
              and all(0 <= t < V for r in res.values() for t in r.new_ids)
              and eng.metrics.snapshot()["health_failures"] == 0,
              f"serve ({name} {fmt}): {len(res)} results, {n_tok} tokens")
        launches = dict(cuda_lib.LAUNCHES)
        log(f"{name} {fmt} uniform serve launches: {launches}")
        launched_exactly(c, launches,
                         step_kernels | {"prefill_fused", "prefill_gemm"},
                         refill_gemv, f"serve ({name} {fmt})", fmt, L)
        ids = {i: r.ids for i, r in res.items()}
        if lockstep_ids is None:
            lockstep_ids = ids
        print(json.dumps({
            "serving_path": name, "format": fmt, "batch_slots": B,
            "chunk": eng.chunk, "serve_uniform_greedy_tokens_per_s":
            n_tok / wall, "requests": len(res), "new_tokens": n_tok,
            "wall_s": wall, "greedy_ids_equal_lockstep_bf16": sum(
                ids[i] == lockstep_ids[i] for i in ids),
            "card": card, "card_stamp": smi}), flush=True)
        if name.startswith("lockstep"):
            refill_and_teacher_forced(c, eng, np.random.default_rng(5),
                                      bool(flags.get("kv_quant")), 4, fmt)
        del eng


# ------------------------------------------- 13. the README's model files

# the per-window nll of the kernels against their plain versions: the
# kernels and the plain versions round the same bf16 values and sum in
# other orders, so an activation can land one bf16 step (2^-8 of its
# magnitude) apart and carry that to the logits; two such steps of the
# window's mean nll
NLL_RTOL = 2.0 ** -7
# the tokens after the first of (e)'s perplexity text: windows of 1024 at
# stride 512 from 0, 512 and 1024 (the last scores one token)
PPL_TOKENS = 1536


def load_golden(name: str) -> dict:
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "tests", "goldens", name)) as g:
        return {k: g[k] for k in g.files}


def first_divergence(eng, prompt: list, got: list, want: list,
                     what: str) -> None:
    """Fail with the first step at which greedy ids ``got`` leave ``want``,
    and the top-2 margin of the logits there (the golden's prefix fed)."""
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    logits, _, _ = eng.prefill(eng.new_cache(), want[:i])
    top2 = torch.topk(logits[0].float(), 2)
    check(False, f"{what}: greedy ids leave the golden at step "
          f"{i - len(prompt)} (got {got[i] if i < len(got) else None}, "
          f"want {want[i] if i < len(want) else None}); top-2 there "
          f"{top2.indices.tolist()} with margin "
          f"{(top2.values[0] - top2.values[1]).item():.6f}")


def greedy_held(eng, prompt: list, want: list, what: str) -> None:
    """Greedy ids equal ``want``, streaming (one token a chunk) and not."""
    from biogpt_tpu_torch.config import GenerationParams

    gen = GenerationParams(n_predict=len(want) - len(prompt), temp=0.0,
                           stop_at_eos=False)
    for mode in ("streaming", "chunked"):
        toks = []
        got = eng.generate(prompt, gen, stream_cb=toks.append
                           if mode == "streaming" else None).ids
        if got != want or (mode == "streaming"
                           and toks != want[len(prompt):]):
            first_divergence(eng, prompt, got, want, f"{what} ({mode})")
        else:
            log(f"{what}: greedy ids equal the golden's "
                f"({len(want) - len(prompt)} new, {mode})")


def free(*engines) -> None:
    """Drop the engines' weights from the card before the next is built."""
    import gc

    for e in engines:
        e.params = None
    gc.collect()
    torch.cuda.empty_cache()


def phase_model_files(c: Ctx, smi: str) -> None:
    """The README's model-file pipeline at full 347M width, on the card:
    (a) the seed-7, scale-0.1 state dict of ``hf347m_seed7.npz`` written
    as a HuggingFace directory, converted to f32 and f16 files and the f32
    file quantized to the five formats (the five in parallel processes),
    each step's seconds logged; (b) the f32 file on the f32 dense path
    against HF's own prefill logits and greedy ids; (c) the Q4_0 and Q4_1
    files on the f32 unpacked path against ``own347m_seed7_quant.npz``'s
    greedy ids, and on the production path (bf16, packed, 64 positions,
    as ``tools/make_goldens.py --gpu-bf16`` builds it) against
    ``gpu347m_seed7_bf16.npz``'s (``check_goldens_gpu.check_engine``: two
    eager generations, then one whose prefill and chunk keys replay their
    graphs); (d) the Q4_0 file through the CLI's engine (bf16, packed)
    after ``warmup()``, greedy and sampled, then ``perplexity_of_ids`` at
    window 32 on the card against the same engine on the CPU (the kernels'
    plain versions) over four windows, each run launching exactly its
    route's kernels; (e) perplexity at window 1024, stride 512, of every
    file in f32 and bf16, with tokens/s, after three scorings of one full
    window (two eager, the third captures its graph): the full windows
    replay, the last, shorter one runs eagerly, the first window's nll
    equals the eager scoring's bit for bit, and every window's nll that of
    the same run with capture off, whose tokens/s stand beside the
    replayed run's; synthetic weights, no quality claim."""
    import numpy as np
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.modelio.synthetic import make_state_dict, write_hf_dir
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.graphs import ChunkGraphs
    from biogpt_tpu_torch.tools import check_goldens_gpu
    from biogpt_tpu_torch.tools.convert_hf import convert
    from biogpt_tpu_torch.tools.perplexity import perplexity_of_ids
    from biogpt_tpu_torch.tools.quantize_cli import QUANT_CHOICES, quantize_file

    hf = load_golden("hf347m_seed7.npz")
    quant = load_golden("own347m_seed7_quant.npz")
    gpu = load_golden(check_goldens_gpu.GOLDEN)
    goldens = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens")
    seed = int(hf["seed"])
    # the npz keeps the scale as f32; its shortest repr is the literal 0.1
    scale = float(np.format_float_positional(np.float32(hf["scale"]),
                                             unique=True))
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as tmp:
        # ------------------------------------------------ (a) the files
        secs, files = {}, {}
        t0 = time.perf_counter()
        sd = make_state_dict(c.cfg, seed=seed, scale=scale)
        secs["state_dict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_hf_dir(os.path.join(tmp, "hf"), c.cfg, sd)
        secs["write_hf_dir"] = time.perf_counter() - t0
        del sd
        for name, f16 in (("f32", False), ("f16", True)):
            t0 = time.perf_counter()
            files[name] = str(convert(os.path.join(tmp, "hf"),
                                      os.path.join(tmp, name), use_f16=f16,
                                      verbose=False))
            secs[f"convert_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = [os.path.join(tmp, f"{q}.bin") for q in QUANT_CHOICES]
        with ProcessPoolExecutor(len(outs), mp_context=get_context("spawn")) \
                as pool:
            for q, out, stats in zip(QUANT_CHOICES, outs, pool.map(
                    quantize_file, [files["f32"]] * len(outs), outs,
                    QUANT_CHOICES, [False] * len(outs))):
                secs[f"quantize_{q}"] = stats["seconds"]
                files[q] = out
        secs["quantize_all_five_wall"] = time.perf_counter() - t0
        sizes = {k: os.path.getsize(p) / 1e6 for k, p in files.items()}
        log(f"model files: seconds {json.dumps(secs)}; MB "
            f"{json.dumps(sizes)}")
        print(json.dumps({"model_files": "pipeline", "seconds": secs,
                          "file_mb": sizes, "config": "BioGPT-347M, seed "
                          f"{seed}, scale {scale}", "card": card,
                          "card_stamp": smi}), flush=True)

        # ------------------------------------- (b) HF's golden on the card
        prompt = hf["prompt"].tolist()
        t0 = time.perf_counter()
        config, _, _, params = load_params(files["f32"], device="cuda")
        check((config.n_vocab, config.n_layer, config.d_model, config.d_ff,
               config.n_head) == (c.cfg.n_vocab, c.cfg.n_layer,
                                  c.cfg.d_model, c.cfg.d_ff, c.cfg.n_head),
              f"converted f32 file: config {config}")
        eng = Engine(config, params, compute_dtype=torch.float32,
                     cache_dtype=torch.float32, max_seq=64, device="cuda")
        del params
        load_s = time.perf_counter() - t0
        logits, _, _ = eng.prefill(eng.new_cache(), prompt)
        got = logits[0].cpu().numpy()
        want = hf["prefill_logits"].astype(np.float32)
        err = float(np.abs(got - want).max())
        excess = float((np.abs(got - want)
                        - (0.12 + 2e-3 * np.abs(want))).max())
        check(excess <= 0 and int(got.argmax()) == int(want.argmax()),
              f"HF golden prefill logits on the card: max |err| {err} "
              f"(over rtol 2e-3, atol 0.12 by {excess}), argmax "
              f"{int(got.argmax())} vs {int(want.argmax())}")
        greedy_held(eng, prompt, hf["greedy_ids"].tolist(),
                    "HF golden, f32 file, f32 dense path")
        print(json.dumps({"model_files": "hf347m_golden", "file": "f32",
                          "prefill_max_abs_err": err, "load_s": load_s,
                          "card": card, "card_stamp": smi}), flush=True)
        free(eng)

        # ---------------------------- (c) the quantized goldens, per op
        for q in ("q4_0", "q4_1"):
            config, _, _, params = load_params(files[q], device="cuda")
            eng = Engine(config, params, compute_dtype=torch.float32,
                         cache_dtype=torch.float32, max_seq=64, pack_q4=False,
                         device="cuda")
            del params
            greedy_held(eng, quant["prompt"].tolist(),
                        quant[f"{q}_greedy_ids"].tolist(),
                        f"{q} golden, quantized file, f32 unpacked path")
            free(eng)
            # the production path against the card's own golden
            config, _, _, params = load_params(files[q], device="cuda")
            eng = Engine(config, params, max_seq=64, device="cuda")
            del params
            check(eng._fused_decode, f"{q} card golden: the fused decode "
                  "step does not run")
            want = gpu[f"{q}_greedy_ids"].tolist()
            got = check_goldens_gpu.check_engine(eng, want)
            rec = {"model_files": "gpu347m_golden", "format": q, **got,
                   "want": want[len(prompt):],
                   **{f"agree_with_{o}": check_goldens_gpu.agreement(
                       got["new_ids"][-1], os.path.join(goldens, o), q)
                      for o in check_goldens_gpu.OTHERS},
                   "golden_card": str(gpu["device"]), "card": card,
                   "card_stamp": smi}
            print(json.dumps(rec), flush=True)
            check(all(got["equal"]) and got["last_run_replayed"],
                  f"{q} card golden (bf16, packed): runs equal "
                  f"{got['equal']}, the last replayed "
                  f"{got['replayed_kinds']}: {json.dumps(rec)}")
            free(eng)

        # ------------------ (d) the kernels: the CLI's engine, perplexity
        config, _, _, params = load_params(files["q4_0"], device="cuda")
        eng = Engine(config, params, device="cuda")
        del params
        t0 = time.perf_counter()
        eng.warmup()
        log(f"Engine.warmup() on the Q4_0 file: "
            f"{time.perf_counter() - t0:.1f} s")
        cuda_lib.reset_launch_counts()
        runs = ((prompt, GenerationParams(n_predict=32, temp=0.0,
                                          stop_at_eos=False)),
                (prompt[:5], GenerationParams(n_predict=32, temp=0.9, seed=1,
                                              stop_at_eos=False)))
        for p, g in runs:
            res = eng.generate(p, g)
            check(len(res.new_ids) == 32
                  and all(0 <= t < config.n_vocab for t in res.new_ids),
                  f"model files q4_0 CLI engine (temp {g.temp}): "
                  f"{len(res.new_ids)} tokens")
        launches = {k: n for k, n in cuda_lib.LAUNCHES.items() if n}
        print(json.dumps({"model_files": "cli_engine", "format": "q4_0",
                          "runs": "greedy (12-token prompt), sampled "
                          "(5-token prompt), 32 new tokens each",
                          "launches": launches, "card": card,
                          "card_stamp": smi}), flush=True)
        launched_exactly(c, dict(cuda_lib.LAUNCHES),
                         {"qmatmul", "qmatmul_wide", "lm_head_argmax",
                          "decode_step_fused", "decode_gemv_b1", "kv_commit"},
                         set(), "model files q4_0 CLI engine", "q4_0")
        # windows of 32 rows (row 2) and a last one of 6 (row 1)
        ids = [2] + np.random.default_rng(0).integers(
            4, config.n_vocab, size=4 * 32 + 5).tolist()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        on_card = perplexity_of_ids(eng, ids, window=32)
        ppl_s = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        launched_exactly(c, launches, {"qmatmul", "qmatmul_wide"}, set(),
                         "perplexity at window 32, Q4_0 bf16", "q4_0")
        free(eng)
        config, _, _, params = load_params(files["q4_0"], device="cpu")
        t0 = time.perf_counter()
        on_cpu = perplexity_of_ids(Engine(config, params, device="cpu"),
                                   ids[:4 * 32], window=32)
        cpu_s = time.perf_counter() - t0
        del params
        rel = [abs(a - b) / max(abs(b), 1.0) for a, b in
               zip(on_card["window_nll"], on_cpu["window_nll"])]
        check(len(on_cpu["window_nll"]) == 4
              and len(on_card["window_nll"]) == 5
              and all(math.isfinite(x) for x in on_card["window_nll"])
              and max(rel) <= NLL_RTOL,
              f"perplexity at window 32 (Q4_0 bf16): the card's window nll "
              f"{on_card['window_nll'][:4]} vs the CPU's "
              f"{on_cpu['window_nll']} (relative {rel}, limit {NLL_RTOL})")
        print(json.dumps({
            "model_files": "perplexity_kernels", "format": "q4_0",
            "compute": "bf16", "window": 32,
            "window_nll_card": on_card["window_nll"],
            "window_nll_cpu_plain": on_cpu["window_nll"],
            "window_nll_rel_err": rel, "limit": NLL_RTOL,
            "launches": {k: launches[k] for k in ("qmatmul", "qmatmul_wide")},
            "card_tokens_per_s": on_card["tokens"] / ppl_s,
            "cpu_plain_tokens_per_s": on_cpu["tokens"] / cpu_s,
            "card": card, "card_stamp": smi}), flush=True)

        # ------------------ (e) perplexity of every file, window 1024
        ids = [2] + np.random.default_rng(1).integers(
            4, config.n_vocab, size=PPL_TOKENS).tolist()
        table = {}
        for name in ("f32", "f16") + QUANT_CHOICES:
            config, _, _, params = load_params(files[name], device="cuda")
            for dtype, label in ((torch.float32, "f32"),
                                 (torch.bfloat16, "bf16")):
                eng = Engine(config, params, compute_dtype=dtype,
                             device="cuda")
                # two eager scorings of a full window, then its capture
                warm = [perplexity_of_ids(eng, ids[:1024], window=1024)
                        for _ in range(ChunkGraphs.EAGER_RUNS + 1)]
                torch.cuda.synchronize()
                replays0 = eng.graphs.stats()["by_kind"].get(
                    "score", {}).get("replays", 0)
                t0 = time.perf_counter()
                st = perplexity_of_ids(eng, ids, window=1024, stride=512)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                score = eng.graphs.stats()["by_kind"].get("score", {})
                replayed = score.get("replays", 0) - replays0
                # the same run with capture off: every window eager
                eng.graphs.capture = False
                t0 = time.perf_counter()
                eager = perplexity_of_ids(eng, ids, window=1024, stride=512)
                torch.cuda.synchronize()
                eager_wall = time.perf_counter() - t0
                eng.graphs.capture = True
                same = (st["window_nll"][0] == warm[0]["window_nll"][0]
                        == warm[-1]["window_nll"][0]
                        and st["window_nll"] == eager["window_nll"])
                check(math.isfinite(st["nll"]) and replayed == 2 and same,
                      f"perplexity of the {name} file ({label}): nll "
                      f"{st['nll']}, scoring replays {replayed} (want the "
                      f"two full windows), the window nll "
                      f"{st['window_nll']} against an eager run's "
                      f"{eager['window_nll']}, the first window's eager "
                      f"scoring's {warm[0]['window_nll'][0]} and its "
                      f"capture's {warm[-1]['window_nll'][0]}")
                table[f"{name} {label}"] = st["ppl"]
                print(json.dumps({
                    "model_files": "perplexity", "file": name,
                    "compute": label, "window": 1024, "stride": 512,
                    "tokens": st["tokens"], "nll": st["nll"],
                    "ppl": st["ppl"], "tokens_per_s": st["tokens"] / wall,
                    "eager_tokens_per_s": eager["tokens"] / eager_wall,
                    "window_nll": st["window_nll"],
                    "score_replays": replayed, "score_graphs": score,
                    "window_nll_equal_eager": same,
                    "weights": "synthetic (seed 7, scale 0.1): no quality "
                    "claim", "card": card, "card_stamp": smi}), flush=True)
                free(eng)
            del params
        base = {label: table[f"f32 {label}"] for label in ("f32", "bf16")}
        log("perplexity, window 1024 stride 512, synthetic weights "
            "(delta vs the f32 file): " + "; ".join(
                f"{k} {v:.6g} ({v - base[k.split()[1]]:+.6g})"
                for k, v in table.items()))


# --------------------------------------- 11. tensor-parallel decode kernels

TP_FORMATS = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")
# the projections each TP half runs on the tensor-core GEMV
TP_HALF_GEMVS = {"tp_attn_half": 2, "tp_attn_half_int8": 1, "tp_qkv_half": 1,
                 "tp_ffn_half": 2}


def tp_shards(c: Ctx, tp: int, fmt: str) -> list:
    """A random 347M model's TP shards, as ``parallel.tp.shard_params_tp``
    leaves them on each rank: the qkv and fc1 columns, the o and fc2 d_in
    rows of a chunk-packed plane (a packed plane of the local shape by
    itself), each a random plane of its local shape (Q5 and Q8_0: the Q4
    rows' planes re-quantized, as the 24-layer steps of
    :func:`phase_format_kernels` take them); LayerNorms and the o and fc2
    biases the same on every shard."""
    cfg = c.cfg
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    Dl, Fl = D // tp, F // tp
    q4 = "q4_1" if fmt.endswith("_1") else "q4_0"
    shared = {n: {"w": 1 + 0.1 * c.randn(L, D), "b": 0.1 * c.randn(L, D)}
              for n in ("ln0", "ln1")}
    row_bias = {"o": 0.02 * c.randn(L, D), "fc2": 0.02 * c.randn(L, D)}
    shards = []
    for _ in range(tp):
        lay = dict(shared)
        for name, d_in, d_out in (("qkv", D, 3 * Dl), ("o", Dl, D),
                                  ("fc1", D, Fl), ("fc2", Fl, D)):
            qt = c.rand_qt(d_in, d_out, (L,), fmt=q4)
            if fmt != q4:
                qt = requantize(qt, fmt)
            b = row_bias.get(name)
            lay[name] = {"w": qt, "b": 0.02 * c.randn(L, d_out)
                         if b is None else b}
        shards.append(lay)
    return shards


def tp_rows_within(got, want, what: str) -> float:
    """A shard's new K/V rows from the TP step against the plain ones:
    bf16 (k, v) rows to :func:`rows_within`, int8 (kq, vq, ksc, vsc) to
    :func:`quant_rows_within`."""
    if len(got) == 2:
        return max(rows_within(got[0], want[0], what + " k"),
                   rows_within(got[1], want[1], what + " v"))
    return max(quant_rows_within((got[0], got[2]), (want[0], want[2]),
                                 what + " k"),
               quant_rows_within((got[1], got[3]), (want[1], want[3]),
                                 what + " v"))


def hold_half(name: str, run, plain, rec: dict) -> None:
    """One TP half on one layer against its plain version on the same
    inputs: the partial sums (and qkv, its absmax) within 3e-3 of their
    largest magnitude, the steps' hidden limit (a half carries the
    LayerNorm's and the products' bf16 roundings, which the f32 summation
    order can flip); the attention half's new K/V rows within two bf16
    ulps of their largest magnitude, the rows' limit."""
    got, want = run(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        rows = name.startswith("tp_attn_half") and i > 0
        tol = (2 ** -6 if rows else 3e-3) * w.abs().max().item()
        check(err <= tol and bool(torch.isfinite(g).all()),
              f"{name} output {i}: err {err} > {tol}")
        errs.append(err / max(tol, 1e-30))
    rec.update(max_abs_err=(got[0].float() - want[0].float()).abs().max()
               .item(), tol=3e-3 * want[0].float().abs().max().item(),
               err_over_tol=max(errs))


def tp_local_widths(c: Ctx, tp: int, pt) -> None:
    """The kernels the TP route reuses, at one shard's widths: the KV
    commits on (L, 32, 512, D/tp) caches against their plain versions, bit
    for bit (positions in range, and clamped), and the local lm_head's
    GEMVs (d_out 42,496/tp) at m = 1 and 32 within 1e-5 of the output's
    magnitude (f32 summation order only)."""
    from biogpt_tpu_torch.ops.decode_kernels import (kv_commit,
                                                     kv_commit_plain,
                                                     kv_commit_quant,
                                                     kv_commit_quant_plain)
    from biogpt_tpu_torch.ops.qmatmul_kernels import (qmatmul, qmatmul_plain,
                                                      qmatmul_wide,
                                                      qmatmul_wide_plain)

    cfg, dev = c.cfg, c.dev
    D, L, B, S = cfg.d_model, cfg.n_layer, 32, 512
    Dl = D // tp
    clamped = torch.tensor([-3, S + 5] + ragged_past(B - 2), dtype=torch.int32,
                           device=dev)
    kc = c.randn(L, B, S, Dl).to(torch.bfloat16)
    vc = c.randn(L, B, S, Dl).to(torch.bfloat16)
    rows = [c.randn(B, L, Dl).to(torch.bfloat16) for _ in range(2)]
    lk, lks = rand_int8_cache(c, L, B, S, Dl)
    lv, lvs = rand_int8_cache(c, L, B, S, Dl)
    q = [torch.randint(-127, 128, (B, L, Dl), generator=c.gen, device=dev,
                       dtype=torch.int32).to(torch.int8) for _ in range(2)]
    sc = [torch.rand(B, L, 1, generator=c.gen, device=dev) for _ in range(2)]
    same = True
    for p in (pt, clamped):
        same &= all(bool(torch.equal(a, b)) for a, b in zip(
            kv_commit(kc.clone(), vc.clone(), *rows, p),
            kv_commit_plain(kc.clone(), vc.clone(), *rows, p)))
        same &= all(bool(torch.equal(a, b)) for a, b in zip(
            kv_commit_quant(lk.clone(), lv.clone(), lks.clone(), lvs.clone(),
                            *q, *sc, p),
            kv_commit_quant_plain(lk.clone(), lv.clone(), lks.clone(),
                                  lvs.clone(), *q, *sc, p)))
    check(same, f"kv_commit / kv_commit_quant at D/tp = {Dl}: caches differ "
          "from the plain commits")
    lm = c.rand_qt(D, c.V_PAD // tp)
    errs = []
    for m, kern, plain in ((1, qmatmul, qmatmul_plain),
                           (32, qmatmul_wide, qmatmul_wide_plain)):
        x = c.randn(m, D)
        y, ref = kern(x, lm), plain(x, lm)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"local lm_head d_out {lm.d_out} m={m}: err {err} "
              f"> {tol}")
        errs.append(err / tol)
    print(json.dumps({"tp_local_widths": tp, "cache_row": Dl,
                      "kv_commits_bit_equal": same,
                      "lm_head_d_out": lm.d_out,
                      "lm_head_gemv_err_over_tol": errs}), flush=True)


def tp_gemvs(c: Ctx, tp: int) -> None:
    """The TP halves' four projections alone at one shard's widths
    (``decode_gemv``, the tensor-core GEMV the halves launch) at M = 32:
    qkv (LayerNorm, bias) and fc1 (LayerNorm, bias, GELU) at d_out / tp, o
    and fc2 at d_in / tp with a null bias, the partial sum alone (one
    split at d_in 256, two at 512); held in every format against the plain
    version (:func:`held_gemv`), timed in Q4_0 beside the bound
    (``tools/kernel_bounds.py::tp_gemv_cost``) and ``x_bf16 @
    dequantize(W)``, the L2 flushed before each call."""
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.decode_kernels import (decode_gemv,
                                                     decode_gemv_plain)
    from biogpt_tpu_torch.tools.kernel_bounds import (projection_shape,
                                                      tp_gemv_cost)

    cfg, M = c.cfg, 32
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=c.dev)

    def flush():
        flush_buf.zero_()

    for name, ln, act, _ in GEMV_SHAPES:
        d_in, d_out = projection_shape(cfg, name)
        if ln:
            d_out //= tp
        else:
            d_in //= tp
        for fmt in FORMATS:
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            held, kw, x = held_gemv(c, qt, d_in, d_out, ln, act, False, M,
                                    f"TP GEMV {name} tp={tp} {fmt}",
                                    bias=ln)
            rec = {"tp_gemv": name, "tp": tp, "shape": f"{d_in} -> {d_out}",
                   "m": M, "format": fmt, **held}
            if fmt == "q4_0":
                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(qt,
                                                             torch.bfloat16)
                nbytes, flops, _ = tp_gemv_cost(cfg, name, tp, M, fmt)
                timed(rec, lambda: decode_gemv(x, qt, **kw),
                      lambda: decode_gemv_plain(x, qt, **kw), lib_call,
                      nbytes, flops, reps=50, plain_reps=5, flush=flush)
            print(json.dumps(rec), flush=True)
    del flush_buf


def phase_tp_kernels(c: Ctx) -> None:
    """The TP decode step's halves in one process on the card (and first
    the reused kernels at a shard's widths, :func:`tp_local_widths`): a
    random 347M model's shards at tp 2 and 4, every format, bf16 and int8 KV,
    B=32 ragged positions (dead slots), window 512. Every shard's halves
    for all 24 layers with the partials summed in shard order (where the
    all-reduce sums them), against the plain halves on the same inputs:
    each layer, from the plain step's state before it, on its own scale
    (:func:`layers_within`), the final state (:func:`hidden_within`) and
    every shard's new K/V rows (:func:`tp_rows_within`). With an int8
    cache the attention half's inputs include the current rows, quantized
    between the halves by torch (``quantize_rows``); the final state is
    held against the plain halves fed the kernel path's rows, and so is
    each layer. Rounded by each path from its own qkv, a row can differ by
    one int8 level, and a dead slot's context is its current row alone, so
    the step carries the whole quantization step into x (on an H100: 1.020
    of the limit at a dead slot, 0.37 with the rows shared; one layer
    alone 1.369 on its own rows). The rows and the qkv half stay held on
    each path's own quantization. Each half alone on layer
    12 of shard 0 (:func:`hold_half`; traced, :func:`tp_trace`), and one
    shard's whole step, are timed beside their bounds and the plain
    versions; then the halves' projections alone (:func:`tp_gemvs`)."""
    from biogpt_tpu_torch.modelio.checkpoint import tree_map
    from biogpt_tpu_torch.ops.decode_tp_kernels import (
        decode_step_tp_shards, tp_attn_half, tp_attn_half_plain, tp_ffn_half,
        tp_ffn_half_plain, tp_qkv_half, tp_qkv_half_plain)
    from biogpt_tpu_torch.runtime.cache import quantize_rows
    from biogpt_tpu_torch.tools.kernel_bounds import (tp_half_cost,
                                                      tp_step_cost)

    cfg, dev = c.cfg, c.dev
    D, L, H, S, eps = (cfg.d_model, cfg.n_layer, cfg.n_head, cfg.n_positions,
                       cfg.ln_eps)
    B, W, li = 32, 512, cfg.n_layer // 2
    past = ragged_past(B, dead=(7, 19))
    pt = torch.tensor(past, dtype=torch.int32, device=dev)
    live = sum(min(p, W) for p in past)
    for tp in (2, 4):
        tp_local_widths(c, tp, pt)
    for fmt in TP_FORMATS:
        for tp in (2, 4):
            Dl, Hl = D // tp, H // tp
            layers = tp_shards(c, tp, fmt)
            # every shard's planes and biases, the LayerNorms once
            wbytes = (sum(qbytes(lay[n]["w"]) for lay in layers
                          for n in PROJECTIONS)
                      + L * (3 * D + cfg.d_ff + 2 * D) * 4 + 4 * L * D * 4)
            for int8 in (False, True):
                kv = "int8" if int8 else "bf16"
                if int8:
                    _, ks = rand_int8_cache(c, L, B, S, 1)
                    _, vs = rand_int8_cache(c, L, B, S, 1)
                    shards = [dict(layers=lay,
                                   k_cache=rand_int8_cache(c, L, B, S, Dl)[0],
                                   v_cache=rand_int8_cache(c, L, B, S, Dl)[0],
                                   k_scales=ks, v_scales=vs) for lay in layers]
                else:
                    shards = [dict(layers=lay,
                                   k_cache=c.randn(L, B, S, Dl).to(torch.bfloat16),
                                   v_cache=c.randn(L, B, S, Dl).to(torch.bfloat16))
                              for lay in layers]
                x0 = c.randn(B, D)
                tk, tpl, cur = [], [], []

                def recorded(x, amax):   # the kernel path's int8 rows
                    cur.append(quantize_rows(x, amax=amax))
                    return cur[-1]
                xk, rk = decode_step_tp_shards(x0, shards, pt, n_head=H,
                                               window=W, ln_eps=eps, trace=tk,
                                               quantize=recorded)
                xp, rp = decode_step_tp_shards(x0, shards, pt, n_head=H,
                                               window=W, ln_eps=eps,
                                               plain=True, trace=tpl)
                if int8:
                    # the final state: the plain halves fed the same int8
                    # current rows, the attention half's inputs (see the
                    # docstring)
                    replay = iter(cur)
                    xp, _ = decode_step_tp_shards(
                        x0, shards, pt, n_head=H, window=W, ln_eps=eps,
                        plain=True, quantize=lambda x, amax: next(replay))
                # each layer alone from the plain step's state before it;
                # with an int8 cache held, as the final state, against the
                # plain halves fed the kernel path's current rows of that
                # layer
                per_layer, held_to = [], []
                for lyr in range(L):
                    x_in = x0 if lyr == 0 else tpl[lyr - 1]
                    one_layer = [tree_map(lambda a: a[lyr:lyr + 1], sh)
                                 for sh in shards]
                    cur = []
                    per_layer.append(decode_step_tp_shards(
                        x_in, one_layer, pt, n_head=H, window=W, ln_eps=eps,
                        quantize=recorded)[0])
                    if int8:
                        replay = iter(cur)
                        held_to.append(decode_step_tp_shards(
                            x_in, one_layer, pt, n_head=H, window=W,
                            ln_eps=eps, plain=True,
                            quantize=lambda x, amax: next(replay))[0])
                    else:
                        held_to.append(tpl[lyr])
                torch.cuda.synchronize()
                what = f"TP step tp={tp} {fmt} {kv}"
                worst = layers_within(per_layer, held_to, what)
                # the same limit along the 24-layer trajectory, reported
                drift = max((a - b).abs().max().item()
                            / (3e-3 * b.abs().max().item())
                            for a, b in zip(tk, tpl))
                err = hidden_within(xk, xp, what)
                rows = max(tp_rows_within(a, b, f"{what} shard {i}")
                           for i, (a, b) in enumerate(zip(rk, rp)))
                one = [shards[0]]   # one rank's whole step, no collective
                step = {"tp_step": "decode_step_fused_tp", "tp": tp,
                        "format": fmt, "kv_cache": kv, "layers": L, "B": B,
                        "past": past, "window": W, "max_abs_err": err,
                        "tol": 3e-3 * xp.abs().max().item(),
                        "layers_err_over_tol": worst,
                        "trajectory_layers_err_over_limit": drift,
                        "rows_err_over_tol": rows}
                timed(step, lambda: decode_step_tp_shards(
                          x0, one, pt, n_head=Hl, window=W, ln_eps=eps),
                      lambda: decode_step_tp_shards(
                          x0, one, pt, n_head=Hl, window=W, ln_eps=eps,
                          plain=True),
                      None, *tp_step_cost(cfg, past, W, wbytes, tp, int8),
                      reps=10, plain_reps=2)
                print(json.dumps(step), flush=True)

                # each half alone on layer li of shard 0
                sh, lay = shards[0], layers[0]
                x = tpl[li - 1]
                per_layer = {n: qbytes(lay[n]["w"]) // L for n in PROJECTIONS}
                kw = dict(n_head=Hl, window=W, ln_eps=eps)
                halves = []
                if int8:
                    qkv, amax = tp_qkv_half_plain(x, lay, li, ln_eps=eps)
                    kq, ksc = quantize_rows(qkv[:, Dl:2 * Dl], amax=amax[:, 0])
                    vq, vsc = quantize_rows(qkv[:, 2 * Dl:], amax=amax[:, 1])
                    ext = dict(k_scales=sh["k_scales"], v_scales=sh["v_scales"],
                               q=qkv[:, :Dl] * (1 / math.sqrt(Dl // Hl)),
                               k_cur=kq.float() * ksc[:, None],
                               v_cur=vq.float() * vsc[:, None])
                    halves += [
                        ("tp_qkv_half", "qkv", per_layer["qkv"],
                         lambda: tp_qkv_half(x, lay, li, ln_eps=eps),
                         lambda: tp_qkv_half_plain(x, lay, li, ln_eps=eps)),
                        ("tp_attn_half_int8", "attn int8", per_layer["o"],
                         lambda: tp_attn_half(x, lay, li, sh["k_cache"],
                                              sh["v_cache"], pt, **kw, **ext),
                         lambda: tp_attn_half_plain(
                             x, lay, li, sh["k_cache"], sh["v_cache"], pt,
                             **kw, **ext))]
                else:
                    halves += [
                        ("tp_attn_half", "attn",
                         per_layer["qkv"] + per_layer["o"],
                         lambda: tp_attn_half(x, lay, li, sh["k_cache"],
                                              sh["v_cache"], pt, **kw),
                         lambda: tp_attn_half_plain(
                             x, lay, li, sh["k_cache"], sh["v_cache"], pt,
                             **kw)),
                        ("tp_ffn_half", "ffn",
                         per_layer["fc1"] + per_layer["fc2"],
                         lambda: tp_ffn_half(x, lay, li, ln_eps=eps),
                         lambda: tp_ffn_half_plain(x, lay, li, ln_eps=eps))]
                for name, half, planes, run, plain in halves:
                    rec = {"kernel": name, "tp": tp, "layer": li, "B": B,
                           "past": past, "window": W, "format": fmt}
                    hold_half(f"{name} tp={tp} {fmt}", run, plain, rec)
                    tp_trace(run, TP_HALF_GEMVS[name],
                             f"{name} tp={tp} {fmt}")
                    timed(rec, run, plain, None,
                          *tp_half_cost(cfg, half, B, live, tp, planes),
                          reps=20, plain_reps=3)
                    if fmt == "q4_0" and tp == 4:
                        c.results[name] = rec
                    c.emit(rec)
                del shards, tk, tpl
            del layers
    for tp in (2, 4):
        tp_gemvs(c, tp)


# ------------------------------- 12. tensor-parallel serving on two ranks

TP_ROUTES = {   # the kernels a TP serve's steps launch (refills run per op)
    False: {"tp_attn_half", "tp_ffn_half", "kv_commit", "qmatmul_wide"},
    True: {"tp_qkv_half", "tp_attn_half_int8", "tp_ffn_half",
           "kv_commit_quant", "qmatmul_wide"},
}


# the per-op forward's functions whose outputs the local-batch probe logs,
# by their names in models/biogpt.py (and torch's, for the attention)
PROBE_OPS = ("_layer_norm", "_project", "matmul", "_gelu", "prefill_fused",
             "quantize_rows")
PROBE_TORCH_OPS = ("einsum", "softmax")


@contextlib.contextmanager
def op_log(log: list):
    """Append (op name, output) for each call of :data:`PROBE_OPS` (in
    ``models.biogpt``'s namespace) and :data:`PROBE_TORCH_OPS` (torch's)
    while the block runs, in call order."""
    from biogpt_tpu_torch.models import biogpt

    def wrap(name, fn):
        def logged(*a, **k):
            out = fn(*a, **k)
            log.append((name, out))
            return out
        return logged
    saved = [(biogpt, n, getattr(biogpt, n)) for n in PROBE_OPS]
    saved += [(torch, n, getattr(torch, n)) for n in PROBE_TORCH_OPS]
    for mod, n, fn in saved:
        setattr(mod, n, wrap(n, fn))
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def _first_rows(t, n: int, rows: int, T: int):
    """The part of ``t`` that belongs to the first ``n`` of ``rows`` prompts
    padded to ``T`` tokens: its leading axis where that is the prompts',
    else its first axis of the flattened rows (``rows * T``: the refill
    kernel's outputs and their scales), sliced to ``[0, n * T)``."""
    if t.shape[0] == rows:
        return t[:n]
    for ax, size in enumerate(t.shape):
        if size == rows * T:
            return t.narrow(ax, 0, n * T)
    raise ValueError(f"probe: no prompt axis in {tuple(t.shape)}")


def _tensors(out) -> list:
    return [t for t in (out if isinstance(out, tuple) else (out,))
            if isinstance(t, torch.Tensor)]


def ops_half_vs_whole(logs: dict, rows: int, T: int) -> dict:
    """The op-by-op comparison of two logged refills (:func:`op_log`) of
    ``rows`` prompts padded to ``T`` tokens and of their first half: each
    op's output for the first half of the prompts against the half's run
    -> the ops compared, how many were bit-equal, and the first that was
    not (its call number, name, the layer by the LayerNorms before it, its
    largest difference), or where the two runs first called other ops (a
    product's form chosen by its row count: ``ops.qmatmul.matmul``)."""
    half = rows // 2
    a, b = logs[rows], logs[half]
    first, equal, lns = None, 0, 0
    for i, ((name, x), (other, y)) in enumerate(zip(a, b)):
        if name != other:
            first = first or {"call": i, "op": f"{name} / {other}",
                              "layer": lns // 2, "max_abs_diff": None}
            break
        same, diff = True, 0.0
        for tx, ty in zip(_tensors(x), _tensors(y)):
            if tx.shape == ty.shape and tx.shape[0] not in (rows, half):
                # a product's row tile, of one shape in both runs (the
                # card's zero-padded tiles): its first rows hold the half's
                tx, ty = tx[:half], ty[:half]
            else:
                tx = _first_rows(tx, half, rows, T)
            if not torch.equal(tx, ty):
                same = False
                d = (tx.float() - ty.float()).abs()
                diff = max(diff, float(torch.nan_to_num(d, nan=float("inf"))
                                       .max()))
        equal += same
        if not same and first is None:
            first = {"call": i, "op": name, "layer": lns // 2,
                     "max_abs_diff": diff}
        lns += name == "_layer_norm"
    return {"ops": len(a), "bit_equal_ops": equal, "first_differing": first}


def _same_half(a, b) -> dict:
    """Whether the whole group's ``a`` holds the half's ``b`` in its first
    rows (a cache plane's second axis, else the first)."""
    a = a[:, :b.shape[1]] if a.dim() == 4 else a[:b.shape[0]]
    return {"equal": bool(torch.equal(a, b)),
            "max_abs_diff": (a.float() - b.float()).abs().max().item()}


def refill_half_vs_whole(eng, ids, last, fused: bool, replica: bool) -> dict:
    """A refill of a group of prompts (``ids`` (rows, T), ``last``
    (rows,)) and of their first half on the engine's device, through the
    refill kernel (``forward_prefill_fused``, ``fused``) or the per-op
    forward as ``_prefill_group`` runs it (``eng._fwd`` with
    ``allow_kernels=False``; a mesh engine's TP or sharded forward; with
    ``replica`` the half is a data-axis replica's share of the group,
    ``group_rows=rows``; else a group of its own), every op logged ->
    whether the first half's logits and cache rows are bit-equal, their
    largest difference, the op-by-op comparison
    (:func:`ops_half_vs_whole`) and, per layer, whether the K and V rows
    are bit-equal; with the (logits, small cache) of both runs."""
    from biogpt_tpu_torch.models.biogpt import forward_prefill_fused
    from biogpt_tpu_torch.runtime.cache import init_cache

    P, config, dev = eng.params, eng.config, eng.device
    rows, T = ids.shape
    half = rows // 2
    runs, logs = {}, {}
    for n in (rows, half):
        logs[n] = []
        with op_log(logs[n]):
            if fused:
                runs[n] = forward_prefill_fused(
                    P, ids[:n], config, last[:n],
                    compute_dtype=eng.compute_dtype,
                    cache_dtype=eng.cache_dtype)
            else:
                small = init_cache(config, batch=n, max_len=T,
                                   dtype=eng.cache_dtype, device=dev,
                                   tp=eng._kv_shards)
                runs[n] = eng._fwd(P, ids[:n], small, 0, config,
                                   compute_dtype=eng.compute_dtype,
                                   allow_kernels=False, last_index=last[:n],
                                   group_rows=rows if replica else None)
    torch.cuda.synchronize()
    (lw, cw), (lh, ch) = runs[rows], runs[half]
    out = {"route": "fused" if fused else "per_op", "rows": [rows, half],
           "padded": T, "replica": replica,
           "refill_logits": _same_half(lw, lh),
           "refill_cache_k": _same_half(cw.k, ch.k),
           "refill_cache_v": _same_half(cw.v, ch.v)}
    if getattr(cw, "ks", None) is not None:
        out["refill_cache_ks"] = _same_half(cw.ks, ch.ks)
        out["refill_cache_vs"] = _same_half(cw.vs, ch.vs)
    out["layers_k_v_bit_equal"] = [
        bool(torch.equal(cw.k[i, :half], ch.k[i])
             and torch.equal(cw.v[i, :half], ch.v[i]))
        for i in range(cw.k.shape[0])]
    out["ops"] = ops_half_vs_whole(logs, rows, T)
    return out, runs


def gemms_16_vs_32(eng, T: int = 32) -> dict:
    """The refill kernel's four GEMMs alone (``prefill_gemm``, layer 0's
    planes) on 32 * T seeded rows and on their first 16 * T -> per
    projection whether the first 16 * T output rows are bit-equal."""
    from biogpt_tpu_torch.ops.prefill_kernels import prefill_gemm

    layers, dev = eng.params["layers"], eng.device
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, epi in (("qkv", "qkv"), ("o", "resid"), ("fc1", "gelu"),
                      ("fc2", "resid")):
        qt = layers[name]["w"].map(lambda a: a[0])
        bias = layers[name]["b"][0]
        a = torch.randn(32 * T, qt.d_in, generator=g, device=dev).to(
            torch.bfloat16)
        x = (torch.randn(32 * T, qt.d_out, generator=g, device=dev)
             if epi == "resid" else None)
        kw = dict(epi=epi, scale=0.125 if epi == "qkv" else None)
        y32 = _tensors(prefill_gemm(a, qt, bias, x=x, **kw))
        y16 = _tensors(prefill_gemm(a[:16 * T], qt, bias,
                                    x=None if x is None else x[:16 * T], **kw))
        out[name] = all(torch.equal(p[:16 * T], q) for p, q in zip(y32, y16))
    torch.cuda.synchronize()
    return out


def local_batch_probe(eng, rng, steps: int = 2, fused: bool = False,
                      replica: bool = False, rows: int = 32,
                      padded: int = 32) -> dict:
    """Whether a slot's refill results on the card depend on the number of
    rows refilled beside it (a group's, or a data-axis replica's local
    batch, ``replica``: by default 16 slots of a (2, 2) mesh against 32 of
    a (1, 2) one): ``rows`` prompts of ``padded`` / 8 to 3 ``padded`` / 4
    tokens (4-23 at 32) padded to ``padded`` and their first half,
    refilled through the refill kernel (``fused``) or the engine's per-op
    forward (:func:`refill_half_vs_whole`: logits, cache rows, each op
    and each layer); with ``fused`` also the refill kernel's GEMMs alone
    (:func:`gemms_16_vs_32`). On the per-op route then ``steps`` greedy
    steps through ``eng._fwd`` (on the TP route the step's halves, the
    commits and the local lm_head) at ``rows`` slots and at their first
    half from the same cache rows, each step's logits compared."""
    from biogpt_tpu_torch.runtime.cache import init_cache, merge_rows

    P, config, dev = eng.params, eng.config, eng.device
    half = rows // 2
    lens = [int(n) for n in rng.integers(padded // 8, padded * 3 // 4,
                                         size=rows)]
    ids = torch.zeros(rows, padded, dtype=torch.long)
    for b, n in enumerate(lens):
        ids[b, :n] = torch.from_numpy(rng.integers(4, config.n_vocab - 2,
                                                   size=n))
    ids, last = ids.to(dev), torch.tensor([n - 1 for n in lens], device=dev)
    out, refill = refill_half_vs_whole(eng, ids, last, fused, replica)
    if fused:
        out["prefill_gemm_bit_equal"] = gemms_16_vs_32(eng)
        return out
    cache = init_cache(config, batch=rows, max_len=128, dtype=eng.cache_dtype,
                       device=dev, tp=eng._kv_shards)
    merge_rows(cache, refill[rows][1], torch.arange(rows, device=dev),
               torch.arange(rows, device=dev))
    caches = {rows: cache, half: type(cache)(**{
        f.name: getattr(cache, f.name)[:, :half].clone()
        for f in dataclasses.fields(cache)})}
    tok = torch.argmax(refill[rows][0], -1)[:, None]
    past = torch.tensor(lens, dtype=torch.int32, device=dev)
    for step in range(steps):
        got = {}
        for n in (rows, half):
            got[n], caches[n] = eng._fwd(P, tok[:n], caches[n], past[:n],
                                         config,
                                         compute_dtype=eng.compute_dtype,
                                         kv_window=128)
        out[f"step{step}_logits"] = _same_half(got[rows], got[half])
        tok, past = torch.argmax(got[rows], -1)[:, None], past + 1
    torch.cuda.synchronize()
    return out


def tp_teacher_forced(eng, mesh, rng, kv_quant: bool, steps: int) -> float:
    """One refill wave of the uniform serve's shape (a prompt of 4-23
    tokens padded to 32 for each of the replica's own slots: 32 on a
    (1, 2) mesh, 16 on a (2, 2) one) through the per-op TP forward, then
    ``steps`` teacher-forced TP steps at that local batch from it: the kernels
    (``decode_step_fused_tp``, the local lm_head GEMV and the gather)
    against the plain halves on the engine's own shard, the plain rows
    committed -> the worst error over its limit."""
    from biogpt_tpu_torch.models.biogpt import _decode_x0, _layer_norm
    from biogpt_tpu_torch.ops import matmul
    from biogpt_tpu_torch.ops.decode_kernels import (kv_commit_plain,
                                                     kv_commit_quant_plain)
    from biogpt_tpu_torch.ops.decode_tp_kernels import decode_step_fused_tp
    from biogpt_tpu_torch.ops.qmatmul_kernels import lm_head_logits_plain
    from biogpt_tpu_torch.runtime.cache import init_cache, merge_rows

    P, config, dev, B = eng.params, eng.config, eng.device, eng.B_local
    V, kv = config.n_vocab, "int8" if kv_quant else "bf16"
    lens = [int(n) for n in rng.integers(4, 24, size=B)]
    ids = torch.zeros(B, 32, dtype=torch.long)
    for b, n in enumerate(lens):
        ids[b, :n] = torch.from_numpy(rng.integers(4, V - 2, size=n))
    ids = ids.to(dev)
    last = torch.tensor([n - 1 for n in lens], device=dev)
    small = init_cache(config, batch=B, max_len=32, dtype=eng.cache_dtype,
                       device=dev, tp=mesh.model)
    logits, small = eng._fwd(P, ids, small, 0, config,
                             compute_dtype=torch.bfloat16, allow_kernels=False,
                             last_index=last)
    check(bool(torch.isfinite(logits).all()),
          f"TP refill wave ({kv}): non-finite logits")
    cache = eng.new_cache()
    merge_rows(cache, small, torch.arange(B, device=dev),
               torch.arange(B, device=dev))
    tok = torch.argmax(logits, -1)
    past = torch.tensor(lens, dtype=torch.int32, device=dev)
    fw, fb = P["final_ln"]["w"], P["final_ln"]["b"]
    kw = dict(n_head=config.n_head, tp_size=mesh.model, mesh=mesh,
              window=128, ln_eps=config.ln_eps)
    if kv_quant:
        kw.update(k_scales=cache.ks, v_scales=cache.vs)
    worst = 0.0
    for step in range(steps):
        x0 = _decode_x0(P, tok[:, None], past, config)
        ko = decode_step_fused_tp(x0, P["layers"], cache.k, cache.v, past, **kw)
        po = decode_step_fused_tp(x0, P["layers"], cache.k, cache.v, past,
                                  plain=True, **kw)
        xk, xp = ko[0], po[0]
        lk = mesh.all_gather_last(matmul(
            _layer_norm(xk, fw, fb, config.ln_eps), P["lm_head"],
            compute_dtype=torch.bfloat16))[:, :V]
        lp = mesh.all_gather_last(lm_head_logits_plain(
            xp, fw, fb, P["lm_head"], config.ln_eps))[:, :V]
        torch.cuda.synchronize()
        what = f"TP teacher-forced B={B} {kv} KV step {step}"
        err = hidden_within(xk, xp, what)
        worst = max(worst, err / max(3e-3 * xp.abs().max().item(), 1e-30),
                    tp_rows_within(ko[1:], po[1:], what))
        top2 = torch.topk(lp, 2).values
        decided = (top2[:, 0] - top2[:, 1]) > 2e-2 * lp.abs().amax(-1)
        ref = torch.argmax(lp, -1)
        wrong = int(((torch.argmax(lk, -1) != ref) & decided).sum())
        check(wrong == 0, f"{what}: argmax differs on {wrong} decided rows")
        if kv_quant:
            kq, vq, ksc, vsc = po[1:]
            kv_commit_quant_plain(cache.k, cache.v, cache.ks, cache.vs,
                                  kq.transpose(0, 1), vq.transpose(0, 1),
                                  ksc.transpose(0, 1)[..., None],
                                  vsc.transpose(0, 1)[..., None], past)
        else:
            kv_commit_plain(cache.k, cache.v, po[1].transpose(0, 1),
                            po[2].transpose(0, 1), past)
        tok = ref
        past = past + 1
    return worst


def tp_rank(argv: list) -> int:
    """One rank of the two-rank TP serve (``chip_smoke.py --tp-rank OUT
    MODEL``, started by :func:`phase_tp_serving` through the port's
    launcher with gloo, both ranks on cuda:0): the uniform 96-request
    greedy serve with a bf16 and an int8 cache and a refill wave with
    teacher-forced TP steps after each, then a mixed serve (half sampled);
    its ids, times, launches and failures go to OUT as JSON."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.parallel import make_mesh
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    out_path, path = argv
    mesh = make_mesh(1, 2, device="cuda:0")
    config, _, _, params = load_params(path, device="cpu")
    B, V = 32, config.n_vocab
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    out = {"rank": mesh.index, "serves": {}}
    # the step's collective: a (B, D) f32 all-reduce, host clock
    part = torch.ones(B, config.d_model, device=mesh.device)
    mesh.sum(part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        mesh.sum(part)
    torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) / 50 * 1e3

    def serve(eng, reqs, gen):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.serve(reqs, gen)
        torch.cuda.synchronize()
        return {"wall_s": time.perf_counter() - t0,
                "ids": {str(i): r.ids for i, r in res.items()},
                "new_tokens": [len(r.new_ids) for r in res.values()],
                "launches": dict(cuda_lib.LAUNCHES),
                "health_failures": eng.metrics.snapshot()["health_failures"]}

    for kv_quant in (False, True):
        kv = "int8" if kv_quant else "bf16"
        t0 = time.perf_counter()
        eng = BatchedEngine(config, params, max_batch=B, max_seq=512,
                            chunk=16, mesh=mesh, tp_fused_decode=True,
                            kv_quant=kv_quant)
        setup = time.perf_counter() - t0
        check(eng._tp_fused and not eng._fused_decode
              and not eng._prefill_fused and not eng._paged_kv
              and eng.cache_dtype == (torch.int8 if kv_quant
                                      else torch.bfloat16),
              f"TP BatchedEngine ({kv}): the TP route is not the one live")
        rng = np.random.default_rng(0)
        eng.serve(uniform_reqs(rng, V, 4, Request), greedy)   # warm-up
        rec = serve(eng, uniform_reqs(rng, V, 3 * B, Request), greedy)
        rec["engine_setup_s"] = setup
        rec["teacher_forced_worst_err_over_tol"] = tp_teacher_forced(
            eng, mesh, np.random.default_rng(5), kv_quant, 4)
        out["serves"][kv] = rec
        del eng
    eng = BatchedEngine(config, params, max_batch=B, max_seq=512, chunk=16,
                        mesh=mesh, tp_fused_decode=True)
    out["serves"]["mixed"] = serve(
        eng, mixed_reqs(np.random.default_rng(1), V, B, Request),
        GenerationParams(temp=0.0, stop_at_eos=False, seed=3))
    out["failures"] = FAILURES
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def phase_tp_serving(c: Ctx, path: str, smi: str) -> None:
    """TP serving through two ranks that share the card: the launcher
    (``python -m biogpt_tpu_torch.parallel.distributed``) starts two
    processes of :func:`tp_rank` with gloo on cuda:0 (NCCL refuses two
    ranks on one device); the kernels were built before, so no rank builds.
    Both ranks must finish cleanly, agree on every id, launch exactly the
    TP route's kernels and trip no health check; each serve's greedy ids
    are counted against the single-device lockstep serve's. The ranks
    serve a random file of 347M's widths ``MESH_DEPTH`` layers deep (seed
    7), written here, whose lockstep references this process computes
    (:func:`mesh_references`); ``path`` (the main file) is not read. Their
    tokens/s measure the wiring of two processes on one card (every
    all-reduce crosses a process boundary through gloo), not TP speed."""
    import socket

    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.quant import codecs

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        path = os.path.join(tmp, f"biogpt347m-{MESH_DEPTH}layers.bin")
        write_random_quantized_model(
            path, dataclasses.replace(c.cfg, n_layer=MESH_DEPTH),
            codecs.GGML_TYPE_Q4_0, seed=7)
        lock = mesh_references(path)["lockstep"]
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "biogpt_tpu_torch.parallel.distributed",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(r), "--backend", "gloo", "--",
             os.path.join(here, "chip_smoke.py"), "--tp-rank", outs[r], path],
            cwd=here, stdout=sys.stderr, stderr=sys.stderr) for r in range(2)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(rcs == [0, 0], f"TP ranks exited {rcs}")
        if rcs != [0, 0]:
            return
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    log(f"TP serving, two ranks on one card ({MESH_DEPTH} layers): "
        f"{wall:.1f} s")
    check_tp_ranks(c, ranks, smi, lock)


def check_tp_ranks(c: Ctx, ranks: list, smi: str, lockstep: dict) -> None:
    """The two ranks' results (:func:`tp_rank`), as
    :func:`phase_tp_serving` says; ``lockstep``: the single-device
    lockstep serves' ids of the ranks' file, by cache."""
    card = torch.cuda.get_device_name(0)
    for r in ranks:
        for fail in r["failures"]:
            check(False, f"TP rank {r['rank']}: {fail}")
    for kv in ("bf16", "int8", "mixed"):
        a, b = ranks[0]["serves"][kv], ranks[1]["serves"][kv]
        n = 3 * 32 if kv != "mixed" else 32
        check(a["ids"] == b["ids"], f"TP serve ({kv}): the ranks' ids differ")
        check(len(a["ids"]) == n and all(t == 48 for t in a["new_tokens"])
              and all(0 <= t < c.cfg.n_vocab for ids in a["ids"].values()
                      for t in ids)
              and a["health_failures"] == 0 == b["health_failures"],
              f"TP serve ({kv}): {len(a['ids'])} results, tokens "
              f"{sorted(set(a['new_tokens']))}, health failures "
              f"{a['health_failures']}, {b['health_failures']}")
        route = TP_ROUTES[kv == "int8"]
        launched_exactly(c, a["launches"], route, set(),
                         f"TP serve ({kv}) rank 0", "q4_0")
        got = sorted(k for k, v in b["launches"].items() if v)
        check(set(got) == route, f"TP serve ({kv}) rank 1: launched {got}")
        rec = {"serving_path": f"TP 2 ranks on one card ({kv})",
               "tp": 2, "backend": "gloo", "batch_slots": 32, "chunk": 16,
               "requests": len(a["ids"]), "new_tokens": sum(a["new_tokens"]),
               "wall_s": [a["wall_s"], b["wall_s"]],
               "tokens_per_s": sum(a["new_tokens"]) / a["wall_s"],
               "launches": {k: v for k, v in a["launches"].items() if v},
               "card": card, "card_stamp": smi}
        if kv != "mixed":
            lock = lockstep[kv]
            rec["greedy_ids_equal_lockstep"] = sum(
                a["ids"][str(i)] == lock[i] for i in lock)
            rec["teacher_forced_worst_err_over_tol"] = [
                r["serves"][kv]["teacher_forced_worst_err_over_tol"]
                for r in ranks]
            rec["engine_setup_s"] = [r["serves"][kv]["engine_setup_s"]
                                     for r in ranks]
            rec["all_reduce_ms"] = [r["all_reduce_ms"] for r in ranks]
        print(json.dumps(rec), flush=True)


def phase_tp_one_by_one(c: Ctx, path: str, smi: str) -> None:
    """A (1, 1) mesh, which needs no process group: the TP engine serves
    the uniform 96 greedy requests in this process through the TP halves
    at full width, launching exactly their route (its ids counted against
    the lockstep serve's), and the TP ``Engine`` generates 32 greedy tokens
    at B=1 (its ids counted against the single-device engine's)."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.parallel import make_mesh
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    config, _, _, params = load_params(path, device="cpu")
    mesh = make_mesh(1, 1, device="cuda")
    eng = BatchedEngine(config, params, max_batch=32, max_seq=512, chunk=16,
                        mesh=mesh, tp_fused_decode=True)
    check(eng._tp_fused and not eng._fused_decode and mesh.group is None,
          "(1, 1) mesh: the TP route is not the one live")
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    rng = np.random.default_rng(0)
    eng.serve(uniform_reqs(rng, config.n_vocab, 4, Request), greedy)
    reqs = uniform_reqs(rng, config.n_vocab, 96, Request)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.serve(reqs, greedy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.new_ids) for r in res.values())
    check(len(res) == 96 and all(len(r.new_ids) == 48 for r in res.values())
          and eng.metrics.snapshot()["health_failures"] == 0,
          f"(1, 1) mesh serve: {len(res)} results, {n_tok} tokens")
    launched_exactly(c, dict(cuda_lib.LAUNCHES), TP_ROUTES[False], set(),
                     "(1, 1) mesh serve", "q4_0")
    lock = c.lockstep_ids["bf16"]
    print(json.dumps({
        "serving_path": "TP (1, 1) mesh", "batch_slots": 32, "chunk": 16,
        "requests": len(res), "new_tokens": n_tok, "wall_s": wall,
        "serve_uniform_greedy_tokens_per_s": n_tok / wall,
        "greedy_ids_equal_lockstep": sum(res[i].ids == lock[i] for i in lock),
        "card": torch.cuda.get_device_name(0), "card_stamp": smi}),
        flush=True)
    del eng

    # the single stream on the same mesh: B=1 halves, the per-slot commit
    prompt = [2] + list(range(40, 52))
    gen = GenerationParams(n_predict=32, temp=0.0, stop_at_eos=False)
    want = Engine(config, params).generate(prompt, gen).ids
    cuda_lib.reset_launch_counts()
    got = Engine(config, params, mesh=mesh, tp_fused_decode=True).generate(
        prompt, gen).ids
    torch.cuda.synchronize()
    launched_exactly(c, dict(cuda_lib.LAUNCHES),
                     {"tp_attn_half", "tp_ffn_half", "qmatmul"},
                     {"qmatmul_wide"}, "(1, 1) mesh generate", "q4_0")
    check(len(got) == len(prompt) + 32, f"(1, 1) mesh generate: {len(got)} ids")
    print(json.dumps({"generate_path": "TP (1, 1) mesh", "new_tokens": 32,
                      "ids_equal_single_device": sum(
                          a == b for a, b in zip(got, want)) - len(prompt)}),
          flush=True)


# ------------------------- 11a. the data axis and the sharded route on meshes

# the mesh of each rank job of phase 11a: "2x2" four ranks, "pairs" two
MESH_JOBS = {"2x2": 4, "pairs": 2}
# the model of phase 11's ranks and phase 11a's: 347M's widths this many
# layers deep (their runs are wiring through gloo, not speed)
MESH_DEPTH = 4
# the sharded route's logits against the single device's: sums in another
# order (TF32 off), within this fraction of their magnitude
SHARDED_LOGITS_TOL = 1e-3


# the port's kernels that the script's route checks and the TP route's
# launches name; :func:`port_kernel_names` must find every one of them
ROUTE_KERNELS = (
    "qmatmul_kernel", "qgemv_stream_kernel", "qgemv_mma_kernel",
    "qgemv_b1_kernel", "row_stats_kernel", "ln_rows_kernel",
    "attn_batched_kernel", "attn_paged_kernel", "row_absmax_kernel",
    "kv_commit_kernel", "kv_commit_quant_kernel",
    "kv_commit_quant_rows_kernel", "lm_head_mma_kernel",
    "argmax_fold_kernel", "gmax_pair_kernel", "prefill_gemm_kernel",
    "causal_attn_kernel")


def global_name(text: str, i: int) -> str | None:
    """The name of the kernel whose ``__global__`` ends at ``text[i]``: the
    first word followed by a parameter list, past the return type and a
    ``__launch_bounds__(...)`` of any nesting."""
    import re

    word = re.compile(r"\s*(\w+)\s*")
    while True:
        m = word.match(text, i)
        if m is None:
            return None
        i = m.end()
        if not text.startswith("(", i):
            continue
        if m.group(1) != "__launch_bounds__":
            return m.group(1)
        depth = 0
        for i in range(i, len(text)):
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            if depth == 0:
                break
        i += 1


def port_kernel_names() -> list:
    """Every ``__global__`` function of the port's CUDA sources. Fails the
    run where a ``__global__`` yields no name, or where a kernel of
    ``ROUTE_KERNELS`` is not among them."""
    import glob
    import re

    here = os.path.dirname(os.path.abspath(__file__))
    names, n_global = [], 0
    for src in sorted(glob.glob(os.path.join(here, "biogpt_tpu_torch", "csrc",
                                             "*.cu*"))):
        with open(src) as f:
            text = f.read()
        for m in re.finditer(r"\b__global__\b", text):
            n_global += 1
            names.append(global_name(text, m.end()))
    missing = sorted(set(ROUTE_KERNELS) - set(names))
    check(None not in names and len(set(names)) == n_global and not missing,
          f"port kernel names: {len(set(names) - {None})} names for "
          f"{n_global} __global__ functions, {missing} not found")
    return sorted(set(names) - {None})


def weight_bytes(params: dict) -> dict:
    """Resident bytes of a params tree, by the sharded route's spec table
    (``parallel.sharding.param_pspecs``): the leaves it shards over the
    model axis (the projections' planes, the column-parallel biases, the
    lm_head) and the leaves it keeps whole (embeddings, LayerNorms, the
    row-parallel biases)."""
    from biogpt_tpu_torch.modelio.checkpoint import tree_map
    from biogpt_tpu_torch.parallel.sharding import param_pspecs

    def nbytes(tree) -> int:
        total = [0]
        tree_map(lambda a: total.__setitem__(0, total[0] + a.numel()
                                             * a.element_size()) or a, tree)
        return total[0]

    def split(tree, spec) -> int:
        if isinstance(spec, dict):
            return sum(split(tree[k], spec[k]) for k in spec)
        return nbytes(tree) if "model" in spec else 0
    sharded = split(params, param_pspecs(params))
    return {"sharded_by_spec": sharded, "whole": nbytes(params) - sharded}


def data_exchanges(BatchedEngine) -> dict:
    """Count the data axis' exchanges (``Mesh.gather_data``) of the serves
    that follow, and the refill waves (one ``_split_refill_groups`` call a
    wave) -> the live counts."""
    from biogpt_tpu_torch.parallel.mesh import Mesh

    counts = {"exchanges": 0, "waves": 0}
    gather, split = Mesh.gather_data, BatchedEngine._split_refill_groups

    def counted_gather(self, x, dim=0):
        counts["exchanges"] += 1
        return gather(self, x, dim)

    def counted_split(self, pairs):
        counts["waves"] += 1
        return split(self, pairs)
    Mesh.gather_data = counted_gather
    BatchedEngine._split_refill_groups = counted_split
    return counts


def mesh_rank(argv: list) -> int:
    """One rank of phase 11a (``chip_smoke.py --mesh-rank JOB OUT MODEL``,
    started by :func:`phase_mesh_serving` through the port's launcher with
    gloo, every rank on cuda:0). JOB "2x2": four ranks of a (2, 2) mesh
    serve the uniform 96 greedy requests at B=32 through
    ``BatchedEngine(mesh, tp_fused_decode=True)`` with a bf16 and an int8
    cache (teacher-forced TP steps at the local batch after each, then the
    local-batch probes: a replica's 16 of 32 prompts padded to 32, and its
    2 of a group of 4 padded to 8) and a mixed serve. JOB "pairs": two
    ranks run ``Engine(mesh=(2, 1)).generate`` at B=1, then the sharded
    route of unpacked weights on a
    (1, 2) mesh (``pack_q4=False``, f32): a traced 16-token greedy
    generate (its Chrome trace beside OUT), the scores of the
    single-device engine's ids and a serve of 8 requests against that
    engine on this card, and the resident weight bytes, by the spec table
    and by the allocator. Its records and failures go to OUT as JSON."""
    import re

    import numpy as np
    import torch.distributed as dist

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.parallel import make_mesh
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request
    from biogpt_tpu_torch.utils.profiling import device_memory_stats

    job, out_path, path = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    config, _, _, params = load_params(path, device="cpu")
    V = config.n_vocab
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    out = {"rank": dist.get_rank(), "job": job}
    counts = data_exchanges(BatchedEngine)

    def serve(eng, reqs, gen):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        counts.update(exchanges=0, waves=0)
        chunks0 = eng.metrics.snapshot()["chunks_launched"]
        t0 = time.perf_counter()
        res = eng.serve(reqs, gen)
        torch.cuda.synchronize()
        snap = eng.metrics.snapshot()
        return {"wall_s": time.perf_counter() - t0,
                "ids": {str(i): r.ids for i, r in res.items()},
                "new_tokens": [len(r.new_ids) for r in res.values()],
                "launches": dict(cuda_lib.LAUNCHES),
                "chunks": snap["chunks_launched"] - chunks0,
                "data_exchanges": counts["exchanges"],
                "refill_waves": counts["waves"],
                "health_failures": snap["health_failures"]}

    if job == "2x2":
        mesh = make_mesh(2, 2, device="cuda:0")
        B = 32
        out["place"] = [mesh.data_index, mesh.index]
        out["serves"] = {}
        for kv_quant in (False, True):
            kv = "int8" if kv_quant else "bf16"
            eng = BatchedEngine(config, params, max_batch=B, max_seq=512,
                                chunk=16, mesh=mesh, tp_fused_decode=True,
                                kv_quant=kv_quant)
            check(eng._tp_fused and not eng._fused_decode
                  and eng.cache_dtype == (torch.int8 if kv_quant
                                          else torch.bfloat16),
                  f"(2, 2) BatchedEngine ({kv}): the TP route is not live")
            rng = np.random.default_rng(0)   # phase 11's requests, whose
            uniform_reqs(rng, V, 4, Request)   # warm-up this phase skips
            rec = serve(eng, uniform_reqs(rng, V, 3 * B, Request), greedy)
            rec["cache_shape"] = list(eng.new_cache().k.shape)
            rec["B_local"] = eng.B_local
            rec["teacher_forced_worst_err_over_tol"] = tp_teacher_forced(
                eng, mesh, np.random.default_rng(5), kv_quant, 4)
            rec["local_batch_16_vs_32"] = local_batch_probe(
                eng, np.random.default_rng(6), replica=True)
            # a group of 4 prompts padded to 8 (32 rows x tokens: the
            # dequantize-then-dot form) as a replica's 2 (16: the other
            # form on their own) against the whole group
            rec["local_batch_2_vs_4x8"] = local_batch_probe(
                eng, np.random.default_rng(8), steps=0, replica=True,
                rows=4, padded=8)
            out["serves"][kv] = rec
            del eng
        eng = BatchedEngine(config, params, max_batch=B, max_seq=512,
                            chunk=16, mesh=mesh, tp_fused_decode=True)
        out["serves"]["mixed"] = serve(
            eng, mixed_reqs(np.random.default_rng(1), V, B, Request),
            GenerationParams(temp=0.0, stop_at_eos=False, seed=3))
    else:
        # (b) the data axis at B=1: the generate runs whole on each replica
        mesh = make_mesh(2, 1, device="cuda:0")
        prompt = [2] + list(range(40, 52))
        gen = GenerationParams(n_predict=32, temp=0.0, stop_at_eos=False)
        cuda_lib.reset_launch_counts()
        out["generate_2x1"] = Engine(config, params, mesh=mesh,
                                     tp_fused_decode=True).generate(
            prompt, gen).ids
        torch.cuda.synchronize()
        out["generate_2x1_launches"] = dict(cuda_lib.LAUNCHES)
        # (c) the sharded route on (1, 2), against the single device
        mesh = make_mesh(1, 2, device="cuda:0")
        # (d) the (1, 2) TP serves of the "2x2" job's uniform requests, the
        # ids its (2, 2) serves are counted against
        out["serves_1x2"] = {}
        for kv_quant in (False, True):
            eng = BatchedEngine(config, params, max_batch=32, max_seq=512,
                                chunk=16, mesh=mesh, tp_fused_decode=True,
                                kv_quant=kv_quant)
            rng = np.random.default_rng(0)
            uniform_reqs(rng, V, 4, Request)
            out["serves_1x2"]["int8" if kv_quant else "bf16"] = serve(
                eng, uniform_reqs(rng, V, 96, Request), greedy)["ids"]
            del eng
        kw = dict(compute_dtype=torch.float32, pack_q4=False)

        def in_use() -> int:
            torch.cuda.synchronize()
            return device_memory_stats()["cuda:0"]["bytes_in_use"]
        mem = [in_use()]
        single = Engine(config, params, **kw)
        mem.append(in_use())
        sharded = Engine(config, params, mesh=mesh, **kw)
        mem.append(in_use())
        # this process's allocations on the card that each engine added
        out["resident_bytes"] = {"single": mem[1] - mem[0],
                                 "rank": mem[2] - mem[1]}
        check(not sharded.allow_kernels and not sharded._tp_fused
              and sharded._kv_shards == 2,
              "(1, 2) sharded Engine: the route of unpacked weights is not "
              "the one live")
        out["weight_bytes"] = {"rank": weight_bytes(sharded.params),
                               "single": weight_bytes(single.params)}
        gen16 = GenerationParams(n_predict=16, temp=0.0, stop_at_eos=False)
        ids = {}
        launched = {}
        log_dir = os.path.join(os.path.dirname(out_path),
                               f"trace_rank{out['rank']}")
        names = kernel_trace(
            lambda: ids.update(sharded=sharded.generate(prompt, gen16).ids),
            counted=launched, log_dir=log_dir)
        ids["single"] = single.generate(prompt, gen16).ids
        port = [re.compile(rf"\b{p}\b") for p in port_kernel_names()]

        def of_port(names) -> list:
            return sorted({n for n in names if any(p.search(n)
                                                   for p in port)})
        # the same window as exported, Chrome's trace format
        with open(os.path.join(log_dir, "trace.json")) as f:
            exported = [e["name"] for e in json.load(f)["traceEvents"]
                        if e.get("cat") == "kernel"]
        out["sharded_trace"] = {
            "kernels": len(names), "launches": sum(v[0] for v in
                                                   names.values()),
            "port_kernels": of_port(names),
            "exported_kernel_events": len(exported),
            "exported_port_kernels": of_port(exported),
            "wrapper_launches": sum(launched.values())}
        out["generate_ids"] = ids
        ref = ids["single"]
        lg_sh = sharded.logits(ref)[0]
        lg_ref = single.logits(ref)[0]
        mag = lg_ref.abs().amax(-1)
        top2 = torch.topk(lg_ref, 2).values
        out["logits"] = {
            "err_over_mag": ((lg_sh - lg_ref).abs().amax(-1) / mag).max()
            .item(),
            "decided": (top2[:, 0] - top2[:, 1]
                        > SHARDED_LOGITS_TOL * mag).tolist(),
            "argmax_equal": (lg_sh.argmax(-1) == lg_ref.argmax(-1)).tolist(),
            "prompt_len": len(prompt)}
        # a serve of 8 requests, per op and without kernels on both sides
        reqs = uniform_reqs(np.random.default_rng(2), V, 8, Request)
        bkw = dict(max_batch=8, max_seq=512, chunk=16, **kw)
        res_sh = serve(BatchedEngine(config, params, mesh=mesh, **bkw), reqs,
                       greedy)
        res_ref = BatchedEngine(config, params, **bkw).serve(reqs, greedy)
        div = {}
        for i, r in res_ref.items():
            got = res_sh["ids"][str(i)]
            j = next((k for k, (a, b) in enumerate(zip(got, r.ids))
                      if a != b), None)
            if j is not None:   # the reference's margin where they part
                lg = single.logits(r.ids[:j])[0, -1]
                t2 = torch.topk(lg, 2).values
                div[str(i)] = {"step": j - r.prompt_len,
                               "margin_over_mag": ((t2[0] - t2[1])
                                                   / lg.abs().max()).item()}
        res_sh["divergences"] = div
        res_sh["requests"] = len(res_ref)
        out["sharded_serve"] = res_sh
    out["failures"] = FAILURES
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def mesh_phases(c: Ctx, smi: str) -> None:
    """``--mesh``: phases 9 (the lockstep serves, whose ids phases 11 and
    11a count against), 11 and 11a on a fresh 347M Q4_0 file."""
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.quant import codecs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "biogpt347m-q4_0.bin")
        write_random_quantized_model(path, c.cfg, codecs.GGML_TYPE_Q4_0, seed=7)
        for name, phase in (
                ("phase_serving bf16", phase_serving),
                ("phase_serving int8",
                 lambda *a: phase_serving(*a, kv_quant=True)),
                ("phase_tp_serving", phase_tp_serving),
                ("phase_tp_one_by_one", phase_tp_one_by_one),
                ("phase_mesh_serving", phase_mesh_serving)):
            t0 = time.perf_counter()
            phase(c, path, smi)
            log(f"{name}: {time.perf_counter() - t0:.1f} s")


def run_mesh_job(job: str, path: str) -> list:
    """Start ``MESH_JOBS[job]`` ranks of :func:`mesh_rank` through the
    port's launcher with gloo and return their records (None where a rank
    failed)."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    n = MESH_JOBS[job]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "biogpt_tpu_torch.parallel.distributed",
             "--coordinator", f"localhost:{port}", "--num-processes", str(n),
             "--process-id", str(r), "--backend", "gloo", "--",
             os.path.join(here, "chip_smoke.py"), "--mesh-rank", job,
             outs[r], path],
            cwd=here, stdout=sys.stderr, stderr=sys.stderr) for r in range(n)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(rcs == [0] * n, f"mesh job {job}: ranks exited {rcs}")
        ranks = []
        for o in outs:
            if os.path.exists(o):
                with open(o) as f:
                    ranks.append(json.load(f))
            else:
                ranks.append(None)
    for r in ranks:
        for fail in (r or {}).get("failures", []):
            check(False, f"mesh job {job} rank {r['rank']}: {fail}")
    return ranks


def mesh_references(path: str) -> dict:
    """In this process, on the file of phase 11a: the single-device
    lockstep serves of the uniform 96 greedy requests (bf16, int8) and the
    (1, 1) mesh engine's 32-token generate, the ids phase 11a counts and
    checks its ranks' against."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.parallel import make_mesh
    from biogpt_tpu_torch.runtime.engine import Engine
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    config, _, _, params = load_params(path, device="cpu")
    greedy = GenerationParams(temp=0.0, stop_at_eos=False)
    refs = {"n_layer": config.n_layer, "lockstep": {}}
    for kv_quant in (False, True):
        eng = BatchedEngine(config, params, max_batch=32, max_seq=512,
                            chunk=16, kv_quant=kv_quant)
        rng = np.random.default_rng(0)
        uniform_reqs(rng, config.n_vocab, 4, Request)
        res = eng.serve(uniform_reqs(rng, config.n_vocab, 96, Request),
                        greedy)
        refs["lockstep"]["int8" if kv_quant else "bf16"] = {
            i: r.ids for i, r in res.items()}
        del eng
    prompt = [2] + list(range(40, 52))
    refs["generate_1x1"] = Engine(
        config, params, mesh=make_mesh(1, 1, device="cuda"),
        tp_fused_decode=True).generate(prompt, GenerationParams(
            n_predict=32, temp=0.0, stop_at_eos=False)).ids
    torch.cuda.synchronize()
    return refs


def phase_mesh_serving(c: Ctx, path: str, smi: str) -> None:
    """Phase 11a: the data axis and the sharded route of unpacked weights
    on a random file of 347M's widths ``MESH_DEPTH`` layers deep (seed 7),
    every rank a process on the one card (gloo; the kernels were built
    before): (a) a (2, 2) mesh of four ranks through :func:`mesh_rank`
    "2x2", checked by :func:`check_mesh_2x2`; (b, c, d) two ranks through
    "pairs", checked by :func:`check_mesh_pairs`; the references of that
    depth from this process (:func:`mesh_references`). Their tokens/s
    measure the wiring of processes on one card through gloo, not the data
    axis' speed. ``path`` (the main file) is not read: the phase writes
    its own."""
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.quant import codecs

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_file_") as tmp:
        mesh_path = os.path.join(tmp, f"biogpt347m-{MESH_DEPTH}layers.bin")
        write_random_quantized_model(
            mesh_path, dataclasses.replace(c.cfg, n_layer=MESH_DEPTH),
            codecs.GGML_TYPE_Q4_0, seed=7)
        t0 = time.perf_counter()
        refs = mesh_references(mesh_path)
        t1 = time.perf_counter()
        ranks = run_mesh_job("2x2", mesh_path)
        t2 = time.perf_counter()
        pairs = run_mesh_job("pairs", mesh_path)
        t3 = time.perf_counter()
    if all(pairs):
        refs["tp_1x2"] = pairs[0]["serves_1x2"]
        check_mesh_pairs(c, pairs, smi, refs)
    if all(ranks):
        check_mesh_2x2(c, ranks, smi, refs)
    log(f"mesh serving ({MESH_DEPTH} layers): references {t1 - t0:.1f} s, "
        f"(2, 2) job {t2 - t1:.1f} s, (2, 1) + (1, 2) job {t3 - t2:.1f} s")


def check_mesh_2x2(c: Ctx, ranks: list, smi: str, refs: dict) -> None:
    """The four ranks of the (2, 2) job: each at (r // 2, r % 2); every
    serve's ids equal on all four, every request's 48 tokens, no health
    failure; each rank's cache 16 slots of D / 2 features; each rank
    launched exactly the TP route's kernels (counted on the ``kernels``
    line for rank 0, as phase 11 counts its rank 0); one data-axis
    exchange a chunk and one a refill wave; the uniform serves' ids
    counted against the "pairs" job's (1, 2) serve (with the step at which
    each request leaves it) and the lockstep serve of the same file
    (``refs``, :func:`phase_mesh_serving`); each rank's local-batch probes
    held (:func:`probe_held`), every op of a replica's 2 rows of a 4 x 8
    group bit-equal to the whole group's."""
    card = torch.cuda.get_device_name(0)
    cfg = c.cfg
    for r in ranks:
        check(r["place"] == [r["rank"] // 2, r["rank"] % 2],
              f"(2, 2) rank {r['rank']} at {r['place']}")
    for kv in ("bf16", "int8", "mixed"):
        recs = [r["serves"][kv] for r in ranks]
        a = recs[0]
        n = 3 * 32 if kv != "mixed" else 32
        check(all(x["ids"] == a["ids"] for x in recs),
              f"(2, 2) serve ({kv}): the ranks' ids differ")
        check(len(a["ids"]) == n and all(t == 48 for t in a["new_tokens"])
              and all(0 <= t < cfg.n_vocab for ids in a["ids"].values()
                      for t in ids)
              and all(x["health_failures"] == 0 for x in recs),
              f"(2, 2) serve ({kv}): {len(a['ids'])} results, tokens "
              f"{sorted(set(a['new_tokens']))}")
        route = TP_ROUTES[kv == "int8"]
        launched_exactly(c, a["launches"], route, set(),
                         f"(2, 2) serve ({kv}) rank 0", "q4_0")
        for x, r in zip(recs[1:], ranks[1:]):
            got = sorted(k for k, v in x["launches"].items() if v)
            check(set(got) == route,
                  f"(2, 2) serve ({kv}) rank {r['rank']}: launched {got}")
        for x, r in zip(recs, ranks):
            check(x["data_exchanges"] == x["chunks"] + x["refill_waves"]
                  and x["chunks"] > 0,
                  f"(2, 2) serve ({kv}) rank {r['rank']}: "
                  f"{x['data_exchanges']} data-axis exchanges for "
                  f"{x['chunks']} chunks and {x['refill_waves']} waves")
        rec = {"serving_path": f"(2, 2) mesh, 4 ranks on one card ({kv})",
               "data": 2, "tp": 2, "backend": "gloo", "batch_slots": 32,
               "chunk": 16, "requests": len(a["ids"]),
               "new_tokens": sum(a["new_tokens"]),
               "wall_s": [x["wall_s"] for x in recs],
               "tokens_per_s": sum(a["new_tokens"]) / a["wall_s"],
               "chunks": a["chunks"], "refill_waves": a["refill_waves"],
               "data_exchanges": a["data_exchanges"],
               "launches": {k: v for k, v in a["launches"].items() if v},
               "card": card, "card_stamp": smi}
        if kv != "mixed":
            want = [refs["n_layer"], 16, 512, cfg.d_model // 2]
            for x, r in zip(recs, ranks):
                check(x["cache_shape"] == want and x["B_local"] == 16,
                      f"(2, 2) serve ({kv}) rank {r['rank']}: cache "
                      f"{x['cache_shape']}, {x['B_local']} local slots")
            rec["cache_shape"] = a["cache_shape"]
            tp_ids, lock = refs["tp_1x2"].get(kv, {}), refs["lockstep"][kv]
            rec["greedy_ids_equal_tp_1x2"] = sum(
                a["ids"][i] == tp_ids.get(i) for i in a["ids"])
            # where a request's ids leave the (1, 2) serve's: the new
            # token's step (0: the refill's first token) -> requests
            steps = {}
            for i, ids in a["ids"].items():
                other = tp_ids.get(i)
                if other is not None and ids != other:
                    j = next(k for k, (x, y) in enumerate(zip(ids, other))
                             if x != y)
                    step = str(j - (len(ids) - 48))
                    steps[step] = steps.get(step, 0) + 1
            rec["first_step_leaving_tp_1x2"] = dict(
                sorted(steps.items(), key=lambda kv: int(kv[0])))
            rec["greedy_ids_equal_lockstep"] = sum(
                a["ids"][str(i)] == lock[i] for i in lock)
            rec["teacher_forced_worst_err_over_tol"] = [
                x["teacher_forced_worst_err_over_tol"] for x in recs]
            rec["local_batch_16_vs_32"] = a["local_batch_16_vs_32"]
            rec["local_batch_2_vs_4x8"] = a["local_batch_2_vs_4x8"]
            for x, r in zip(recs, ranks):
                probe_held(x["local_batch_16_vs_32"],
                           f"(2, 2) TP route ({kv}) rank {r['rank']}",
                           steps=True, form=False)
                small = x["local_batch_2_vs_4x8"]
                probe_held(small, f"(2, 2) TP route ({kv}) rank "
                           f"{r['rank']}, a replica's 2 of a 4 x 8 group",
                           steps=False, form=False)
                check(small["ops"]["first_differing"] is None,
                      f"(2, 2) TP route ({kv}) rank {r['rank']}: a "
                      f"replica's 2 of a 4 x 8 group differ from the group "
                      f"at op {small['ops']['first_differing']}")
        print(json.dumps(rec), flush=True)


def check_mesh_pairs(c: Ctx, ranks: list, smi: str, refs: dict) -> None:
    """The two ranks of the "pairs" job. (b) ``Engine(mesh=(2, 1))
    .generate`` at B=1: the ids of phase 11's (1, 1) mesh engine on both
    ranks, through the TP step's halves (counted on the ``kernels`` line).
    (c) the sharded route on (1, 2): no launch of the port's kernels in
    its trace, the trace's Chrome export or its wrappers' counts; the
    scores of the single-device
    engine's ids within ``SHARDED_LOGITS_TOL`` of their magnitude, argmax
    equal wherever the reference's top-2 margin exceeds that; the
    generate's ids equal up to the first undecided step; the serve's ids,
    where they leave the single device's, left it at a margin within the
    limit; the projections' and lm_head's resident bytes halved on each
    rank, the embeddings and norms whole, and the allocator's bytes that
    each engine added (``utils.profiling.device_memory_stats``) at least
    its weights' and fewer on a rank than on the single device."""
    a, b = ranks
    want = refs["generate_1x1"]
    for r in ranks:
        check(r["serves_1x2"] == a["serves_1x2"],
              f"(1, 2) serves rank {r['rank']}: the ranks' ids differ")
        check(r["generate_2x1"] == want,
              f"(2, 1) generate rank {r['rank']}: ids differ from the "
              "(1, 1) mesh engine's")
    launched_exactly(c, a["generate_2x1_launches"],
                     {"tp_attn_half", "tp_ffn_half", "qmatmul"},
                     {"qmatmul_wide"}, "(2, 1) generate", "q4_0")
    for r in ranks:
        tr = r["sharded_trace"]
        check(tr["port_kernels"] == [] and tr["wrapper_launches"] == 0
              and tr["launches"] > 0 and tr["exported_port_kernels"] == []
              and tr["exported_kernel_events"] > 0,
              f"(1, 2) sharded generate rank {r['rank']}: port kernels "
              f"{tr['port_kernels']}, wrapper launches "
              f"{tr['wrapper_launches']} in a trace of {tr['launches']}; "
              f"exported: port kernels {tr['exported_port_kernels']} in "
              f"{tr['exported_kernel_events']} kernel events")
        lg = r["logits"]
        check(lg["err_over_mag"] <= SHARDED_LOGITS_TOL,
              f"(1, 2) sharded scores rank {r['rank']}: "
              f"{lg['err_over_mag']} of their magnitude")
        bad = [i for i, (d, e) in enumerate(zip(lg["decided"],
                                                lg["argmax_equal"]))
               if d and not e]
        check(not bad, f"(1, 2) sharded scores rank {r['rank']}: argmax "
              f"differs at decided positions {bad}")
        ids = r["generate_ids"]
        p = lg["prompt_len"]
        first = next((j for j, (x, y) in enumerate(zip(ids["sharded"],
                                                        ids["single"]))
                      if x != y), None)
        check(first is None or not lg["decided"][first - 1],
              f"(1, 2) sharded generate rank {r['rank']}: leaves the "
              f"single device at a decided step {first - p if first else 0}")
        srv = r["sharded_serve"]
        check(all(d["margin_over_mag"] <= SHARDED_LOGITS_TOL
                  for d in srv["divergences"].values())
              and srv["health_failures"] == 0 and srv["launches"]
              and not any(srv["launches"].values()),
              f"(1, 2) sharded serve rank {r['rank']}: divergences "
              f"{srv['divergences']}, launches "
              f"{ {k: v for k, v in srv['launches'].items() if v} }")
        wb, rb = r["weight_bytes"], r["resident_bytes"]
        check(2 * wb["rank"]["sharded_by_spec"]
              == wb["single"]["sharded_by_spec"]
              and wb["rank"]["whole"] == wb["single"]["whole"],
              f"(1, 2) sharded rank {r['rank']}: resident bytes {wb}")
        check(sum(wb["rank"].values()) <= rb["rank"] < rb["single"]
              and sum(wb["single"].values()) <= rb["single"],
              f"(1, 2) sharded rank {r['rank']}: the allocator's bytes {rb} "
              f"against the weights' {wb}")
    check(a["sharded_serve"]["ids"] == b["sharded_serve"]["ids"]
          and a["generate_ids"] == b["generate_ids"],
          "(1, 2) sharded route: the ranks' ids differ")
    srv = a["sharded_serve"]
    print(json.dumps({
        "mesh_path": "(2, 1) generate and (1, 2) sharded route, 2 ranks on "
                     "one card", "backend": "gloo",
        "generate_2x1_ids_equal_1x1": [r["generate_2x1"] == want
                                       for r in ranks],
        "sharded_logits_err_over_mag": [r["logits"]["err_over_mag"]
                                        for r in ranks],
        "sharded_generate_ids_equal_single": sum(
            x == y for x, y in zip(a["generate_ids"]["sharded"],
                                   a["generate_ids"]["single"]))
        - a["logits"]["prompt_len"],
        "sharded_serve_requests": srv["requests"],
        "sharded_serve_ids_equal_single": srv["requests"]
        - len(srv["divergences"]),
        "sharded_serve_divergences": srv["divergences"],
        "sharded_serve_wall_s": srv["wall_s"],
        "sharded_trace_launches": a["sharded_trace"]["launches"],
        "sharded_trace_exported_kernel_events": a["sharded_trace"][
            "exported_kernel_events"],
        "weight_bytes": [r["weight_bytes"] for r in ranks],
        "resident_bytes": [r["resident_bytes"] for r in ranks],
        "card": torch.cuda.get_device_name(0), "card_stamp": smi}),
        flush=True)


# ------------------------------------------------------------------- main

# ------------------------------------- the 9-32-row GEMV and M <= 8 tails

# ------------------------------------- the batched steps' attention, by mode

BREAKDOWN_MODES = ("lockstep bf16", "lockstep int8", "paged bf16",
                   "paged int8", "staged bf16")
# the staged steps' chunk and step (tools/kernel_bounds.py's STAGE_ROWS,
# STEP_I)
BREAKDOWN_STAGE = (16, 7)
# the fall of the scores from one KV block to the next in the held cases
# with constant scores a block (attn_operands' block_steps): exact in bf16
# and, over 16, in f32; of the steps k/128 it is the one whose local_max
# fault reads highest in all three modes (attn_expect), no row of its p
# lying in a flip band
BLOCK_STEP = 0.265625


def serve_past(B: int) -> list:
    """Positions of the uniform serve's slots: a 5-24-token prompt with up
    to 48 new tokens (5..72), spread over the B slots."""
    return [5 + (37 * b) % 68 for b in range(B)]


def breakdown_shapes(c: Ctx) -> dict:
    """name -> (B, window, cache rows S, per-slot positions)."""
    return {"B=32 window 512 ragged": (32, 512, c.cfg.n_positions,
                                       ragged_past(32, dead=(7, 19))),
            "serve B=32 window 128": (32, 128, 512, serve_past(32))}


def is_attention(kernel: str) -> bool:
    """A kernel of a decode step's attention: the batched steps' own, the
    B=1 and TP chains' paged CTA, or an absmax launch beside them."""
    return "attn" in kernel or "row_absmax" in kernel


def sdpa_call(c: Ctx, B: int, W: int, S: int, past: list,
              layers: int | None = None):
    """The attention of a step's ``layers`` layers (all 24 by default) as
    one library call a layer:
    ``scaled_dot_product_attention`` with q (B, H, 1, 64) bf16, K and V
    views (B, H, W, 64) of (B, S, D) bf16 cache rows and a boolean mask of
    each slot's live rows plus the row that stands for its current token
    (row min(past, W - 1)) -> a function of no arguments. It reads the same
    rows as a step's attention (bf16; for the int8 modes the same rows in
    bf16) and is only timed."""
    cfg, dev = c.cfg, c.dev
    D, H = cfg.d_model, cfg.n_head
    L = cfg.n_layer if layers is None else layers
    kc = c.randn(L, B, S, D).to(torch.bfloat16)
    vc = c.randn(L, B, S, D).to(torch.bfloat16)
    q = c.randn(B, H, 1, D // H).to(torch.bfloat16)
    last = torch.tensor([min(p, W - 1) for p in past], device=dev)
    mask = (torch.arange(W, device=dev)[None, :] <= last[:, None])
    mask = mask[:, None, None, :]

    def heads(t, lyr):
        return t[lyr, :, :W].view(B, W, H, D // H).transpose(1, 2)

    def run():
        return [torch.nn.functional.scaled_dot_product_attention(
            q, heads(kc, lyr), heads(vc, lyr), attn_mask=mask)
            for lyr in range(L)]
    return run


def attn_exposed_ms(seq: list) -> float:
    """The attention's time on a step's critical path, from a trace's
    records in start order (:func:`kernel_trace`): for each layer, from
    the end of the qkv GEMV (the last GEMV to start before the layer's
    attention kernels) to the end of the last of them. A kernel that
    starts early and streams while the GEMV runs shows only what it adds
    after the GEMV; its device span also holds its wait."""
    total, gemv_end, attn_end = 0.0, None, None
    for name, start, ms in seq:
        end = start + ms * 1e3   # us
        if "qgemv_mma_kernel" in name:
            if attn_end is not None:
                total += attn_end - gemv_end
                attn_end = None
            gemv_end = end
        elif is_attention(name) and gemv_end is not None:
            attn_end = end if attn_end is None else max(attn_end, end)
    if attn_end is not None:
        total += attn_end - gemv_end
    return total / 1e3


def step_breakdown(c: Ctx, smi: str, mode: str, shape: str, layers,
                   sdpa: dict) -> dict:
    """One batched step of ``mode`` at ``shape`` (:func:`breakdown_shapes`)
    on Q4_0 planes ``layers``: its device and host ms (:func:`time_ms`), a
    trace of its kernels with the attention's launches and the sum of
    their device spans, and the library call's time for the same rows
    (:func:`sdpa_call`, cached per shape in ``sdpa``) -> the record,
    printed as a ``step_breakdown`` line. Its ``attn_exposed_ms`` is the
    attention's share of the critical path (:func:`attn_exposed_ms`)."""
    from biogpt_tpu_torch.ops.decode_kernels import decode_step_fused

    cfg, dev = c.cfg, c.dev
    D, L, H = cfg.d_model, cfg.n_layer, cfg.n_head
    B, W, S, past = breakdown_shapes(c)[shape]
    kw = {}
    if mode.endswith("int8"):
        kc, ks = rand_int8_cache(c, L, B, S)
        vc, vs = rand_int8_cache(c, L, B, S)
        kw.update(k_scales=ks, v_scales=vs)
    else:
        kc = c.randn(L, B, S, D).to(torch.bfloat16)
        vc = c.randn(L, B, S, D).to(torch.bfloat16)
    if mode.startswith("paged"):
        kw["per_slot_kv"] = True
    if mode.startswith("staged"):
        C, step_i = BREAKDOWN_STAGE
        past = [p + step_i for p in past]
        kw.update(k_stage=c.randn(L, B, C, D).to(torch.bfloat16),
                  v_stage=c.randn(L, B, C, D).to(torch.bfloat16),
                  step_i=step_i)
    x0 = c.randn(B, D)
    pt = torch.tensor(past, dtype=torch.int32, device=dev)

    def run():
        return decode_step_fused(x0, layers, kc, vc, pt, n_head=H, window=W,
                                 ln_eps=cfg.ln_eps, **kw)
    rec = {"step_breakdown": mode, "shape": shape, "B": B, "window": W,
           "past": past, "format": "q4_0", "step_ms": time_ms(run, 20),
           "step_ms_range": SPREAD[run], "step_host_ms": HOST[run]["host_ms"]}
    seq = []
    names = kernel_trace(run, seq)
    attn = {k: v for k, v in names.items() if is_attention(k)}
    rec.update(attn_kernels=attn,
               attn_launches=sum(v[0] for v in attn.values()),
               attn_span_ms=sum(v[1] for v in attn.values()),
               attn_exposed_ms=attn_exposed_ms(seq),
               gemv_span_ms=span_ms(names, "qgemv_mma_kernel"),
               kernels=names)
    key = (shape, mode.startswith("staged"))
    if key not in sdpa:
        fn = sdpa_call(c, B, W, S, past)
        sdpa[key] = (time_ms(fn, 10), HOST[fn]["host_ms"])
    rec["sdpa_ms"], rec["sdpa_host_ms"] = sdpa[key]
    rec.update(card=torch.cuda.get_device_name(0), card_stamp=smi)
    print(json.dumps(rec), flush=True)
    return rec


def smi_clock() -> str:
    """The card's SM clock, power draw, temperature and active throttle
    reasons, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def step_spread(c: Ctx, smi: str) -> dict:
    """Where the lockstep bf16 step's timing windows spread (B=32, window
    512, ragged, Q4_0; row 7): four rounds of 20 :func:`time_ms` windows,
    two on a card that has only run the step and two each right after a
    trace (:func:`kernel_trace`, as ``phase_serving_kernels`` times it
    after :func:`gemv_trace`), each with every window's record
    (``WINDOWS``: its ms, its call's host ms, its spin's ms and clock) and
    nvidia-smi's reading after the round; then 20 steps under one trace,
    each after such a spin, with each step's device span and the time no
    kernel of it ran, its attention's time after the qkv GEMVs
    (:func:`attn_exposed_ms`), its attention launches' summed and largest
    spans, and how late the latest starts after its qkv GEMV ends -> the
    record, printed as a ``step_spread`` line."""
    from torch.profiler import ProfilerActivity, profile

    from biogpt_tpu_torch.ops.decode_kernels import decode_step_fused
    from biogpt_tpu_torch.utils.profiling import spin_cycles

    cfg, dev = c.cfg, c.dev
    D, L, H = cfg.d_model, cfg.n_layer, cfg.n_head
    B, W, S, past = breakdown_shapes(c)["B=32 window 512 ragged"]
    layers, _ = c.rand_layers()
    kc = c.randn(L, B, S, D).to(torch.bfloat16)
    vc = c.randn(L, B, S, D).to(torch.bfloat16)
    x0 = c.randn(B, D)
    pt = torch.tensor(past, dtype=torch.int32, device=dev)

    def run():
        return decode_step_fused(x0, layers, kc, vc, pt, n_head=H, window=W,
                                 ln_eps=cfg.ln_eps)
    rounds = []
    for label in ("fresh", "fresh", "after a trace", "after a trace"):
        if label == "after a trace":
            kernel_trace(run)
        rounds.append({"round": label, "median_ms": time_ms(run, 20),
                       **WINDOWS[run], "smi_after": smi_clock()})
    cycles = spin_cycles(HOST[run]["host_ms"], spin_rate())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            run()
        torch.cuda.synchronize()
    recs = sorted(((ev.name, ev.time_range.start,
                    ev.time_range.elapsed_us() / 1e3)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r[1])
    steps, seg = [], None
    for r in recs:
        if "spin" in r[0] or "sleep" in r[0]:
            seg = []
            steps.append(seg)
        elif seg is not None:
            seg.append(r)
    per_step = []
    for seg in steps:
        if not seg:
            continue
        start = min(r[1] for r in seg)
        end = max(r[1] + r[2] * 1e3 for r in seg)
        attn, late, gemv_end = [], [], None
        for name, st, ms in seg:
            if "qgemv_mma_kernel" in name:
                gemv_end = st + ms * 1e3
            elif BATCHED_ATTN in name:
                attn.append(ms)
                if gemv_end is not None:
                    late.append((st - gemv_end) / 1e3)
        busy, reach = 0.0, start
        for _, st, ms in seg:
            busy += max(0.0, st + ms * 1e3 - max(st, reach))
            reach = max(reach, st + ms * 1e3)
        per_step.append({"span_ms": (end - start) / 1e3,
                         "idle_ms": (end - start - busy) / 1e3,
                         "attn_exposed_ms": attn_exposed_ms(seg),
                         "attn_span_ms": sum(attn),
                         "attn_longest_ms": max(attn, default=0.0),
                         "attn_latest_start_ms": max(late, default=0.0),
                         "attn_launches": len(attn)})
    rec = {"step_spread": "lockstep bf16 B=32 window 512 ragged q4_0",
           "rounds": rounds, "traced_steps": per_step,
           "card": torch.cuda.get_device_name(0), "card_stamp": smi}
    print(json.dumps(rec), flush=True)
    del layers, kc, vc
    return rec


def staged_plans(c: Ctx, smi: str, layers) -> dict:
    """The staged step (step 7 of 16, Q4_0 planes ``layers``) at both
    breakdown shapes (:func:`step_breakdown`) under the wrapper's plan
    (``attn_plan``) and under the other choice at each shape, in turns
    (plan, other, other, plan): at window 128, its 135 rows in 128-row
    CTAs (two) in place of one CTA; at window 512, the window's four CTAs
    with the staged rows spread over them in place of 128-row CTAs (five)
    -> the step ms of each, printed as a ``staged_plans`` line."""
    from biogpt_tpu_torch.ops import decode_kernels as dk

    plan = dk.attn_plan

    def other(window, kvb, staged_rows=0):
        rows = window + staged_rows
        per = dk.ATTN_ROWS_PER_CTA
        n = -(-rows // per) if window <= per else max(-(-window // per),
                                                      -(-rows // 512))
        return min(n, 16), -(-rows // min(n, 16))
    rec, sdpa = {"staged_plans": "staged bf16 step 7 of 16, q4_0"}, {}
    for name in ("attn_plan", "other", "other", "attn_plan"):
        dk.attn_plan = plan if name == "attn_plan" else other
        try:
            for shape in breakdown_shapes(c):
                with contextlib.redirect_stdout(io.StringIO()):
                    r = step_breakdown(c, smi, "staged bf16", shape, layers,
                                       sdpa)
                rec.setdefault(f"{name}, {shape}", []).append(r["step_ms"])
        finally:
            dk.attn_plan = plan
    rec.update(card=torch.cuda.get_device_name(0), card_stamp=smi)
    print(json.dumps(rec), flush=True)
    return rec


def attn_probe(c: Ctx, smi: str) -> None:
    """Every batched step's attention at both breakdown shapes, each mode
    (:func:`step_breakdown`), then the lockstep bf16 step's timing windows
    (:func:`step_spread`). Run as ``python3 chip_smoke.py --attn-probe``;
    only entry points every tree of the port has, so the script copied into
    an older tree measures that tree."""
    layers, _ = c.rand_layers()
    sdpa = {}
    for shape in breakdown_shapes(c):
        for mode in BREAKDOWN_MODES:
            step_breakdown(c, smi, mode, shape, layers, sdpa)
    del layers
    step_spread(c, smi)


WIDE_PROBE_SHAPES = ("qkv", "o", "fc1", "fc2", "lm_head")


def wide_probe_serve(c: Ctx, smi: str, fmt: str, name: str, flags: dict,
                     params, config) -> dict:
    """The uniform greedy serve of ``name`` (96 requests at B=32) on a
    ``fmt`` file: tokens/s and the wall split (:func:`span_meter`), then
    one greedy step at the serve's shape timed whole and its tail alone
    (final LN, the lm_head at M = 32 and the argmax) and the tail
    traced."""
    import numpy as np

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.models.biogpt import (_final_logits,
                                                forward_fused_decode,
                                                forward_fused_decode_greedy,
                                                forward_fused_decode_staged)
    from biogpt_tpu_torch.runtime.sampling import greedy
    from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

    B, V, dev = 32, config.n_vocab, c.dev
    eng = BatchedEngine(config, params, max_batch=B, max_seq=512, chunk=16,
                        device="cuda", **flags)
    rng = np.random.default_rng(0)
    gen = GenerationParams(temp=0.0, stop_at_eos=False)
    eng.serve(uniform_reqs(rng, V, 4, Request), gen)   # warm-up
    reqs = uniform_reqs(rng, V, 3 * B, Request)
    torch.cuda.synchronize()
    spans = span_meter(eng)
    t0 = time.perf_counter()
    res = eng.serve(reqs, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._prefill_group, eng._run_chunk
    n_tok = sum(len(r.new_ids) for r in res.values())
    check(len(res) == 3 * B and n_tok == 3 * B * 48,
          f"wide probe serve ({name} {fmt}): {len(res)} results")
    rec = {"wide_probe": "serve", "serving_path": name, "format": fmt,
           "serve_uniform_greedy_tokens_per_s": n_tok / wall, "wall_s": wall,
           "decode_chunks_device_ms": sum(s.elapsed_time(e)
                                          for s, e in spans["chunk"]),
           "refill_wave_ms": [s.elapsed_time(e) for s, e in spans["refill"]],
           "card": torch.cuda.get_device_name(0), "card_stamp": smi}
    P = eng.params
    cache = eng.new_cache()
    past = torch.from_numpy(rng.integers(8, 73, size=B)).to(dev, torch.int32)
    toks = torch.from_numpy(rng.integers(4, V - 2, size=(B, 1))).to(dev)
    if flags.get("staged_kv"):
        L, _, _, D = cache.k.shape
        k_st = torch.zeros(L, B, eng.chunk, D, dtype=cache.k.dtype, device=dev)
        v_st = torch.zeros_like(k_st)

        def step():
            logits, _, _ = forward_fused_decode_staged(
                P, toks, cache, k_st, v_st, past, 7, config, kv_window=128)
            return greedy(logits)
    elif eng._fused_greedy:
        def step():
            return forward_fused_decode_greedy(P, toks, cache, past, config,
                                               kv_window=128)
    else:
        def step():
            logits, _ = forward_fused_decode(P, toks, cache, past, config,
                                             kv_window=128)
            return greedy(logits)
    xh = c.randn(B, config.d_model)

    def tail():
        return greedy(_final_logits(P, xh, config, torch.bfloat16))
    rec["step_device_ms"] = time_ms(step, 20)
    rec["step_host_ms"] = HOST[step]["host_ms"]
    if not eng._fused_greedy or flags.get("staged_kv"):
        rec["tail_device_ms"] = time_ms(tail, 20)
        rec["tail_host_ms"] = HOST[tail]["host_ms"]
        rec["tail_share_of_step"] = rec["tail_device_ms"] / rec["step_device_ms"]
        rec["tail_trace"] = kernel_trace(tail)
    print(json.dumps(rec), flush=True)
    del eng, cache
    return rec


def wide_probe(c: Ctx, smi: str) -> None:
    """The numbers of the 9-32-row quantized GEMV (``qmatmul_wide``, row 2)
    and the M <= 8 lm_head tails (row 3 at M <= 8), and of the paths they
    sit on, with the helpers of the holds (:func:`timed`: device, host,
    plain and library ms, L2 flushed; :func:`kernel_trace`); only entry
    points every tree of the port has:
      - ``qmatmul_wide`` at M = 16 and 32 on qkv, o, fc1, fc2 and the
        lm_head (1024 -> 42,496) in Q4_0, the lm_head in the other four
        formats, each call traced;
      - ``lm_head_argmax`` and the sampled tail (``lm_head_logits_gmax_
        commit``) at M = 1 and 8, Q4_0, each traced;
      - the single stream's time to first token on a 16-token prompt (the
        per-op prefill at 16 rows: its projections through
        ``qmatmul_wide``), its device time and its trace;
      - the uniform greedy serves: bf16 lockstep and staged on a Q4_0
        file, lockstep on a Q8_0 file (tokens/s, refill waves, one step
        and its tail, :func:`wide_probe_serve`).
    Run as ``python3 chip_smoke.py --wide-probe``; the lines are JSON."""
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.qmatmul_kernels import (
        lm_head_argmax, lm_head_argmax_plain, lm_head_logits_gmax_commit,
        lm_head_logits_gmax_commit_plain, qmatmul_wide, qmatmul_wide_plain)
    from biogpt_tpu_torch.runtime.engine import Engine

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.n_vocab
    card = torch.cuda.get_device_name(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    shapes = {"qkv": (D, 3 * D), "o": (D, D), "fc1": (D, F), "fc2": (F, D),
              "lm_head": (D, V_PAD)}
    for fmt in FORMATS:
        for name in WIDE_PROBE_SHAPES:
            if fmt != "q4_0" and name != "lm_head":
                continue
            d_in, d_out = shapes[name]
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            for m in (16, 32):
                x = c.randn(m, d_in)
                y, ref = qmatmul_wide(x, qt), qmatmul_wide_plain(x, qt)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = 1e-5 * ref.abs().max().item() + 1e-5
                check(err <= tol, f"wide probe {name} m={m} {fmt}: {err}")
                rec = {"wide_probe": "qmatmul_wide", "shape": name, "m": m,
                       "format": fmt, "max_abs_err": err, "tol": tol}

                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(qt,
                                                             torch.bfloat16)
                timed(rec, lambda: qmatmul_wide(x, qt),
                      lambda: qmatmul_wide_plain(x, qt), lib_call,
                      qbytes(qt) + m * d_in * 4 + m * d_out * 4,
                      2 * m * d_in * d_out, reps=50, plain_reps=3,
                      flush=flush)
                rec["trace"] = kernel_trace(lambda: qmatmul_wide(x, qt))
                rec.update(card=card, card_stamp=smi)
                print(json.dumps(rec), flush=True)

    qt = c.rand_qt(D, V_PAD, fmt="q4_0")
    lnw, lnb = 1 + 0.1 * c.randn(D), 0.1 * c.randn(D)
    S = 512
    for m in (1, 8):
        x = c.randn(m, D)
        kc = c.randn(L, m, S, D).to(torch.bfloat16)
        vc = c.randn(L, m, S, D).to(torch.bfloat16)
        krt = c.randn(m, L, D).to(torch.bfloat16)
        vrt = c.randn(m, L, D).to(torch.bfloat16)
        pt = torch.tensor(ragged_past(m), dtype=torch.int32, device=dev)
        commit = 4 * L * m * D * 2 + m * 4

        def argmax_lib():
            xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
            logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
            return torch.argmax(logits[:, :V], dim=-1)

        def gmax_lib():
            xn = torch.nn.functional.layer_norm(x, (D,), lnw, lnb, cfg.ln_eps)
            logits = xn.to(torch.bfloat16) @ dequantize(qt, torch.bfloat16)
            return logits.float().reshape(m, -1, 128).amax(-1)
        for kname, run, plain, lib, nbytes in (
                ("lm_head_argmax",
                 lambda: lm_head_argmax(x, lnw, lnb, qt, V, cfg.ln_eps),
                 lambda: lm_head_argmax_plain(x, lnw, lnb, qt, V, cfg.ln_eps),
                 argmax_lib, qbytes(qt) + m * D * 4 + 2 * D * 4 + m * 8),
                ("lm_head_logits_gmax_commit",
                 lambda: lm_head_logits_gmax_commit(
                     x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
                 lambda: lm_head_logits_gmax_commit_plain(
                     x, lnw, lnb, qt, V, kc, vc, krt, vrt, pt, cfg.ln_eps),
                 gmax_lib, qbytes(qt) + m * D * 4 + 2 * D * 4
                 + m * V_PAD * 4 + m * (V_PAD // 128) * 4 + commit)):
            rec = {"wide_probe": kname, "m": m, "format": "q4_0"}
            timed(rec, run, plain, lib, nbytes, 2 * m * D * V_PAD, reps=50,
                  plain_reps=3, flush=flush)
            rec["trace"] = kernel_trace(run)
            rec.update(card=card, card_stamp=smi)
            print(json.dumps(rec), flush=True)
        del kc, vc
    del flush_buf

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        files = {}
        for fmt in ("q4_0", "q8_0"):
            files[fmt] = os.path.join(tmp, f"biogpt347m-{fmt}.bin")
            write_random_quantized_model(files[fmt], cfg, FORMATS[fmt][0],
                                         seed=7)
        config, _, _, params = load_params(files["q4_0"], device="cpu")
        # time to first token: the per-op prefill of a 16-token prompt
        eng = Engine(config, params, device="cuda")
        prompt = [2] + list(range(40, 55))
        g = GenerationParams(n_predict=2, temp=0.0, stop_at_eos=False, seed=0)
        eng.generate(prompt, g)
        ttft = [eng.generate(prompt, g).timings["prefill_s"] * 1e3
                for _ in range(9)]

        def prefill():
            return eng.prefill(eng.new_cache(batch=1), prompt)
        rec = {"wide_probe": "ttft", "prompt_tokens": len(prompt),
               "prefill_wall_ms": statistics.median(ttft),
               "prefill_wall_ms_all": ttft,
               "prefill_device_ms": time_ms(prefill, 20),
               "prefill_host_ms": HOST[prefill]["host_ms"],
               "trace": kernel_trace(prefill), "card": card,
               "card_stamp": smi}
        print(json.dumps(rec), flush=True)
        del eng
        for name, flags in (("lockstep bf16", {}),
                            ("staged bf16", dict(staged_kv=True))):
            wide_probe_serve(c, smi, "q4_0", name, flags, params, config)
        config, _, _, params = load_params(files["q8_0"], device="cpu")
        wide_probe_serve(c, smi, "q8_0", "lockstep bf16", {}, params, config)

REFILL_PROBE_FUSED = ((32, 32), (8, 128), (2, 512), (8, 64), (4, 64),
                      (2, 128), (1, 128), (4, 32), (2, 32), (1, 16))
REFILL_PROBE_PER_OP = ((1, 16), (4, 32), (16, 32), (32, 32), (16, 128))


def refill_probe(c: Ctx, smi: str) -> None:
    """``python3 chip_smoke.py --refill-probe``: the refill's device ms
    (``time_ms``, 10 calls) at the shapes a serve's refill groups take:
    ``prefill_fused`` (row 12) on random 347M Q4_0 layers at
    :data:`REFILL_PROBE_FUSED`, and the per-op refill forward (``forward``,
    ``allow_kernels=False``, bf16 compute and cache) at
    :data:`REFILL_PROBE_PER_OP`, with the host's enqueue ms beside each
    (the per-op refill's host time exceeds the spin's cap, so its window
    holds host time: its kernels' busy ms from a trace beside it);
    entry points every tree of the port has (run it from an unpacked older
    tree, the script copied in, to compare two trees in one call)."""
    from biogpt_tpu_torch.models.biogpt import forward
    from biogpt_tpu_torch.ops.prefill_kernels import prefill_fused
    from biogpt_tpu_torch.runtime.cache import init_cache

    cfg, card = c.cfg, torch.cuda.get_device_name(0)
    layers, _ = c.rand_layers(False)
    for R, T in REFILL_PROBE_FUSED:
        x0, _ = padded_prompts(c, R, T)
        run = lambda: prefill_fused(x0, layers, rows=R, padded=T,  # noqa
                                    n_head=cfg.n_head, ln_eps=cfg.ln_eps)
        ms = time_ms(run, 10)
        print(json.dumps({"refill_probe": "prefill_fused", "R": R, "T": T,
                          "device_ms": ms, "host_ms": HOST[run]["host_ms"],
                          "spread_ms": SPREAD[run], "card": card,
                          "card_stamp": smi}), flush=True)
    params = per_op_params(c, layers)
    for R, T in REFILL_PROBE_PER_OP:
        ids = torch.randint(4, cfg.n_vocab - 2, (R, T), generator=c.gen,
                            device=c.dev)
        last = torch.full((R,), T - 1, device=c.dev)

        def run():
            small = init_cache(cfg, batch=R, max_len=T, dtype=torch.bfloat16,
                               device=c.dev)
            return forward(params, ids, small, 0, cfg,
                           compute_dtype=torch.bfloat16, allow_kernels=False,
                           logits_mode="last", last_index=last)
        ms = time_ms(run, 5)
        names = kernel_trace(run)
        print(json.dumps({"refill_probe": "per_op", "R": R, "T": T,
                          "device_ms": ms, "host_ms": HOST[run]["host_ms"],
                          "host_inclusive": HOST[run]["host_inclusive"],
                          "kernels_busy_ms": sum(
                              v[1] for k, v in names.items()
                              if "spin_kernel" not in k),
                          "spread_ms": SPREAD[run], "card": card,
                          "card_stamp": smi}), flush=True)


QMM_PROBE_ROWS = (1, 3, 8)


def qmm_route_plans(M: int, d_in: int, d_out: int) -> dict:
    """Where the tree's ``qmatmul`` has two routes (``qmatmul_kernels.
    qmm_kernel_plan``): {"kernel": qmatmul's own kernel's grid, "stream":
    the streaming GEMV's M <= 8 path's grid (warps 0)}, each only where its
    launcher takes the shape; else {}."""
    from biogpt_tpu_torch.ops import qmatmul_kernels as qk

    kplan = getattr(qk, "qmm_kernel_plan", None)
    if kplan is None:
        return {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {"kernel": kplan(M, d_in, d_out, n_sm)}
    grid_x, splits = qk.stream_plan(M, d_in, d_out, n_sm)
    if -(-(d_in // 64) // splits) <= qk.STREAM_WARPS * qk.STREAM_GPW:
        plans["stream"] = (grid_x, splits, 0)
    return plans


def qmm_probe_route(x, qt, plan):
    """One ``bgt_qmatmul`` launch on ``plan`` (a route of
    :func:`qmm_route_plans`), outside the wrapper's own choice."""
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.ops import qmatmul_kernels as qk

    bits = qk.check_cuda_levels(qt, (), "qmatmul")
    M, d_in, d_out = x.shape[0], qt.d_in, qt.d_out
    y = torch.empty(M, d_out, dtype=torch.float32, device=x.device)
    cuda_lib.check(cuda_lib.library("qmatmul").bgt_qmatmul(
        x.data_ptr(), qt.levels.data_ptr(), qt.scales.data_ptr(),
        cuda_lib.ptr(qt.mins), M, d_in, d_out, qk._offset(qt), bits, *plan,
        y.data_ptr(), cuda_lib.stream_ptr(x.device)), "qmatmul route")
    return y


def qmm_probe(c: Ctx, smi: str) -> None:
    """The numbers of the M <= 8 quantized matmul (``qmatmul``, row 1) and
    of the int8 KV commit (row 11) as the paths run them, with the helpers
    of the holds (:func:`timed`, L2 flushed before each GEMV call;
    :func:`kernel_trace`); only entry points every tree of the port has
    (and, where a tree's ``qmatmul`` has two routes, each route on every
    shape, :func:`qmm_route_plans`):
      - ``qmatmul`` at M = 1, 3 and 8 on qkv, o, fc1, fc2 and the lm_head
        (1024 -> 42,496) in Q4_0, the lm_head in Q4_1 and Q8_0, device and
        host ms, each call traced;
      - ``qmatmul``'s host cost a call, enqueued back to back
        (:func:`qmm_probe_host_loop`);
      - the int8 commit of a B=32 step (the lockstep and paged steps'
        commit, from the f32 rows to the caches) and of the B=1 step at
        the host's position (``runtime.cache.commit_rows``), device and
        host ms, traced; the int8 lockstep and paged greedy steps at B=32
        and the B=1 int8 step, device and host ms, traced;
      - the CLI's decode ms/token, greedy and sampled, bf16 and int8 KV,
        on a random 347M Q4_0 file (128 new tokens, three runs each), and,
        where ``qmatmul`` has two routes, the sampled CLI (its lm_head is
        ``qmatmul`` at M = 1 every token) and a 5-token prompt's prefill
        (its projections are ``qmatmul`` at M = 8) with ``qmatmul`` as it
        ships, every call on qmatmul's kernel, and every call on the
        streaming path where that takes the shape, in turns.
    Run as ``python3 chip_smoke.py --qmm-probe``; the lines are JSON."""
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.modelio.checkpoint import load_params
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.models.biogpt import forward_fused_decode_greedy
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.ops import decode_kernels as dk
    from biogpt_tpu_torch.ops import dequantize
    from biogpt_tpu_torch.ops.qmatmul_kernels import qmatmul, qmatmul_plain
    from biogpt_tpu_torch.runtime import cache as kvc
    from biogpt_tpu_torch.runtime.engine import Engine

    cfg, dev, V_PAD = c.cfg, c.dev, c.V_PAD
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    card = torch.cuda.get_device_name(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def emit(rec):
        rec.update(card=card, card_stamp=smi)
        print(json.dumps(rec), flush=True)

    shapes = {"qkv": (D, 3 * D), "o": (D, D), "fc1": (D, F), "fc2": (F, D),
              "lm_head": (D, V_PAD)}
    for fmt in ("q4_0", "q4_1", "q8_0"):
        for name, (d_in, d_out) in shapes.items():
            if fmt != "q4_0" and name != "lm_head":
                continue
            qt = c.rand_qt(d_in, d_out, fmt=fmt)
            for m in QMM_PROBE_ROWS:
                x = c.randn(m, d_in)
                ref = qmatmul_plain(x, qt)
                tol = 1e-5 * ref.abs().max().item() + 1e-5
                nbytes = qbytes(qt) + m * d_in * 4 + m * d_out * 4

                def lib_call():
                    return x.to(torch.bfloat16) @ dequantize(qt,
                                                             torch.bfloat16)
                runs = [("qmatmul", lambda: qmatmul(x, qt))]
                for route, plan in qmm_route_plans(m, d_in, d_out).items():
                    runs.append((route, lambda plan=plan: qmm_probe_route(
                        x, qt, plan)))
                for kname, run in runs:
                    y = run()
                    torch.cuda.synchronize()
                    err = (y - ref).abs().max().item()
                    check(err <= tol, f"qmm probe {kname} {name} m={m} "
                          f"{fmt}: {err} > {tol}")
                    rec = {"qmm_probe": kname, "shape": name, "m": m,
                           "format": fmt, "max_abs_err": err, "tol": tol}
                    timed(rec, run, lambda: qmatmul_plain(x, qt),
                          lib_call if kname == "qmatmul" else None, nbytes,
                          2 * m * d_in * d_out, reps=50, plain_reps=3,
                          flush=flush)
                    rec["trace"] = kernel_trace(run)
                    emit(rec)
            del qt
    del flush_buf
    qmm_probe_host_loop(c, emit)

    # the int8 commit as the steps run it
    fused = getattr(dk, "kv_commit_quant_rows", None)
    S = 512
    for B in (32, 1):
        kc, ks = rand_int8_cache(c, L, B, S)
        vc, vs = rand_int8_cache(c, L, B, S)
        k_rows, v_rows = c.randn(L, B, D), c.randn(L, B, D)
        if B == 32:
            pt = torch.tensor(ragged_past(B, dead=(7, 19)), dtype=torch.int32,
                              device=dev)
            if fused is not None:
                def commit():
                    fused(kc, vc, ks, vs, k_rows, v_rows, pt)
            else:
                def commit():
                    kq, ksc = kvc.quantize_rows(k_rows)
                    vq, vsc = kvc.quantize_rows(v_rows)
                    dk.kv_commit_quant(kc, vc, ks, vs, kq.transpose(0, 1),
                                       vq.transpose(0, 1),
                                       ksc.transpose(0, 1)[..., None],
                                       vsc.transpose(0, 1)[..., None], pt)
        else:
            cache = kvc.QuantKVCache(k=kc, v=vc, ks=ks, vs=vs)

            def commit():
                kvc.commit_rows(cache, k_rows, v_rows, 100)
        rec = {"qmm_probe": "int8_commit", "B": B, "L": L,
               "bytes": 2 * L * B * D * 4 + 2 * L * B * (D + 4),
               "device_ms": time_ms(commit, 50),
               "host_ms": HOST[commit]["host_ms"],
               "trace": kernel_trace(commit)}
        emit(rec)
        del kc, vc, ks, vs

    # the int8 steps at B=32 (lockstep, paged) and B=1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "biogpt347m-q4_0.bin")
        write_random_quantized_model(path, cfg, FORMATS["q4_0"][0], seed=7)
        config, _, _, params = load_params(path, device="cpu")
        eng = Engine(config, params, kv_quant=True, device="cuda")
        P = eng.params
        for B, per_slot in ((32, False), (32, True), (1, False)):
            cache = kvc.init_cache(config, batch=B, max_len=S,
                                   dtype=torch.int8, device=dev)
            toks = torch.randint(4, config.n_vocab - 2, (B, 1),
                                 generator=c.gen, device=dev)
            past = (torch.randint(8, 73, (B,), generator=c.gen, device=dev,
                                  dtype=torch.int32)
                    if B > 1 or per_slot else 100)

            def step():
                return forward_fused_decode_greedy(P, toks, cache, past,
                                                   config, kv_window=128,
                                                   per_slot_kv=per_slot)
            rec = {"qmm_probe": "int8_step", "B": B,
                   "mode": "paged" if per_slot else "lockstep",
                   "device_ms": time_ms(step, 20),
                   "host_ms": HOST[step]["host_ms"],
                   "trace": kernel_trace(step)}
            emit(rec)
            del cache
        del eng

        # the CLI's decode rate, greedy and sampled, bf16 and int8 KV
        prompt = [2] + list(range(40, 52))
        engs = {False: Engine(config, params, device="cuda"),
                True: Engine(config, params, kv_quant=True, device="cuda")}
        for temp in (0.0, 0.9):
            g = GenerationParams(n_predict=128, temp=temp, stop_at_eos=False,
                                 seed=1)
            for kv_quant in (False, True):
                e = engs[kv_quant]
                e.generate(prompt, g)
                ms = [e.generate(prompt, g).timings["ms_per_token"]
                      for _ in range(3)]
                emit({"qmm_probe": "cli", "temp": temp,
                      "kv_cache": "int8" if kv_quant else "bf16",
                      "decode_ms_per_token": statistics.median(ms),
                      "decode_ms_per_token_all": ms})
        qmm_probe_cli_routes(engs[False], emit)


def qmm_probe_host_loop(c: Ctx, emit) -> None:
    """``qmatmul``'s host cost a call (Q4_0; the lm_head, fc2 and qkv at M =
    1 and 8): 200 calls enqueued back to back with no synchronize between
    them, so that the launch queue never fills and the loop's host time is
    the calls' enqueue alone; 7 loops, ms a call (min, median)."""
    from biogpt_tpu_torch.ops.qmatmul_kernels import qmatmul

    for name, d_in, d_out in (("lm_head", c.cfg.d_model, c.V_PAD),
                              ("fc2", c.cfg.d_ff, c.cfg.d_model),
                              ("qkv", c.cfg.d_model, 3 * c.cfg.d_model)):
        qt = c.rand_qt(d_in, d_out, fmt="q4_0")
        for m in (1, 8):
            x = c.randn(m, d_in)
            for _ in range(20):
                qmatmul(x, qt)
            host = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    qmatmul(x, qt)
                host.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
            emit({"qmm_probe": "host_loop", "shape": name, "m": m,
                  "host_ms_a_call_min": min(host),
                  "host_ms_a_call_median": statistics.median(host)})
        del qt


def qmm_probe_cli_routes(eng, emit) -> None:
    """Where ``qmatmul`` has two routes: the sampled CLI's decode ms/token
    (128 new tokens) and a 5-token prompt's prefill ms (bf16 KV) with
    ``qmatmul`` as it ships ("shipped"), every call on qmatmul's kernel
    ("kernel"), and every call on the streaming path where that takes the
    shape ("stream"), the three in turns, five rounds; each route's
    ``qmatmul`` launches counted in its first round."""
    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.ops import qmatmul_kernels as qk

    if not hasattr(qk, "qmm_kernel_plan"):
        return
    shipped = qk._qmm_plan

    def forced(route):
        def plan(index, m, d_in, d_out):
            return qmm_route_plans(m, d_in, d_out).get(
                route, shipped(index, m, d_in, d_out))
        return plan
    routes = {"shipped": shipped, "kernel": forced("kernel"),
              "stream": forced("stream")}
    g = GenerationParams(n_predict=128, temp=0.9, stop_at_eos=False, seed=1)
    short = [2, 40, 41, 42, 43]
    res = {r: {"decode_ms_per_token": [], "prefill_ms": []} for r in routes}
    try:
        for rnd in range(5):
            for route, plan in routes.items():
                qk._qmm_plan = plan
                if rnd == 0:
                    eng.generate(short, g)
                    cuda_lib.LAUNCHES["qmatmul"] = 0
                    eng.generate(short, g)
                    res[route]["qmatmul_launches_a_run"] = \
                        cuda_lib.LAUNCHES["qmatmul"]
                t = eng.generate(short, g).timings
                res[route]["decode_ms_per_token"].append(t["ms_per_token"])
                res[route]["prefill_ms"].append(t["prefill_s"] * 1e3)
    finally:
        qk._qmm_plan = shipped
    for route, r in res.items():
        emit({"qmm_probe": "cli_route", "route": route, "temp": 0.9,
              "prompt_tokens": len(short), **r,
              "decode_ms_per_token_median":
                  statistics.median(r["decode_ms_per_token"]),
              "prefill_ms_median": statistics.median(r["prefill_ms"])})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tp-rank"]:   # one rank of phase_tp_serving
        return tp_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-rank"]:   # one rank of phase_mesh_serving
        return mesh_rank(sys.argv[2:])
    from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
    from biogpt_tpu_torch.ops import cuda_lib
    from biogpt_tpu_torch.quant import codecs

    # ---------------------------------------------------------- 1. stamp
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | TF32 off for "
        "matmul and cuDNN")
    t0 = time.perf_counter()
    per_lib = {k: round(v, 1) for k, v in cuda_lib.build_all().items()}
    log(f"built {len(cuda_lib.SOURCES)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s (each nvcc, run together: "
        f"{json.dumps(per_lib)} s)")

    c = Ctx()
    if sys.argv[1:2] == ["--wide-probe"]:
        wide_probe(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--attn-probe"]:
        attn_probe(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--qmm-probe"]:
        qmm_probe(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--refill-probe"]:
        refill_probe(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--model-files"]:
        phase_model_files(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--mesh"]:
        mesh_phases(c, smi)
        return 1 if FAILURES else 0
    if sys.argv[1:2] == ["--graphs"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            path = os.path.join(tmp, "biogpt347m-q4_0.bin")
            write_random_quantized_model(path, c.cfg, codecs.GGML_TYPE_Q4_0,
                                         seed=7)
            t0 = time.perf_counter()
            phase_graphs(c, path, smi)
            log(f"phase_graphs: {time.perf_counter() - t0:.1f} s")
        return 1 if FAILURES else 0
    phases = [(p.__name__, p) for p in (
        phase_single_kernels, phase_qmatmul_kernels, phase_serving_kernels,
        phase_refill_int8_kernels, phase_paged_staged_kernels,
        phase_gemv_kernels, phase_b1_gemv_kernels,
        phase_prefill_gemm_kernels)]
    phases.insert(5, ("phase_attention_kernels",
                      lambda c: phase_attention_kernels(c, smi)))
    phases += [(f"phase_format_kernels {fmt}",
                lambda c, fmt=fmt: phase_format_kernels(c, fmt))
               for fmt in NEW_FORMATS]
    phases += [("phase_tp_kernels", phase_tp_kernels)]
    for name, phase in phases:
        t0 = time.perf_counter()
        phase(c)
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "biogpt347m-q4_0.bin")
        t0 = time.perf_counter()
        write_random_quantized_model(path, c.cfg, codecs.GGML_TYPE_Q4_0, seed=7)
        log(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, phase in (
                ("phase_cli", phase_cli),
                ("phase_serving bf16", phase_serving),
                ("phase_serving int8",
                 lambda *a: phase_serving(*a, kv_quant=True)),
                ("phase_paged_staged_serving", phase_paged_staged_serving),
                ("phase_graphs", phase_graphs),
                ("phase_tp_serving", phase_tp_serving),
                ("phase_tp_one_by_one", phase_tp_one_by_one),
                ("phase_mesh_serving", phase_mesh_serving)):
            t0 = time.perf_counter()
            phase(c, path, smi)
            log(f"{name}: {time.perf_counter() - t0:.1f} s")
    for fmt in E2E_FORMATS:
        t0 = time.perf_counter()
        phase_format_e2e(c, fmt, smi)
        log(f"phase_format_e2e {fmt}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_model_files(c, smi)
    log(f"phase_model_files: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 11. the lines
    sources = {
        "qmatmul": ("biogpt_tpu_torch/csrc/qmatmul.cu",
                    "biogpt_tpu/ops/pallas_qmatmul.py:860"),
        "qmatmul_wide": ("biogpt_tpu_torch/csrc/qgemv_stream.cuh",
                         "biogpt_tpu/ops/pallas_qmatmul.py:246"),
        "lm_head_argmax": ("biogpt_tpu_torch/csrc/lm_head_argmax.cu",
                           "biogpt_tpu/ops/pallas_qmatmul.py:789"),
        "decode_step_fused": ("biogpt_tpu_torch/csrc/decode_step.cu",
                              "biogpt_tpu/ops/pallas_decode.py:1016"),
        "decode_step_fused_batched": ("biogpt_tpu_torch/csrc/decode_batched.cu",
                                      "biogpt_tpu/ops/pallas_decode.py:358"),
        "kv_commit": ("biogpt_tpu_torch/csrc/kv_commit.cu",
                      "biogpt_tpu/ops/pallas_decode.py:754"),
        "lm_head_argmax_commit": ("biogpt_tpu_torch/csrc/lm_head_argmax.cu",
                                  "biogpt_tpu/ops/pallas_qmatmul.py:689"),
        "lm_head_logits_gmax_commit": (
            "biogpt_tpu_torch/csrc/lm_head_argmax.cu",
            "biogpt_tpu/ops/pallas_qmatmul.py:592"),
        "prefill_fused": ("biogpt_tpu_torch/csrc/prefill.cu",
                          "biogpt_tpu/ops/pallas_prefill.py:172"),
        "decode_step_fused_int8": ("biogpt_tpu_torch/csrc/decode_step.cu",
                                   "biogpt_tpu/ops/pallas_decode.py:288"),
        "decode_step_fused_batched_int8": (
            "biogpt_tpu_torch/csrc/decode_batched.cu",
            "biogpt_tpu/ops/pallas_decode.py:455"),
        "kv_commit_quant": ("biogpt_tpu_torch/csrc/kv_commit.cu",
                            "biogpt_tpu/ops/pallas_decode.py:839"),
        "kv_commit_quant_rows": ("biogpt_tpu_torch/csrc/kv_commit.cu",
                                 "biogpt_tpu/ops/pallas_decode.py:839"),
        "decode_step_fused_paged": ("biogpt_tpu_torch/csrc/decode_paged.cu",
                                    "biogpt_tpu/ops/pallas_decode.py:573"),
        "decode_step_fused_paged_int8": (
            "biogpt_tpu_torch/csrc/decode_paged.cu",
            "biogpt_tpu/ops/pallas_decode.py:680"),
        "decode_step_fused_staged": ("biogpt_tpu_torch/csrc/decode_paged.cu",
                                     "biogpt_tpu/ops/pallas_decode.py:502"),
        "tp_attn_half": ("biogpt_tpu_torch/csrc/decode_tp.cu",
                         "biogpt_tpu/ops/pallas_decode_tp.py:95"),
        "tp_attn_half_int8": ("biogpt_tpu_torch/csrc/decode_tp.cu",
                              "biogpt_tpu/ops/pallas_decode_tp.py:428"),
        "tp_qkv_half": ("biogpt_tpu_torch/csrc/decode_tp.cu",
                        "biogpt_tpu/ops/pallas_decode_tp.py:240"),
        "tp_ffn_half": ("biogpt_tpu_torch/csrc/decode_tp.cu",
                        "biogpt_tpu/ops/pallas_decode_tp.py:268"),
        "decode_gemv": ("biogpt_tpu_torch/csrc/qgemv_mma.cuh",
                        "biogpt_tpu/ops/pallas_decode.py:190"),
        "decode_gemv_b1": ("biogpt_tpu_torch/csrc/qgemv_b1.cuh",
                           "biogpt_tpu/ops/pallas_decode.py:142"),
        "prefill_gemm": ("biogpt_tpu_torch/csrc/prefill.cu",
                         "biogpt_tpu/ops/pallas_prefill.py:100"),
        "batched_attention": ("biogpt_tpu_torch/csrc/attn_batched.cuh",
                              "biogpt_tpu/ops/pallas_decode.py:479"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = c.results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": c.launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "formats": sorted(c.formats.get(name, ()))})
    if FAILURES:
        log(f"{len(FAILURES)} failure(s):\n  " + "\n  ".join(FAILURES))
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
