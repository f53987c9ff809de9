"""The least time an H100 could take for each TPU kernel of the JAX package,
at the shape the port's main paths give it.

    python -m biogpt_tpu_torch.tools.kernel_bounds

One JSON line per kernel (each function of ``biogpt_tpu/ops`` that reaches
``pl.pallas_call``), shape and weight format (Q4_0, Q4_1, Q5_0, Q5_1,
Q8_0: the planes as the engines prepare them), ported or not, at
BioGPT-347M; ``row`` is the kernel's number in PERF.md's table. Each line has the
bytes it must move (each input read once, each output written once), the
operations it does, and ``bound_ms``, the larger of bytes over the card's
memory rate and operations over its bf16 tensor rate (published H100 SXM
figures). Then the four projection GEMVs alone of the batched steps (M =
8, 16, 32), of the B=1 step (M = 1) and of one rank's TP halves (tp 2 and
4, M = 32); the refill kernel's four GEMMs and its attention at each refill
shape (row 12's sub-rows) and the lm_head GEMV and KV commit of the two
M=32 serving tails (rows 4 and 5); the refill GEMM alone (``prefill_gemm``)
at 1024 rows; row 2 (``qmatmul_wide``) at each shape and M = 16, 32
(:func:`wide_sub_rows`), row 3 and the sampled tail's GEMV at M = 1, 8
(:func:`small_tail_rows`), row 1 (``qmatmul``) at each shape and M = 1, 8
(:func:`qmatmul_sub_rows`), row 11 with the rows' quantization folded in
at B = 32 and 1 (:func:`commit_quant_sub_rows`), and the batched steps'
attention in rows 7, 8, 9, 14 and 15 (:func:`attn_sub_rows`). ``chip_smoke.py`` computes the ported kernels' bounds with the
same :func:`bound` from the inputs of its own run. Needs no card.
"""

from __future__ import annotations

import json

from ..config import BioGptConfig
from ..quant.codecs import QK

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (published)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor rate (published)

# per-slot positions of the batched rows: chip_smoke.py's B=32 case
# (1 + 13 b, slots 7 and 19 dead at 0), window 512
RAGGED_PAST = [0 if b in (7, 19) else 1 + 13 * b for b in range(32)]
WINDOW = 512
# the staged step chip_smoke.py times: chunk 16, step 7 of it
STAGE_ROWS, STEP_I = 16, 7
# the refill groups chip_smoke.py times: the uniform wave, the mixed wave,
# one long prompt
PREFILL_SHAPES = ((32, 32), (8, 128), (1, 512))
# each kernel's number in PERF.md's table
ROW = {name: i for i, name in enumerate((
    "qmatmul_pallas", "qmatmul_pallas_wide", "lm_head_argmax_pallas",
    "lm_head_argmax_commit_pallas", "lm_head_logits_gmax_commit_pallas",
    "decode_step_fused B=1", "decode_step_fused batched",
    "decode_step_fused paged", "decode_step_fused int8 KV",
    "kv_commit_pallas", "kv_commit_quant_pallas", "prefill_fused",
    "decode_step_fused_tp", "decode_step_fused paged int8 KV",
    "decode_step_fused staged"), 1)}


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


FORMATS = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")


def q_bytes(d_in: int, d_out: int, fmt: str = "q4_0") -> int:
    """The planes of one (d_in, d_out) weight in format ``fmt``: 4, 5 or 8
    bits of levels per weight, a bf16 scale per 32 weights and, for the _1
    formats, a bf16 min (0.5625, 0.625, 0.6875, 0.75 and 1.0625 bytes per
    weight for Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0)."""
    bits = {"q4": 4, "q5": 5, "q8": 8}[fmt[:2]]
    planes = 2 if fmt.endswith("_1") else 1
    return d_in * bits // 8 * d_out + planes * (d_in // QK) * d_out * 2


def layer_bytes(c: BioGptConfig, fmt: str = "q4_0") -> int:
    """One layer's planes, f32 biases and LayerNorm parameters."""
    D, F = c.d_model, c.d_ff
    planes = (q_bytes(D, 3 * D, fmt) + q_bytes(D, D, fmt)
              + q_bytes(D, F, fmt) + q_bytes(F, D, fmt))
    return planes + (3 * D + D + F + D) * 4 + 4 * D * 4


# the four projections of a layer: (name, d_in, d_out) as multiples of
# (d_model, d_ff) -- qkv D -> 3D, o D -> D, fc1 D -> F, fc2 F -> D
PROJECTIONS = ("qkv", "o", "fc1", "fc2")


def projection_shape(c: BioGptConfig, name: str) -> tuple:
    D, F = c.d_model, c.d_ff
    return {"qkv": (D, 3 * D), "o": (D, D), "fc1": (D, F), "fc2": (F, D)}[name]


def gemv_cost(c: BioGptConfig, name: str, M: int, fmt: str = "q4_0"):
    """(bytes, operations, parameter bytes) of one layer's projection
    ``name`` on M rows, as the batched steps' tensor-core GEMV computes it
    (``decode_kernels.decode_gemv``): its planes, its f32 bias and, for qkv
    and fc1, its LayerNorm's f32 weight and bias (the parameter bytes; the
    four projections' sum is :func:`layer_bytes`), x in (M, d_in) f32, y
    out (M, d_out) f32 and, for o and fc2, the residual in."""
    d_in, d_out = projection_shape(c, name)
    params = q_bytes(d_in, d_out, fmt) + d_out * 4
    if name in ("qkv", "fc1"):
        params += 2 * d_in * 4
    act = M * d_in * 4 + M * d_out * 4 * (2 if name in ("o", "fc2") else 1)
    return params + act, 2 * M * d_in * d_out, params


def gemv_rows(c: BioGptConfig = BioGptConfig(), M: int = 32,
              fmt: str = "q4_0") -> list:
    """The four projection sub-rows of the batched steps (PERF.md's rows 7,
    8, 9, 14 and 15) at M rows or, at M = 1, of the B=1 step (rows 6 and
    9 at B=1: ``decode_gemv_b1``, the same bytes and operations)."""
    recs = []
    for name in PROJECTIONS:
        nbytes, flops, params = gemv_cost(c, name, M, fmt)
        ms, by = bound(nbytes, flops)
        d_in, d_out = projection_shape(c, name)
        recs.append({"kernel": "decode_gemv_b1" if M == 1 else "decode_gemv",
                     "projection": name, "shape": f"{d_in} -> {d_out}",
                     "m": M, "format": fmt, "bytes": nbytes,
                     "param_bytes": params, "flops": flops, "bound_ms": ms,
                     "bound_by": by})
    return recs


def tp_gemv_cost(c: BioGptConfig, name: str, tp: int, M: int,
                 fmt: str = "q4_0"):
    """(bytes, operations, plane bytes) of one rank's projection ``name``
    in a TP half (``csrc/decode_tp.cu``) on M rows: qkv and fc1 at d_out /
    tp with their LayerNorm and their bias shard; o and fc2 at d_in / tp,
    the partial sum alone (bias and residual are added after the
    all-reduce); x in, y out, f32."""
    d_in, d_out = projection_shape(c, name)
    if name in ("qkv", "fc1"):
        d_out //= tp
        extra = d_out * 4 + 2 * d_in * 4
    else:
        d_in //= tp
        extra = 0
    planes = q_bytes(d_in, d_out, fmt)
    return (planes + extra + M * d_in * 4 + M * d_out * 4,
            2 * M * d_in * d_out, planes)


def tp_gemv_rows(c: BioGptConfig = BioGptConfig(), tp: int = 4, M: int = 32,
                 fmt: str = "q4_0") -> list:
    """The four projection sub-rows of one rank's TP halves (PERF.md's row
    13) at tp ranks and M rows."""
    recs = []
    for name in PROJECTIONS:
        nbytes, flops, planes = tp_gemv_cost(c, name, tp, M, fmt)
        ms, by = bound(nbytes, flops)
        d_in, d_out = projection_shape(c, name)
        if name in ("qkv", "fc1"):
            d_out //= tp
        else:
            d_in //= tp
        recs.append({"kernel": "tp_gemv", "projection": name, "tp": tp,
                     "shape": f"{d_in} -> {d_out}", "m": M, "format": fmt,
                     "bytes": nbytes, "plane_bytes": planes, "flops": flops,
                     "bound_ms": ms, "bound_by": by})
    return recs


def layer_flops(c: BioGptConfig, rows: int) -> int:
    D, F = c.d_model, c.d_ff
    return 2 * rows * (D * 3 * D + D * D + 2 * D * F)


def prefill_cost(c: BioGptConfig, R: int, T: int, wbytes: int):
    """(bytes, operations) of ``prefill_fused`` on R prompts padded to T:
    the layer planes ``wbytes`` once, x in and out (f32), every layer's K/V
    rows out (bf16); the projections of all R*T rows and causal attention
    over each whole padded prompt (the kernel computes padding rows too)."""
    D, L, RT = c.d_model, c.n_layer, R * T
    attn = R * 4 * (T * (T + 1) // 2) * D        # causal scores and p.V
    return (wbytes + 2 * RT * D * 4 + 2 * L * RT * D * 2,
            L * (layer_flops(c, RT) + attn))


def prefill_gemm_cost(c: BioGptConfig, name: str, M: int, fmt: str = "q4_0"):
    """(bytes, operations) of one projection ``name`` alone through the
    refill kernel's GEMM (``prefill_kernels.prefill_gemm``) on M rows: its
    planes and f32 bias, the bf16 rows in, and out q, k, v (qkv) or GELU's
    rows (fc1) in bf16, or the f32 residual in and out (o, fc2)."""
    d_in, d_out = projection_shape(c, name)
    out = (2 * M * d_out * 4 if name in ("o", "fc2") else M * d_out * 2)
    return (q_bytes(d_in, d_out, fmt) + d_out * 4 + M * d_in * 2 + out,
            2 * M * d_in * d_out)


def prefill_sub_rows(c: BioGptConfig = BioGptConfig(), R: int = 32,
                     T: int = 32, fmt: str = "q4_0") -> list:
    """Row 12 (``prefill_fused`` on R prompts padded to T) split by the
    chain's parts over all L layers, so that their bytes and operations sum
    to the row's: each GEMM its planes, bias and LayerNorm parameters, qkv
    also x in and every layer's K/V rows out, fc2 x out; attention its
    operations (its q, k, v and context stay inside the call)."""
    D, F, L, RT = c.d_model, c.d_ff, c.n_layer, R * T
    ln = 2 * D * 4
    parts = (
        ("qkv", L * (q_bytes(D, 3 * D, fmt) + 3 * D * 4 + ln) + RT * D * 4
         + 2 * L * RT * D * 2, L * 2 * RT * D * 3 * D),
        ("attention", 0, L * R * 4 * (T * (T + 1) // 2) * D),
        ("o", L * (q_bytes(D, D, fmt) + D * 4), L * 2 * RT * D * D),
        ("fc1", L * (q_bytes(D, F, fmt) + F * 4 + ln), L * 2 * RT * D * F),
        ("fc2", L * (q_bytes(F, D, fmt) + D * 4) + RT * D * 4,
         L * 2 * RT * F * D),
    )
    recs = []
    for part, nbytes, flops in parts:
        ms, by = bound(nbytes, flops)
        recs.append({"kernel": "prefill_fused", "row": ROW["prefill_fused"],
                     "part": part, "shape": f"R={R} prompts x T={T}",
                     "format": fmt, "bytes": nbytes, "flops": flops,
                     "bound_ms": ms, "bound_by": by})
    return recs


def tail_sub_rows(c: BioGptConfig = BioGptConfig(), fmt: str = "q4_0") -> list:
    """Rows 4 and 5 (the M=32 greedy and sampled tails with their KV
    commit) split into the lm_head GEMV (its planes, x and the LayerNorm's
    parameters in, the ids and winning logits, or the logits and their
    group maxima, out) and the commit (the rows in, the cache rows out):
    each pair sums to its row."""
    D, L = c.d_model, c.n_layer
    V = -(-c.n_vocab // 128) * 128
    B = len(RAGGED_PAST)
    lm = q_bytes(D, V, fmt) + B * D * 4 + 2 * D * 4
    commit = 4 * L * B * D * 2 + B * 4
    recs = []
    for kernel, out in (("lm_head_argmax_commit_pallas", B * 8),
                        ("lm_head_logits_gmax_commit_pallas",
                         B * V * 4 + B * V // 128 * 4)):
        for part, nbytes, flops in (("lm_head GEMV", lm + out, 2 * B * D * V),
                                    ("KV commit", commit, 0)):
            ms, by = bound(nbytes, flops)
            recs.append({"kernel": kernel, "row": ROW[kernel], "part": part,
                         "shape": "m=32 + commit B=32", "format": fmt,
                         "bytes": nbytes, "flops": flops, "bound_ms": ms,
                         "bound_by": by})
    return recs


# the shapes ``qmatmul_wide`` (row 2) takes on the main paths: the layer
# projections of a 9-32-token prompt's per-op prefill, and the lm_head of
# a refill wave (M = R) and of the steps whose logits leave the card whole
# (the staged serve, an unpacked Q8_0 lm_head: M = B)
WIDE_SHAPES = PROJECTIONS + ("lm_head",)


def wide_sub_rows(c: BioGptConfig = BioGptConfig(), fmt: str = "q4_0",
                  ms=(16, 32)) -> list:
    """Row 2 (``qmatmul_wide``) at each of ``WIDE_SHAPES`` and M rows: its
    planes (``plane_bytes``), x in (M, d_in) and y out (M, d_out), f32."""
    V = -(-c.n_vocab // 128) * 128
    recs = []
    for name in WIDE_SHAPES:
        d_in, d_out = ((c.d_model, V) if name == "lm_head"
                       else projection_shape(c, name))
        planes = q_bytes(d_in, d_out, fmt)
        for M in ms:
            nbytes = planes + M * d_in * 4 + M * d_out * 4
            flops = 2 * M * d_in * d_out
            ms_, by = bound(nbytes, flops)
            recs.append({"kernel": "qmatmul_pallas_wide",
                         "row": ROW["qmatmul_pallas_wide"], "shape": name,
                         "widths": f"{d_in} -> {d_out}", "m": M,
                         "format": fmt, "bytes": nbytes, "plane_bytes": planes,
                         "flops": flops, "bound_ms": ms_, "bound_by": by})
    return recs


def qmatmul_sub_rows(c: BioGptConfig = BioGptConfig(), fmt: str = "q4_0",
                     ms=(1, 8)) -> list:
    """Row 1 (``qmatmul``, M <= 8) at each of ``WIDE_SHAPES`` and M rows:
    its planes, x in (M, d_in) and y out (M, d_out), f32. At M = 1 the
    lm_head sub-row is row 1 itself."""
    recs = []
    for r in wide_sub_rows(c, fmt, ms):
        r.update(kernel="qmatmul_pallas", row=ROW["qmatmul_pallas"])
        recs.append(r)
    return recs


def commit_quant_sub_rows(c: BioGptConfig = BioGptConfig(),
                          batches=(32, 1)) -> list:
    """Row 11 with the rows' quantization folded in (``kv_commit_quant_
    rows``, the int8 steps' commit) at B slots: the step's f32 K and V rows
    (L, B, D) read, the int8 levels and f32 scales written at each slot's
    position, and the (B,) positions read where they live on the card
    (B > 1; the single stream passes the host's)."""
    D, L = c.d_model, c.n_layer
    recs = []
    for B in batches:
        nbytes = 2 * L * B * D * 4 + 2 * L * B * (D + 4) + (B * 4 if B > 1
                                                             else 0)
        ms_, by = bound(nbytes, 0)
        recs.append({"kernel": "kv_commit_quant_pallas",
                     "row": ROW["kv_commit_quant_pallas"],
                     "mode": "f32 rows, quantized in the commit", "B": B,
                     "bytes": nbytes, "flops": 0, "bound_ms": ms_,
                     "bound_by": by})
    return recs


def small_tail_rows(c: BioGptConfig = BioGptConfig(), fmt: str = "q4_0",
                    ms=(1, 8)) -> list:
    """Row 3 at M <= 8 rows (the greedy tail: the lm_head planes, x and the
    LayerNorm's parameters in, the ids and winning logits out) and the
    sampled tail's GEMV at the same M (the logits and their 128-column
    group maxima out instead)."""
    D = c.d_model
    V = -(-c.n_vocab // 128) * 128
    planes = q_bytes(D, V, fmt)
    recs = []
    for M in ms:
        into = planes + M * D * 4 + 2 * D * 4
        for kernel, out in (("lm_head_argmax_pallas", M * 8),
                            ("lm_head_logits_gmax_commit_pallas",
                             M * V * 4 + M * (V // 128) * 4)):
            ms_, by = bound(into + out, 2 * M * D * V)
            recs.append({"kernel": kernel, "row": ROW[kernel],
                         "part": "lm_head GEMV", "m": M, "format": fmt,
                         "bytes": into + out, "plane_bytes": planes,
                         "flops": 2 * M * D * V, "bound_ms": ms_,
                         "bound_by": by})
    return recs


def bf16_step_cost(c: BioGptConfig, past: list, window: int, wbytes: int,
                   step_i: int = 0):
    """(bytes, operations) of a bf16-KV ``decode_step_fused`` (batched,
    paged or, with ``step_i`` > 0, staged) at B = len(past) per-slot
    positions: the planes once, each slot's live K/V rows below its
    chunk-start length ``min(past - step_i, window)`` and its ``step_i``
    staged rows, the new rows out, x in and out and the positions."""
    D, L, B = c.d_model, c.n_layer, len(past)
    rows = sum(min(max(p - step_i, 0), window) for p in past) + B * step_i
    return (wbytes + 2 * L * rows * D * 2 + 2 * L * B * D * 2
            + 2 * B * D * 4 + B * 4,
            L * (layer_flops(c, B) + 4 * rows * D))


def int8_step_cost(c: BioGptConfig, past: list, window: int, wbytes: int):
    """(bytes, operations) of the int8-KV ``decode_step_fused`` at B =
    len(past): the planes once, each slot's live level rows and their f32
    scales, the new rows out in f32, x in and out and the positions (on
    the card at every B)."""
    D, L, B = c.d_model, c.n_layer, len(past)
    live = sum(min(p, window) for p in past)
    return (wbytes + 2 * L * live * (D + 4) + 2 * L * B * D * 4
            + 2 * B * D * 4 + B * 4,
            L * (layer_flops(c, B) + 4 * live * D))


def attn_cost(c: BioGptConfig, past: list, window: int, int8: bool = False,
              step_i: int = 0, layers: int | None = None):
    """(bytes, operations) of the batched steps' attention over ``layers``
    layers (all L by default) at B = len(past) per-slot positions: each
    slot's live K/V rows below ``min(past - step_i, window)`` (bf16, or
    int8 levels with their f32 scales) and its ``step_i`` staged bf16 rows
    read once, the new K/V rows out (bf16, or f32 in the int8 mode) and the
    positions. With the projections' parameters (L times
    :func:`gemv_rows`' ``param_bytes``) and x in and out it is the step's
    bound (:func:`bf16_step_cost`, :func:`int8_step_cost`)."""
    D, B = c.d_model, len(past)
    L = c.n_layer if layers is None else layers
    live = sum(min(max(p - step_i, 0), window) for p in past)
    if int8:
        kv, out = 2 * L * live * (D + 4), 2 * L * B * D * 4
    else:
        kv, out = 2 * L * live * D * 2, 2 * L * B * D * 2
    staged = 2 * L * B * step_i * D * 2
    return kv + staged + out + B * 4, 4 * L * (live + B * step_i) * D


def attn_call_cost(c: BioGptConfig, past: list, window: int,
                   int8: bool = False, step_i: int = 0):
    """(bytes, operations) of one call of ``batched_attention`` (one layer):
    :func:`attn_cost` of one layer, with its qkv rows in (B, 3D) f32 and
    its context rows out (B, D) f32."""
    nbytes, flops = attn_cost(c, past, window, int8, step_i, layers=1)
    B, D = len(past), c.d_model
    return nbytes + B * 3 * D * 4 + B * D * 4, flops


# the batched steps' attention sub-rows: (row, mode, int8, staged step)
ATTN_MODES = (("decode_step_fused batched", "lockstep bf16", False, 0),
              ("decode_step_fused paged", "paged bf16", False, 0),
              ("decode_step_fused int8 KV", "lockstep int8", True, 0),
              ("decode_step_fused paged int8 KV", "paged int8", True, 0),
              ("decode_step_fused staged", "staged bf16", False, STEP_I))


def attn_sub_rows(c: BioGptConfig = BioGptConfig(), past: list = RAGGED_PAST,
                  window: int = WINDOW) -> list:
    """The attention sub-rows of rows 7, 8, 9, 14 and 15 (one step, all L
    layers, :func:`attn_cost`) at the per-slot positions ``past`` (the
    staged row's chunk starts: its positions are ``past + STEP_I``)."""
    recs = []
    for row, mode, int8, step_i in ATTN_MODES:
        nbytes, flops = attn_cost(c, [p + step_i for p in past], window,
                                  int8, step_i)
        ms, by = bound(nbytes, flops)
        recs.append({"kernel": "batched_attention", "row": ROW[row],
                     "mode": mode, "shape": f"B={len(past)}, window {window}",
                     "step_i": step_i, "launches": c.n_layer,
                     "bytes": nbytes, "flops": flops, "bound_ms": ms,
                     "bound_by": by})
    return recs


def tp_step_cost(c: BioGptConfig, past: list, window: int, wbytes: int,
                 tp: int, int8: bool = False):
    """(bytes, operations) of ONE rank's ``decode_step_fused_tp`` at B =
    len(past) per-slot positions: its 1/tp share of the layer planes and of
    its slots' live K/V rows (bf16, or int8 levels with their f32 scales,
    which every rank reads whole), its new local rows out (and, int8, their
    scales), x in and out (B, D) f32 and the positions."""
    D, L, B = c.d_model, c.n_layer, len(past)
    live = sum(min(p, window) for p in past)
    if int8:
        kv = (wbytes + 2 * L * live * D) // tp + 2 * L * live * 4
        out = 2 * L * B * (D // tp) + 2 * L * B * 4
    else:
        kv = (wbytes + 2 * L * live * D * 2) // tp
        out = 2 * L * B * D * 2 // tp
    return (kv + out + 2 * B * D * 4 + B * 4,
            (L * layer_flops(c, B) + 4 * L * live * D) // tp)


def tp_half_cost(c: BioGptConfig, half: str, B: int, live: int, tp: int,
                 planes: int):
    """(bytes, operations) of one call of a TP half for one layer of one
    rank: ``planes`` the bytes of the local weight planes it reads,
    ``live`` the slots' live cache rows. ``half``: "attn" (LN0, qkv,
    attention over bf16 rows, o: x in, rows and the partial out), "attn
    int8" (q, k, v in, int8 rows and their scales, o), "qkv" (LN0, qkv:
    x in, qkv and the absmax out) or "ffn" (LN1, fc1, fc2: x in, the
    partial out)."""
    D, F = c.d_model, c.d_ff
    Dl, Fl = D // tp, F // tp
    x, ln = B * D * 4, 2 * D * 4
    if half == "attn":
        return (planes + ln + 3 * Dl * 4 + 2 * x + 2 * live * Dl * 2
                + 2 * B * Dl * 2 + B * 4,
                2 * B * D * 3 * Dl + 2 * B * Dl * D + 4 * live * Dl)
    if half == "attn int8":
        return (planes + 3 * B * Dl * 4 + x + 2 * live * (Dl + 4) + B * 4,
                2 * B * Dl * D + 4 * live * Dl)
    if half == "qkv":
        return (planes + ln + 3 * Dl * 4 + x + B * 3 * Dl * 4 + B * 8,
                2 * B * D * 3 * Dl)
    return planes + ln + Fl * 4 + 2 * x, 4 * B * D * Fl


def rows(c: BioGptConfig = BioGptConfig(), fmt: str = "q4_0") -> list:
    D, L = c.d_model, c.n_layer
    V = -(-c.n_vocab // 128) * 128
    W = L * layer_bytes(c, fmt)
    B = len(RAGGED_PAST)
    live = sum(min(p, WINDOW) for p in RAGGED_PAST)
    lm = q_bytes(D, V, fmt)
    commit = 4 * L * B * D * 2 + B * 4           # rows read, cache rows written
    out = [
        ("qmatmul_pallas", "pallas_qmatmul.py:860", "lm_head m=1",
         lm + D * 4 + V * 4, 2 * D * V),
        ("qmatmul_pallas_wide", "pallas_qmatmul.py:246", "fc1 m=32",
         q_bytes(D, c.d_ff, fmt) + 32 * D * 4 + 32 * c.d_ff * 4,
         2 * 32 * D * c.d_ff),
        ("lm_head_argmax_pallas", "pallas_qmatmul.py:789", "m=1",
         lm + D * 4 + 2 * D * 4 + 8, 2 * D * V),
        ("lm_head_argmax_commit_pallas", "pallas_qmatmul.py:689",
         "m=32 + commit B=32", lm + B * D * 4 + 2 * D * 4 + B * 8 + commit,
         2 * B * D * V),
        ("lm_head_logits_gmax_commit_pallas", "pallas_qmatmul.py:592",
         "m=32 + commit B=32",
         lm + B * D * 4 + 2 * D * 4 + B * V * 4 + B * V // 128 * 4 + commit,
         2 * B * D * V),
        ("decode_step_fused B=1", "pallas_decode.py:1016", "past=100",
         *bf16_step_cost(c, [100], 128, W)),
        ("decode_step_fused batched", "pallas_decode.py:358",
         "B=32 ragged, window 512",
         *bf16_step_cost(c, RAGGED_PAST, WINDOW, W)),
        ("decode_step_fused paged", "pallas_decode.py:573",
         "B=32 ragged, window 512",
         *bf16_step_cost(c, RAGGED_PAST, WINDOW, W)),
        ("decode_step_fused int8 KV", "pallas_decode.py:1028",
         "B=32 ragged, window 512", *int8_step_cost(c, RAGGED_PAST, WINDOW, W)),
        ("decode_step_fused int8 KV", "pallas_decode.py:1028",
         "B=1, past=100", *int8_step_cost(c, [100], 128, W)),
        ("kv_commit_pallas", "pallas_decode.py:754", "B=32", commit, 0),
        ("kv_commit_quant_pallas", "pallas_decode.py:839", "B=32",
         4 * L * B * (D + 4) + B * 4, 0),
        *(("prefill_fused", "pallas_prefill.py:172",
           f"R={R} prompts x T={T}", *prefill_cost(c, R, T, W))
          for R, T in PREFILL_SHAPES),
        *(("decode_step_fused_tp", "pallas_decode_tp.py:294",
            f"one of {tp} shards, B=32 ragged, window 512"
            + (", int8 KV" if int8 else ""),
            *tp_step_cost(c, RAGGED_PAST, WINDOW, W, tp, int8))
          for tp in (2, 4) for int8 in (False, True)),
        ("decode_step_fused paged int8 KV", "pallas_decode.py:680",
         "B=32 ragged, window 512", *int8_step_cost(c, RAGGED_PAST, WINDOW, W)),
        ("decode_step_fused staged", "pallas_decode.py:502",
         f"B=32 ragged chunk starts, window 512, C={STAGE_ROWS}, "
         f"step_i={STEP_I}",
         *bf16_step_cost(c, [p + STEP_I for p in RAGGED_PAST], WINDOW, W,
                         STEP_I)),
    ]
    recs = []
    for name, where, shape, nbytes, flops in out:
        ms, by = bound(nbytes, flops)
        recs.append({"row": ROW[name], "kernel": name, "replaces": f"biogpt_tpu/ops/"
                     f"{where}", "shape": shape, "format": fmt,
                     "bytes": nbytes, "flops": flops, "bound_ms": ms,
                     "bound_by": by})
    return recs


def main() -> int:
    for fmt in FORMATS:
        for rec in rows(fmt=fmt):
            print(json.dumps(rec))
        for M in (1, 8, 16, 32):
            for rec in gemv_rows(M=M, fmt=fmt):
                print(json.dumps(rec))
        for tp in (2, 4):
            for rec in tp_gemv_rows(tp=tp, fmt=fmt):
                print(json.dumps(rec))
        for R, T in PREFILL_SHAPES:
            for rec in prefill_sub_rows(R=R, T=T, fmt=fmt):
                print(json.dumps(rec))
        for rec in tail_sub_rows(fmt=fmt):
            print(json.dumps(rec))
        for rec in (wide_sub_rows(fmt=fmt) + small_tail_rows(fmt=fmt)
                    + qmatmul_sub_rows(fmt=fmt)):
            print(json.dumps(rec))
        if fmt == "q4_0":   # the attention and the commits read no weights
            for rec in attn_sub_rows() + commit_quant_sub_rows():
                print(json.dumps(rec))
        c = BioGptConfig()
        for name in PROJECTIONS:
            nbytes, flops = prefill_gemm_cost(c, name, 1024, fmt)
            ms, by = bound(nbytes, flops)
            print(json.dumps({"kernel": "prefill_gemm", "projection": name,
                              "m": 1024, "format": fmt, "bytes": nbytes,
                              "flops": flops, "bound_ms": ms,
                              "bound_by": by}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
