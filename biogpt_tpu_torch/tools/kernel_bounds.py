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
figures). ``chip_smoke.py`` computes the ported kernels' bounds with the
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
    scales, the new rows out in f32, x in and out (and the B>1 positions)."""
    D, L, B = c.d_model, c.n_layer, len(past)
    live = sum(min(p, window) for p in past)
    return (wbytes + 2 * L * live * (D + 4) + 2 * L * B * D * 4
            + 2 * B * D * 4 + (B * 4 if B > 1 else 0),
            L * (layer_flops(c, B) + 4 * live * D))


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
         W + 2 * L * 100 * D * 2 + 2 * L * D * 2 + 2 * D * 4,
         L * layer_flops(c, 1) + 4 * L * 100 * D),
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
