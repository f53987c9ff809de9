"""The yardstick's arithmetic: the card's published peaks, the least time
of a piece of work, and the model's operations per token.

Frozen copy of ``biogpt_tpu_torch/tools/kernel_bounds.py`` (``bound``,
``q_bytes``, ``layer_bytes``, ``layer_flops``, ``prefill_cost`` and
``bf16_step_cost``), extended from that module's fixed shapes to the
shapes a cell's own traffic gives: a decode step's live slots at their
positions, and a refill group's real prompt lengths. Each input byte is
counted read once and each output byte written once, whatever a kernel
reads again, and a piece of work counts only what its requests need
(no padding rows, no dead slots, no steps past a request's end).
"""

from __future__ import annotations

# NVIDIA H100 SXM 80 GB, published data sheet (dense, no sparsity; at the
# card's full 700 W power limit)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
}
QK = 32   # ggml block size of every quantized format


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    its memory rate and the operations over its bf16 tensor rate."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["bf16_flops"])


def q_bytes(d_in: int, d_out: int, fmt: str) -> int:
    """The planes of one (d_in, d_out) weight: 4 or 8 bits of levels per
    weight and a 16-bit scale per 32 weights (0.5625 bytes a weight for
    Q4_0, 1.0625 for Q8_0), as the ggml blocks hold them."""
    bits = {"q4_0": 4, "q8_0": 8}[fmt]
    return d_in * bits // 8 * d_out + (d_in // QK) * d_out * 2


def layer_bytes(m: dict, fmt: str) -> int:
    """One decoder layer's weight planes, f32 biases and LayerNorms."""
    D, F = m["d_model"], m["d_ff"]
    planes = (q_bytes(D, 3 * D, fmt) + q_bytes(D, D, fmt) + q_bytes(D, F, fmt)
              + q_bytes(F, D, fmt))
    return planes + (3 * D + D + F + D) * 4 + 4 * D * 4


def weight_bytes(m: dict, fmt: str) -> int:
    """Everything a whole-model step reads once: every layer, the final
    LayerNorm and the lm_head's planes (its real vocabulary columns)."""
    return (m["n_layer"] * layer_bytes(m, fmt) + 2 * m["d_model"] * 4
            + q_bytes(m["d_model"], m["n_vocab"], fmt))


def layer_flops(m: dict, rows: int) -> int:
    """The four projections of one layer on ``rows`` rows."""
    D, F = m["d_model"], m["d_ff"]
    return 2 * rows * (D * 3 * D + D * D + 2 * D * F)


def token_flops(m: dict, context: int, head: bool = True) -> int:
    """Model operations of one token that attends ``context`` positions
    (itself included): 2 x the layers' projection weights, 4 x L x
    d_model x context for the scores and p.V and, where ``head``, 2 x the
    lm_head (a prompt's rows need it only on the last one)."""
    D, L = m["d_model"], m["n_layer"]
    return (L * layer_flops(m, 1) + 4 * L * D * context
            + (2 * D * m["n_vocab"] if head else 0))


def request_flops(m: dict, prompt: int, new: int) -> int:
    """Model operations of a request of ``prompt`` tokens and ``new``
    generated ones: every prompt row (the lm_head on its last, which
    gives the first new token) and a step for each later new token, each
    at its own context."""
    if new < 1:
        return 0
    rows = prompt + new - 1   # at contexts 1, 2, ..., rows
    D, L = m["d_model"], m["n_layer"]
    return (rows * L * layer_flops(m, 1) + 4 * L * D * rows * (rows + 1) // 2
            + new * 2 * D * m["n_vocab"])


def decode_cost(m: dict, fmt: str, steps: int, positions: list):
    """(bytes, operations) of ``steps`` whole-model decode steps that
    together generate one token at each of ``positions`` (a live slot's
    position: the KV rows already in its cache): the weights once a step,
    each token's K/V rows below its position read once and its new K/V
    rows written once (bf16), x and the token in and out. A step's logits
    are not counted: the greedy tails never write them."""
    D, L = m["d_model"], m["n_layer"]
    kv_read = sum(2 * L * p * D * 2 for p in positions)
    per_tok = 2 * L * D * 2 + 2 * D * 4 + 8
    flops = sum(token_flops(m, p + 1) for p in positions)   # one a token
    return steps * weight_bytes(m, fmt) + kv_read + per_tok * len(positions), flops


def refill_cost(m: dict, fmt: str, prompts: list):
    """(bytes, operations) of one refill group of real prompt lengths
    ``prompts``: the weights once, each prompt's K/V rows written once
    (bf16), its tokens in; 2 x params a prompt token, causal attention
    over each prompt, and the lm_head on each prompt's last row."""
    D, L, V = m["d_model"], m["n_layer"], m["n_vocab"]
    nbytes = weight_bytes(m, fmt)
    flops = 0
    for T in prompts:
        nbytes += 2 * L * T * D * 2 + T * 8
        flops += (L * layer_flops(m, T) + 4 * L * D * (T * (T + 1) // 2)
                  + 2 * D * V)
    return nbytes, flops
