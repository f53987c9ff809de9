"""The plain reference of the BioGPT configurations: a float32 forward in
plain PyTorch, from the ggml block bytes of a model file's tensors.

It imports nothing of the program (and neither ``jax`` nor the JAX
package): the block decoding below is its own, frozen from the ggml
formats (QK = 32; Q4_0: an fp16 scale d, 16 bytes of nibbles, low nibble
element j, high j + 16, w = d (q - 8); Q8_0: an fp16 d, 32 int8, w = d q).

The model is HF's ``BioGptForCausalLM`` (microsoft/biogpt), as biogpt.cpp
runs it: token embedding times sqrt(d_model), learned positions at
position + 2, pre-LayerNorm blocks (eps 1e-5, the ``nn.LayerNorm``
default HF's module uses), the query scaled by 1/sqrt(head dim), causal
softmax attention, an exact-erf GELU feed-forward, a final LayerNorm and
an untied lm_head without bias. Departure: none in the mathematics;
dropout is off, as at inference.

With ``fp8`` every matmul operand other than the weights (the LayerNorm
outputs, q, k, v, the attention probabilities, the context, the GELU
output) goes through float8 e4m3 with a per-row scale: the control of
the correctness check, a precision below the program's bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

QK = 32


def dequant(blocks: torch.Tensor, fmt: str, shape: tuple) -> torch.Tensor:
    """(n_blocks, block bytes) uint8 -> float32 of ``shape``."""
    d = blocks[:, 0:2].contiguous().view(torch.float16).to(torch.float32)
    if fmt == "q4_0":
        qs = blocks[:, 2:18]
        q = torch.cat([qs & 0x0F, qs >> 4], dim=1).to(torch.float32) - 8.0
    elif fmt == "q8_0":
        q = blocks[:, 2:34].contiguous().view(torch.int8).to(torch.float32)
    else:
        raise ValueError(f"no decoder for {fmt}")
    return (q * d).reshape(shape)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3, scaled per row to its largest magnitude."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s



class Reference:
    """The model of one seed, dequantized to float32 on ``device``."""

    def __init__(self, m: dict, fmt: str, blocks: np.ndarray, where: dict,
                 dense: Dict[str, np.ndarray], device):
        self.m, self.dev = m, torch.device(device)
        raw = torch.from_numpy(blocks).to(self.dev)
        w = {}
        for name, (b0, nb, shape) in where.items():
            w[name] = dequant(raw[b0:b0 + nb], fmt, shape)
        del raw
        for name, arr in dense.items():
            w[name] = torch.from_numpy(np.asarray(arr, np.float32)).to(self.dev)
        self.w = w

    def logits(self, ids, fp8: bool = False) -> torch.Tensor:
        """Causal logits (N, n_vocab) float32 of the token ids ``ids``
        (with ``fp8``, the control's)."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(ids, fp8_rows if fp8 else (lambda x: x))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _logits(self, ids, r: Callable) -> torch.Tensor:
        m, w = self.m, self.w
        D, H = m["d_model"], m["n_head"]
        Dk = D // H
        N = len(ids)
        tok = torch.as_tensor(list(ids), dtype=torch.long, device=self.dev)
        pos = torch.arange(N, device=self.dev) + m["pos_offset"]
        x = (w["biogpt.embed_tokens.weight"][tok] * math.sqrt(D)
             + w["biogpt.embed_positions.weight"][pos])
        mask = torch.ones(N, N, dtype=torch.bool, device=self.dev).tril()

        def ln(v, name):
            return torch.nn.functional.layer_norm(
                v, (D,), w[name + ".weight"], w[name + ".bias"], eps=1e-5)

        def lin(v, name):
            return r(v) @ w[name + ".weight"].T + w[name + ".bias"]

        for i in range(m["n_layer"]):
            p = f"biogpt.layers.{i}."
            h = ln(x, p + "self_attn_layer_norm")
            q = lin(h, p + "self_attn.q_proj") / math.sqrt(Dk)
            k = lin(h, p + "self_attn.k_proj")
            v = lin(h, p + "self_attn.v_proj")
            q, k, v = (r(t).reshape(N, H, Dk).transpose(0, 1)
                       for t in (q, k, v))
            s = (q @ k.transpose(1, 2)).masked_fill(~mask, -math.inf)
            a = r(torch.softmax(s, dim=-1))
            ctx = (a @ v).transpose(0, 1).reshape(N, D)
            x = x + lin(ctx, p + "self_attn.out_proj")
            h = ln(x, p + "final_layer_norm")
            f = torch.nn.functional.gelu(lin(h, p + "fc1"))
            x = x + lin(f, p + "fc2")
        x = ln(x, "biogpt.layer_norm")
        return r(x) @ w["output_projection.weight"].T
