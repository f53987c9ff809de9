"""Token samplers (``biogpt_tpu/runtime/sampling.py``).

``sample_top_k_top_p`` keeps the reference sampler's math: logits / temp ->
top-k -> softmax over the survivors -> keep through the first index where
the cumulative probability reaches top_p -> renormalize -> draw. The draw
uses an explicit ``torch.Generator`` (Gumbel-max over the kept log
probabilities, as ``jax.random.categorical`` draws), so it stays on the
device and never synchronises; it cannot give JAX's random bits, so tests
compare the filtered distributions.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32 argmax ids (ties to the lowest index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k_top_p_probs(logits: torch.Tensor, top_k: int, top_p: float,
                      temp: float):
    """(probs (B, top_k), token_ids (B, top_k)) after top-k / top-p
    filtering, sorted by descending probability."""
    raw, top_ids = torch.topk(logits.to(torch.float32), top_k, dim=-1)
    probs = torch.softmax(raw / max(temp, 1e-8), dim=-1)
    cumsum = torch.cumsum(probs, dim=-1)
    keep = ((cumsum - probs) < top_p) | (top_p >= 1.0)
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True)
    return probs, top_ids.to(torch.int32)


def sample_top_k_top_p(logits: torch.Tensor, generator: torch.Generator,
                       top_k: int = 40, top_p: float = 0.9,
                       temp: float = 0.9) -> torch.Tensor:
    """(B,) int32 sampled ids; requires temp > 0 (callers route temp <= 0 to
    :func:`greedy`). ``generator`` lives on the logits' device."""
    probs, top_ids = top_k_top_p_probs(logits, top_k, top_p, temp)
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    choice = torch.argmax(torch.log(probs.clamp_min(1e-38)) + gumbel, dim=-1)
    return torch.gather(top_ids, 1, choice[:, None])[:, 0]
