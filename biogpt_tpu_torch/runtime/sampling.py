"""Token samplers (``biogpt_tpu/runtime/sampling.py``).

``sample_top_k_top_p`` keeps the reference sampler's math: logits / temp ->
top-k -> softmax over the survivors -> keep through the first index where
the cumulative probability reaches top_p -> renormalize -> draw.
``sample_per_request`` does the same per row with each request's own temp,
top_k and top_p (continuous batching), routing temp <= 0 rows to argmax.
The draw uses an explicit ``torch.Generator`` (Gumbel-max over the kept log
probabilities, as ``jax.random.categorical`` draws), so it stays on the
device and never synchronises; it cannot give JAX's random bits, so tests
compare the filtered distributions.

Every top-k here is index-stable: among equal values the lowest index comes
first, as ``lax.top_k`` gives. ``torch.topk`` promises no order among ties,
and the samplers rely on ``top_ids[:, 0]`` being the argmax.
"""

from __future__ import annotations

import torch

GROUP = 128   # column group width of the gather top-k (the lm_head's lanes)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int32 argmax ids (ties to the lowest index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def topk_stable(x: torch.Tensor, k: int):
    """Top-k of each row, (values, int64 indices), ordered by value and then
    by index: a stable descending sort keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def topk_gather(x: torch.Tensor, k: int, gmax: torch.Tensor | None = None):
    """Exact top-k through group maxima: rank the 128-column groups by their
    maximum, gather the k best groups' columns (group ids re-sorted
    ascending, so the gathered columns stay in index order) and take the
    top-k of those k*128 values. Equal to :func:`topk_stable` including
    ties. ``gmax``: the (B, ceil(V/128)) group maxima when the caller has
    them (the fused sampled epilogue emits them)."""
    B, V = x.shape
    G = -(-V // GROUP)
    if G < k:   # fewer groups than k: no ranking stage
        return topk_stable(x, k)
    pad = G * GROUP - V
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=-float("inf"))
    xg = x.reshape(B, G, GROUP)
    if gmax is None:
        gmax = xg.amax(-1)
    _, gi = topk_stable(gmax, k)
    gi = torch.sort(gi, dim=-1).values
    slab = torch.gather(xg, 1, gi[:, :, None].expand(B, k, GROUP))
    vals, sel = topk_stable(slab.reshape(B, k * GROUP), k)
    cols = (gi[:, :, None] * GROUP
            + torch.arange(GROUP, device=x.device)[None, None, :]).reshape(B, -1)
    return vals, torch.gather(cols, 1, sel)


def top_k_top_p_probs(logits: torch.Tensor, top_k: int, top_p, temp):
    """(probs (B, top_k), token_ids (B, top_k)) after top-k / top-p
    filtering, sorted by descending probability. ``top_p`` and ``temp``:
    host floats, or tensors on the logits' device that broadcast against
    (B, 1) (a decode chunk's graph reads them there)."""
    raw, top_ids = topk_stable(logits.to(torch.float32), top_k)
    if isinstance(temp, torch.Tensor):
        temp = torch.clamp_min(temp.to(torch.float32), 1e-8)
    else:
        temp = max(temp, 1e-8)
    probs = torch.softmax(raw / temp, dim=-1)
    cumsum = torch.cumsum(probs, dim=-1)
    keep = ((cumsum - probs) < top_p) | (top_p >= 1.0)
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True)
    return probs, top_ids.to(torch.int32)


def _uniform(shape, generator: torch.Generator, device,
             rows=None) -> torch.Tensor:
    """Uniform draws of ``shape`` (n, k). ``rows`` = (total, index): the
    n rows are rows ``index`` (a slice, or a tensor of row numbers) of a
    batch of ``total``, and the draw is made for the whole batch and
    theirs kept, so that a replica's shard of a batch draws what the whole
    batch does and every replica's generator advances alike."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    total, index = rows
    return torch.rand((total, shape[1]), generator=generator,
                      device=device)[index]


def skip_rows(generator: torch.Generator, total: int, k: int,
              device) -> None:
    """Advance ``generator`` past the draw of a (total, k) batch that
    :func:`sample_per_request` would make, for a replica that owns none of
    the batch's rows."""
    torch.rand((total, k), generator=generator, device=device)


def _draw(probs: torch.Tensor, generator: torch.Generator,
          rows=None) -> torch.Tensor:
    """(B,) column drawn from each row of ``probs`` (Gumbel-max)."""
    u = _uniform(probs.shape, generator, probs.device, rows)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(torch.log(probs.clamp_min(1e-38)) + gumbel, dim=-1)


def sample_top_k_top_p(logits: torch.Tensor, generator: torch.Generator,
                       top_k: int = 40, top_p=0.9, temp=0.9) -> torch.Tensor:
    """(B,) int32 sampled ids; requires temp > 0 (callers route temp <= 0 to
    :func:`greedy`). ``generator`` lives on the logits' device; ``top_p``
    and ``temp`` as in :func:`top_k_top_p_probs`."""
    probs, top_ids = top_k_top_p_probs(logits, top_k, top_p, temp)
    choice = _draw(probs, generator)
    return torch.gather(top_ids, 1, choice[:, None])[:, 0]


def sample_per_request(logits: torch.Tensor, generator: torch.Generator,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       temp: torch.Tensor, max_top_k: int = 64,
                       gmax: torch.Tensor | None = None,
                       rows=None) -> torch.Tensor:
    """(B,) int32 ids with per-row sampling parameters: ``top_k`` (B,) int
    (at most ``max_top_k`` count), ``top_p`` and ``temp`` (B,) float; a
    temp <= 0 row takes its argmax, ``top_ids[:, 0]``. ``gmax``: the
    logits' 128-column group maxima, when the caller has them. ``rows``:
    (total, index) where these B rows are a replica's rows ``index`` of a
    batch of ``total`` (:func:`_uniform`)."""
    B, V = logits.shape
    k_max = min(max_top_k, V)
    temp = temp.to(torch.float32).reshape(B, 1)
    top_p = top_p.to(torch.float32).reshape(B, 1)
    top_k = top_k.reshape(B, 1)
    x = logits.to(torch.float32)
    if gmax is not None:
        raw, top_ids = topk_gather(x, k_max, gmax=gmax)
    else:
        raw, top_ids = topk_stable(x, k_max)
    top_logits = raw / torch.clamp_min(temp, 1e-8)
    rank = torch.arange(k_max, device=logits.device)[None, :]
    in_k = rank < torch.clamp_max(top_k, k_max)
    top_logits = torch.where(in_k, top_logits,
                             torch.full_like(top_logits, -float("inf")))
    probs = torch.softmax(top_logits, dim=-1)
    cumsum = torch.cumsum(probs, dim=-1)
    keep = (((cumsum - probs) < top_p) | (top_p >= 1.0)) & in_k
    probs = torch.where(keep, probs, torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True)
    choice = _draw(probs, generator, rows)
    sampled = torch.gather(top_ids, 1, choice[:, None])[:, 0]
    return torch.where(temp[:, 0] <= 0.0, top_ids[:, 0], sampled).to(
        torch.int32)
