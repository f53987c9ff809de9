"""Dense KV cache (``biogpt_tpu/runtime/cache.py``).

k, v: (n_layer, batch, max_len, d_model), the feature axis flat (heads are
contiguous in d_model), as the JAX package lays it out. Unlike the JAX
cache, which is a pytree updated functionally, this one is updated in place
(``index_copy_``, index stores), so a step never copies the cache.

Positions are a host int (one offset for every row) or a (batch,) integer
tensor on the device (per-slot positions of batched serving; reading it on
the host would stall the pipeline). A per-slot write clamps its start to
``[0, max_len - n]`` as ``lax.dynamic_update_slice`` does: the JAX serve
can feed a slot past the end of its cache (a prompt that leaves less than
one chunk of room still decodes that chunk, and the request is then
truncated), and the port writes where the JAX update does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import BioGptConfig


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor   # (n_layer, batch, max_len, d_model)
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


def init_cache(config: BioGptConfig, batch: int = 1, max_len: int | None = None,
               dtype=torch.float16, device="cpu") -> KVCache:
    shape = (config.n_layer, batch, max_len or config.n_positions,
             config.d_model)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def slot_positions(past: torch.Tensor, n: int, max_len: int) -> torch.Tensor:
    """(batch, n) write positions of per-slot offsets ``past`` (batch,),
    the start clamped to ``[0, max_len - n]`` (dynamic_update_slice)."""
    start = torch.clamp(past.to(torch.int64), 0, max_len - n)
    return start[:, None] + torch.arange(n, device=past.device)[None, :]


def update_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, past) -> KVCache:
    """Write (batch, n_new, d_model) rows into one layer at offset ``past``
    (a host int, or a (batch,) tensor of per-slot offsets), in place. A
    host-int write past ``max_len`` raises; a per-slot one clamps."""
    n = k_new.shape[1]
    if isinstance(past, torch.Tensor):
        pos = slot_positions(past, n, cache.max_len)
        rows = torch.arange(k_new.shape[0], device=pos.device)[:, None]
        cache.k[layer][rows, pos] = k_new.to(cache.k.dtype)
        cache.v[layer][rows, pos] = v_new.to(cache.v.dtype)
        return cache
    if past + n > cache.max_len:
        raise ValueError(f"cache write [{past}, {past + n}) past max_len "
                         f"{cache.max_len}")
    idx = torch.arange(past, past + n, device=cache.k.device)
    cache.k[layer].index_copy_(1, idx, k_new.to(cache.k.dtype))
    cache.v[layer].index_copy_(1, idx, v_new.to(cache.v.dtype))
    return cache


def commit_rows(cache: KVCache, k_rows: torch.Tensor, v_rows: torch.Tensor,
                past: int) -> KVCache:
    """Write every layer's new row (L, batch, d_model) at the host's
    position ``past`` -- the single-stream fused decode step's caller-side
    commit -- in place. Per-slot positions commit through
    ``ops.decode_kernels.kv_commit``."""
    cache.k[:, :, past] = k_rows.to(cache.k.dtype)
    cache.v[:, :, past] = v_rows.to(cache.v.dtype)
    return cache


def merge_rows(cache: KVCache, small: KVCache, slots, rows) -> KVCache:
    """Serving refill: slot ``slots[i]`` of ``cache`` takes row ``rows[i]``
    of the freshly prefilled ``small`` cache over its ``[0, padded)``
    prefix, ``padded = small.max_len`` (rows past a prompt hold padding that
    no later read reaches: attention masks ``idx < past``). In place;
    ``slots``/``rows`` are (n,) index tensors on the cache's device."""
    padded = small.max_len
    cache.k[:, slots, :padded] = small.k[:, rows].to(cache.k.dtype)
    cache.v[:, slots, :padded] = small.v[:, rows].to(cache.v.dtype)
    return cache
