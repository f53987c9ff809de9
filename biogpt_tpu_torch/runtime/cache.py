"""Dense KV cache (``biogpt_tpu/runtime/cache.py``).

k, v: (n_layer, batch, max_len, d_model), the feature axis flat (heads are
contiguous in d_model), as the JAX package lays it out. Unlike the JAX
cache, which is a pytree updated functionally, this one is updated in place
(``index_copy_``), so a step never copies the cache.
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


def update_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, past: int) -> KVCache:
    """Write (batch, n_new, d_model) rows into one layer at offset ``past``,
    in place. Raises where the JAX update would clamp onto the last slot."""
    n = k_new.shape[1]
    if past + n > cache.max_len:
        raise ValueError(f"cache write [{past}, {past + n}) past max_len "
                         f"{cache.max_len}")
    idx = torch.arange(past, past + n, device=cache.k.device)
    cache.k[layer].index_copy_(1, idx, k_new.to(cache.k.dtype))
    cache.v[layer].index_copy_(1, idx, v_new.to(cache.v.dtype))
    return cache


def commit_rows(cache: KVCache, k_rows: torch.Tensor, v_rows: torch.Tensor,
                past: int) -> KVCache:
    """Write every layer's new row (L, batch, d_model) at position ``past``
    (the fused decode step's caller-side commit), in place."""
    cache.k[:, :, past] = k_rows.to(cache.k.dtype)
    cache.v[:, :, past] = v_rows.to(cache.v.dtype)
    return cache
