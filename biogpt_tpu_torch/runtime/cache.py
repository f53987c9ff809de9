"""Dense and int8 KV caches (``biogpt_tpu/runtime/cache.py``).

k, v: (n_layer, batch, max_len, d_model), the feature axis flat (heads are
contiguous in d_model), as the JAX package lays it out. Unlike the JAX
cache, which is a pytree updated functionally, this one is updated in place
(``index_copy_``, index stores), so a step never copies the cache.

``QuantKVCache`` (``kv_quant=True``) stores K/V as int8 levels with one f32
absmax scale per written row, in lane-major (n_layer, batch, 1, max_len)
planes, as the JAX package does. Rows quantize through
:func:`quantize_rows` (amax / 127, round half to even) and read back
through :func:`dequant_layer` (level x scale in f32, one rounding).

Under tensor parallelism (``parallel/``) each rank holds a shard of the
feature axis, (n_layer, batch, max_len, d_model / tp): heads are contiguous
in d_model, so this is head sharding. On a mesh with a data axis that
divides the serving batch, ``batch`` is the replica's own slots
(``Mesh.batch_rows``). An int8 shard's scale planes are
whole on every rank: :func:`quantize_rows` completes each row's absmax
over the model axis' process group, so every rank writes the same
full-row scale and the sharded levels equal the unsharded ones.

Positions are a host int (one offset for every row) or a (batch,) integer
tensor on the device (per-slot positions of batched serving; reading it on
the host would stall the pipeline). Every block write (:func:`write_block`)
clamps its start to ``[0, max_len - n]`` as ``lax.dynamic_update_slice``
does: the JAX serve can feed a slot past the end of its cache (a prompt
that leaves less than one chunk of room still decodes that chunk, and the
request is then truncated), and the port writes where the JAX update does.
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


@dataclasses.dataclass
class QuantKVCache(KVCache):
    ks: torch.Tensor = None   # (n_layer, batch, 1, max_len) f32 row scales
    vs: torch.Tensor = None


def init_cache(config: BioGptConfig, batch: int = 1, max_len: int | None = None,
               dtype=torch.float16, device="cpu", tp: int = 1) -> KVCache:
    """Zeroed caches; ``tp`` > 1 builds one rank's feature shard, and
    ``batch`` is the rows this rank holds (a replica's own slots on a data
    axis)."""
    shape = (config.n_layer, batch, max_len or config.n_positions,
             config.d_model // tp)
    if dtype == torch.int8:
        sshape = shape[:2] + (1, shape[2])
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.zeros(sshape, dtype=torch.float32, device=device),
            vs=torch.zeros(sshape, dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def clear_cache(cache: KVCache) -> None:
    """Zero every plane of ``cache`` in place, its addresses kept (an
    engine's reused cache after a generation or serve whose logits went
    non-finite: masked reads of the plain versions multiply stale rows by
    zero, which a NaN row would poison)."""
    for t in (cache.k, cache.v, getattr(cache, "ks", None),
              getattr(cache, "vs", None)):
        if t is not None:
            t.zero_()


def quantize_rows(x: torch.Tensor, group=None, amax=None):
    """(..., D) float -> (int8 levels, (...) f32 scales): per-row absmax/127,
    the scale floored at 1e-12 for the division, levels rounded half to
    even and clipped to +-127. ``group``: the model axis' process group
    when ``x`` is this rank's shard of the rows; the absmax is completed
    with an all-reduce max over it (order-free, so the scale is the
    unsharded row's). ``amax``: the local absmax, where a kernel already
    took it. On a (data, model) mesh ``group`` is the model axis' group,
    never the world's: the replicas' rows are other rows."""
    x = x.to(torch.float32)
    if amax is None:
        amax = x.abs().amax(-1)
    if group is not None:
        from ..parallel.distributed import all_reduce_max
        amax = all_reduce_max(amax, group)
    # a divide by a tensor: PyTorch's CUDA divide by a host scalar
    # multiplies by its reciprocal, which is not the reference's amax / 127
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.clamp(scale, min=1e-12)
    # rounded and clipped in place: one f32 temporary beside ``x``
    q = x / safe[..., None]
    return q.round_().clamp_(-127, 127).to(torch.int8), scale


def dequant_layer(cache: QuantKVCache, layer: int, S: int, dtype):
    """Layer views (batch, S, d_model) of a quantized cache: level x scale in
    f32, one rounding to ``dtype``."""
    k = cache.k[layer][:, :S].to(torch.float32)
    v = cache.v[layer][:, :S].to(torch.float32)
    ks = cache.ks[layer][:, :, :S].transpose(1, 2)
    vs = cache.vs[layer][:, :, :S].transpose(1, 2)
    return (k * ks).to(dtype), (v * vs).to(dtype)


def write_block(buf: torch.Tensor, rows: torch.Tensor, start) -> None:
    """In place: ``buf[..., b, start_b + i, :] = rows[..., b, i, :]`` for
    ``buf`` (..., batch, max_len, d) and ``rows`` (..., batch, n, d).
    ``start``: a host int (every slot) or a (batch,) integer tensor
    (per slot). As in ``lax.dynamic_update_slice``, a negative start counts
    from the end, and then each start clamps into ``[0, max_len - n]``.
    Its torch ops are ordinary launches: the batched steps' attention reads
    the cache rows before it waits on the kernel before it
    (``csrc/attn_batched.cuh``), so no writer of the caches may be a
    programmatic dependent."""
    n, max_len = rows.shape[-2], buf.shape[-2]
    rows = rows.to(buf.dtype)
    if not isinstance(start, torch.Tensor):
        s = int(start)
        s = min(max(s + max_len if s < 0 else s, 0), max_len - n)
        buf[..., s:s + n, :] = rows
        return
    start = start.to(torch.int64)
    start = torch.where(start < 0, start + max_len, start)
    pos = (torch.clamp(start, 0, max_len - n)[:, None]
           + torch.arange(n, device=start.device)[None, :])
    slots = torch.arange(buf.shape[-3], device=start.device)[:, None]
    buf[..., slots, pos, :] = rows


def _write(cache: KVCache, layer: int, k_new, v_new, past, ks_new=None,
           vs_new=None) -> None:
    """Store (batch, n, d_model) rows (and, for an int8 cache, their (batch,
    n) scales) at ``past``, in place."""
    write_block(cache.k[layer], k_new, past)
    write_block(cache.v[layer], v_new, past)
    if isinstance(cache, QuantKVCache):
        write_block(cache.ks[layer][:, 0, :, None], ks_new[..., None], past)
        write_block(cache.vs[layer][:, 0, :, None], vs_new[..., None], past)


def update_layer(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, past, group=None) -> KVCache:
    """Write (batch, n_new, d_model) rows into one layer at offset ``past``
    (a host int, or a (batch,) tensor of per-slot offsets), in place; an
    int8 cache quantizes them first (over ``group``, a sharded cache's
    model axis: :func:`quantize_rows`). A write past ``max_len`` clamps, as
    ``lax.dynamic_update_slice`` does."""
    if isinstance(cache, QuantKVCache):
        kq, ksc = quantize_rows(k_new, group)
        vq, vsc = quantize_rows(v_new, group)
        _write(cache, layer, kq, vq, past, ksc, vsc)
    else:
        _write(cache, layer, k_new, v_new, past)
    return cache


def commit_rows(cache: KVCache, k_rows: torch.Tensor, v_rows: torch.Tensor,
                past: int) -> KVCache:
    """Write every layer's new row (L, batch, d_model) at the host's
    position ``past`` -- the single-stream fused decode step's caller-side
    commit -- in place; an int8 cache quantizes the rows in the same
    commit (``ops.decode_kernels.kv_commit_quant_rows``: one launch on the
    card, the position clamped into the cache). Per-slot positions commit
    through ``ops.decode_kernels.kv_commit`` and ``kv_commit_quant_rows``."""
    if isinstance(cache, QuantKVCache):
        from ..ops.decode_kernels import kv_commit_quant_rows

        kv_commit_quant_rows(cache.k, cache.v, cache.ks, cache.vs, k_rows,
                             v_rows, past)
        return cache
    cache.k[:, :, past] = k_rows.to(cache.k.dtype)
    cache.v[:, :, past] = v_rows.to(cache.v.dtype)
    return cache


def merge_rows(cache: KVCache, small: KVCache, slots, rows) -> KVCache:
    """Serving refill: slot ``slots[i]`` of ``cache`` takes row ``rows[i]``
    of the freshly prefilled ``small`` cache over its ``[0, padded)``
    prefix, ``padded = small.max_len`` (rows past a prompt hold padding that
    no later read reaches: attention masks ``idx < past``); an int8 cache
    takes the levels on axis 2 and the scales on axis 3. In place;
    ``slots``/``rows`` are (n,) index tensors on the cache's device. A slot
    may repeat only with the same row (a refill body's padding rows write
    row 0's values again), so every write to it is the same."""
    padded = small.max_len
    cache.k[:, slots, :padded] = small.k[:, rows].to(cache.k.dtype)
    cache.v[:, slots, :padded] = small.v[:, rows].to(cache.v.dtype)
    if isinstance(cache, QuantKVCache):
        cache.ks[:, slots, :, :padded] = small.ks[:, rows]
        cache.vs[:, slots, :, :padded] = small.vs[:, rows]
    return cache
