"""Megatron tensor parallelism with per-shard packed planes
(``biogpt_tpu/parallel/tp.py``).

Every rank runs the whole forward on its LOCAL weight planes, with the
collectives at the Megatron joins (``parallel/mesh.py``):

  q/k/v   column-parallel (fused, shard-interleaved) -> local
  attention over the local head group               -> local
  o       row-parallel                              -> sum all-reduce
  fc1     column-parallel                           -> local
  fc2     row-parallel                              -> sum all-reduce
  lm_head column-parallel over the lane-padded vocab -> all_gather

The KV cache shards its d_model axis (contiguous head groups). Packing is
sharding-aware, as in the JAX package: 4/5-bit planes pack split-half,
which interleaves d_in rows, so the row-parallel o and fc2 pack each
shard's d_in chunk on its own (``pack_nibble_planes(chunks=tp)``) and a
shard's rows are a packed plane by themselves; the fused qkv concatenates
per-shard column groups (q_s | k_s | v_s), so a plain column shard is one
rank's q, k and v; the lm_head's vocab pads to a multiple of tp * 128 so
every shard's slice stays lane-aligned.

The data axis: the forward takes a replica's own rows. Where the data
axis divides the batch B, a replica runs its B / data slots (``Mesh.
batch_rows``) and its cache holds only those; otherwise every replica runs
the whole batch (JAX ``tp_forward``'s ``dspec``). The engines apply the
rule; the halves (``supports_layers_tp`` at the local batch) and the
commits then run at the local batch.

``make_tp_forward`` gives the drop-in for ``models.biogpt.forward`` that
the engines call: the per-op body with the collectives (and, with
``seq_parallel``, Megatron sequence parallelism for prefill shapes), or,
with ``fused_decode`` and a one-token step whose local shapes pass
``supports_layers_tp``, the TP decode step's kernel halves
(``ops/decode_tp_kernels.py``) and the local KV commit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import BioGptConfig
from ..modelio.checkpoint import tree_map
from ..models.biogpt import _decode_x0, _layer_norm, _per_row, forward
from ..ops import matmul
from ..ops.decode_kernels import kv_commit, kv_commit_quant
from ..ops.decode_tp_kernels import decode_step_fused_tp, supports_layers_tp
from ..ops.qmatmul_kernels import LANES
from ..quant.codecs import QK
from ..quant.layouts import QuantizedTensor, pack_nibble_planes
from ..runtime.cache import QuantKVCache, write_block
from .mesh import Mesh

_COLUMN = ("qkv", "fc1")      # d_out sharded (weights and biases)
_ROW = ("o", "fc2")           # d_in sharded (weights; biases whole)


def _slice(w, lo: int, hi: int):
    if isinstance(w, QuantizedTensor):
        return w.map(lambda a: a[..., lo:hi])
    return w[..., lo:hi]


def _concat(parts: list):
    p0 = parts[0]
    if isinstance(p0, QuantizedTensor):
        return dataclasses.replace(
            p0, levels=torch.cat([p.levels for p in parts], -1),
            scales=torch.cat([p.scales for p in parts], -1),
            mins=(torch.cat([p.mins for p in parts], -1)
                  if p0.mins is not None else None))
    return torch.cat(parts, -1)


def fuse_qkv_interleaved(layers: dict, tp: int) -> dict:
    """Fuse q/k/v into one column-parallel weight concatenated PER SHARD
    GROUP: columns [(q_0|k_0|v_0) | (q_1|k_1|v_1) | ...], so shard s's
    column slice holds its own q, k and v."""
    qw = layers["q"]["w"]
    d_out = qw.d_out if isinstance(qw, QuantizedTensor) else qw.shape[-1]
    if d_out % tp:
        raise ValueError(f"d_model {d_out} does not split over {tp} shards")
    per = d_out // tp
    parts, bparts = [], []
    for s in range(tp):
        for n in ("q", "k", "v"):
            parts.append(_slice(layers[n]["w"], s * per, (s + 1) * per))
            bparts.append(layers[n]["b"][..., s * per:(s + 1) * per])
    out = {k: v for k, v in layers.items() if k not in ("q", "k", "v")}
    out["qkv"] = {"w": _concat(parts), "b": torch.cat(bparts, -1)}
    return out


def _pad_cols(w, d_out_padded: int):
    """Zero-pad a (possibly quantized) weight's d_out axis."""
    def pad(a):
        n = d_out_padded - a.shape[-1]
        return a if n == 0 else torch.nn.functional.pad(a, (0, n))
    return w.map(pad) if isinstance(w, QuantizedTensor) else pad(w)


def pack_params_tp(params: dict, tp: int) -> dict:
    """Sharding-aware weight packing for the TP engines (the JAX
    ``pack_params_tp``): qkv fused shard-interleaved; 4/5-bit planes
    nibble-packed, the row-parallel o and fc2 per shard chunk; scale and
    min planes in bf16; the lm_head's vocab padded to a multiple of
    tp * 128. Dense weights are only fused and padded."""

    def pack(w, chunks: int = 1):
        if not isinstance(w, QuantizedTensor) or w.packed:
            return w
        w = pack_nibble_planes(w, chunks=chunks)
        return dataclasses.replace(
            w, scales=w.scales.to(torch.bfloat16),
            mins=w.mins.to(torch.bfloat16) if w.mins is not None else None)

    layers = {}
    for name, leaf in fuse_qkv_interleaved(params["layers"], tp).items():
        if isinstance(leaf, dict) and isinstance(leaf.get("w"), QuantizedTensor):
            leaf = {"w": pack(leaf["w"], tp if name in _ROW else 1),
                    "b": leaf["b"]}
        layers[name] = leaf
    lm = params["lm_head"]
    d_out = lm.d_out if isinstance(lm, QuantizedTensor) else lm.shape[-1]
    mult = tp * LANES
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = pack(_pad_cols(lm, -(-d_out // mult) * mult))
    return out


def supports_tp(config: BioGptConfig, tp: int) -> bool:
    """Whether the TP path divides this model cleanly: heads, d_model and
    d_ff over ``tp``, and the row-parallel weights' scale blocks (d_in/32)
    too."""
    if tp <= 0:
        return False
    d, f, h = config.d_model, config.d_ff, config.n_head
    return (h % tp == 0 and d % tp == 0 and f % tp == 0
            and (d // QK) % tp == 0 and (f // QK) % tp == 0)


def shard_params_tp(params: dict, mesh: Mesh) -> dict:
    """This rank's shard of TP-packed params on its device (the JAX
    ``tp_pspecs`` + ``device_put``): the columns of qkv, fc1 (weights and
    biases) and the lm_head; the d_in rows of o and fc2 (each plane's own
    rows: a chunk-packed level plane, the scale and min planes); every
    other leaf whole."""
    tp, r = mesh.model, mesh.index

    def split(w, axis):
        return tree_map(lambda a: a.narrow(axis, r * (a.shape[axis] // tp),
                                           a.shape[axis] // tp), w)

    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in _COLUMN:
        leaf = params["layers"][name]
        out["layers"][name] = {"w": split(leaf["w"], -1),
                               "b": split(leaf["b"], -1)}
    for name in _ROW:
        leaf = params["layers"][name]
        out["layers"][name] = {"w": split(leaf["w"], -2), "b": leaf["b"]}
    out["lm_head"] = split(params["lm_head"], -1)
    return tree_map(lambda a: a.contiguous().to(mesh.device), out)


def make_tp_forward(mesh: Mesh, seq_parallel: bool = True,
                    fused_decode: bool = False):
    """A drop-in for ``models.biogpt.forward`` on this rank's shard (its
    params from :func:`shard_params_tp`, its cache a feature shard).

    ``seq_parallel``: prefill shapes whose length divides the model axis
    run with Megatron sequence parallelism (residual stream and LayerNorms
    on each rank's N/tp rows, reduce-scatter and all-gather at the joins);
    decode and other lengths sum with an all-reduce. Both give the same
    numbers up to the order of the sums.

    ``fused_decode``: decode-shaped calls (one token, causal, last-token
    logits, a KV window, a bf16 or int8 cache) whose local shapes pass
    ``supports_layers_tp`` run the TP decode step's kernel halves
    (:func:`_fused_decode_body`); the rest run the per-op body."""

    def tp_forward(params, tokens, cache, past, config: BioGptConfig,
                   compute_dtype=torch.float32, causal: bool = True,
                   logits_mode: str = "last", allow_kernels: bool = True,
                   kv_window: Optional[int] = None, last_index=None):
        B, N = tokens.shape
        use_fused = (
            fused_decode and N == 1 and causal and logits_mode == "last"
            and last_index is None and kv_window is not None
            and (isinstance(cache, QuantKVCache)
                 or cache.k.dtype == torch.bfloat16)
            # the local planes (their widths are the shard's own) at the
            # replica's local batch
            and supports_layers_tp(params.get("layers", {}), 1, batch=B))
        if use_fused:
            return _fused_decode_body(params, tokens, cache, past, config,
                                      mesh, compute_dtype=compute_dtype,
                                      kv_window=kv_window)
        seq_shard = (seq_parallel and mesh.model > 1 and N > 1
                     and N % mesh.model == 0)
        return forward(params, tokens, cache, past, config,
                       compute_dtype=compute_dtype, causal=causal,
                       logits_mode=logits_mode, allow_kernels=allow_kernels,
                       kv_window=kv_window, last_index=last_index, mesh=mesh,
                       tp_seq_shard=seq_shard)

    return tp_forward


def _fused_decode_body(params, tokens, cache, past, config: BioGptConfig,
                       mesh: Mesh, *, compute_dtype, kv_window: int):
    """One rank's TP decode step: embedding, the TP step's halves with the
    all-reduces between (``decode_step_fused_tp``), each slot's new rows
    committed into the LOCAL cache shard at its own position (through the
    ``kv_commit`` / ``kv_commit_quant`` kernels where the JAX body takes
    its commit kernels: B > 1 and lane-aligned local rows; else one
    clamped write per slot), then the final LN, the local lm_head columns
    and their all_gather -> (logits (B, n_vocab) f32, cache)."""
    B = tokens.shape[0]
    x0 = _decode_x0(params, tokens, past, config)
    past_vec = _per_row(past, B, tokens.device).to(torch.int32)
    _, _, S, Dl = cache.k.shape
    kw = dict(n_head=config.n_head, tp_size=mesh.model, mesh=mesh,
              window=kv_window, ln_eps=config.ln_eps)
    if isinstance(cache, QuantKVCache):
        x, kq, vq, ksc, vsc = decode_step_fused_tp(
            x0, params["layers"], cache.k, cache.v, past_vec,
            k_scales=cache.ks, v_scales=cache.vs, **kw)
        if B > 1 and Dl % 128 == 0 and S % 128 == 0:
            kv_commit_quant(cache.k, cache.v, cache.ks, cache.vs,
                            kq.transpose(0, 1), vq.transpose(0, 1),
                            ksc.transpose(0, 1)[..., None],
                            vsc.transpose(0, 1)[..., None], past_vec)
        else:
            write_block(cache.k, kq[:, :, None], past_vec)
            write_block(cache.v, vq[:, :, None], past_vec)
            write_block(cache.ks[:, :, 0, :, None], ksc[:, :, None, None],
                        past_vec)
            write_block(cache.vs[:, :, 0, :, None], vsc[:, :, None, None],
                        past_vec)
    else:
        x, k_rows, v_rows = decode_step_fused_tp(
            x0, params["layers"], cache.k, cache.v, past_vec, **kw)
        if B > 1 and Dl % 128 == 0:
            kv_commit(cache.k, cache.v, k_rows.transpose(0, 1),
                      v_rows.transpose(0, 1), past_vec)
        else:
            write_block(cache.k, k_rows[:, :, None], past_vec)
            write_block(cache.v, v_rows[:, :, None], past_vec)
    x = _layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                    config.ln_eps)
    logits = matmul(x, params["lm_head"], compute_dtype=compute_dtype,
                    allow_kernels=True)
    logits = mesh.all_gather_last(logits)
    return logits[..., :config.n_vocab], cache
