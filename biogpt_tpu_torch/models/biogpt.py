"""The BioGPT decoder as functions over a params dict
(``biogpt_tpu/models/biogpt.py``).

OPT-style decoder: token embedding scaled by sqrt(d_model), learned
positions with a +2 offset, pre-LN blocks (eps 1e-5), the query pre-scaled
by 1/sqrt(d_kv), GELU FFN, final LN and an untied lm_head. Prefill applies
a causal mask; ``causal=False`` keeps the reference's unmasked mode (every
new token sees all real tokens written so far).

``forward`` serves prefill, the serving refill (per-row ``last_index``) and
per-op decode (a host-int ``past``, or per-slot positions (B,) on the
device); ``logits_for_tokens`` scores whole sequences through it. ``forward_prefill_fused`` runs a serving refill group through the
whole-prompt kernel (``ops.prefill_kernels.prefill_fused``).
``forward_fused_decode``, ``forward_fused_decode_greedy`` and
``forward_fused_decode_sampled`` run the whole-model decode step
(``ops.decode_kernels.decode_step_fused``, B <= 32; ``per_slot_kv`` its
paged variant) and then: the final LN and lm_head; the fused LN + lm_head
+ argmax tail; or the fused LN + lm_head + group-maxima tail of the
per-request sampler. Per-slot positions commit the new KV rows through
``kv_commit`` or inside the fused tails; an int8 cache
(``runtime.cache.QuantKVCache``) quantizes and commits them in one launch
(``kv_commit_quant_rows``; ``runtime.cache.commit_rows`` at the host's B=1
position), and its tails run without the commit fusion, as in the JAX
package.
``forward_fused_decode_staged`` runs the staged step (chunk-local KV
staging) and returns the rows for the caller's staging.

``forward(mesh=...)`` is one rank's shard of the tensor-parallel per-op
forward (``parallel/tp.py``): local heads, sums over the model axis at the
o and fc2 joins, the column-parallel lm_head's logits gathered, and, with
``tp_seq_shard``, sequence-parallel prefill. With ``layout`` it is the
sharded route of unpacked weights (``parallel/sharding.py``): q, k and v
unfused, each weight a shard or whole, and attention on local heads or on
all of them with a whole-feature cache.

Position ids past the embedding table clamp to its last row, as the JAX
gather clamps: a serving slot can run a chunk past its cache's end before
it is truncated (``runtime/cache.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import BioGptConfig
from ..modelio.checkpoint import layer_slice
from ..ops import embedding_lookup, matmul
from ..ops.decode_kernels import (decode_step_fused, kv_commit,
                                  kv_commit_quant_rows)
from ..ops.prefill_kernels import prefill_fused
from ..ops.qmatmul_kernels import (lm_head_argmax, lm_head_argmax_commit,
                                   lm_head_logits_gmax_commit)
from ..runtime.cache import (KVCache, QuantKVCache, commit_rows,
                             dequant_layer, init_cache, quantize_rows,
                             update_layer)


def _layer_norm(x, w, b, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * w.to(torch.float32) + b.to(torch.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


def _project(x, wb, compute_dtype, allow_kernels: bool, mesh=None,
             seq_scatter: bool = False) -> torch.Tensor:
    """x @ w + b. ``mesh``: a row-parallel projection under tensor
    parallelism, whose local product is this shard's partial sum: summed
    over the model axis (``seq_scatter``: reduce-scattered over the
    sequence axis) before the bias is added."""
    y = matmul(x, wb["w"], compute_dtype=compute_dtype,
               allow_kernels=allow_kernels)
    if mesh is not None:
        y = mesh.reduce_scatter_seq(y) if seq_scatter else mesh.sum(y)
    return y + wb["b"].to(torch.float32)


def _is_shard(mesh, layout, name: str) -> bool:
    """Whether weight ``name`` is this rank's shard on ``mesh`` rather than
    whole: on the packed tensor-parallel route (no ``layout``) every one
    is; on the sharded route of unpacked weights, those of ``layout``
    (``parallel/sharding.py``)."""
    return mesh is not None and (layout is None or name in layout.sharded)


def _column(x, wb, name: str, compute_dtype, allow_kernels: bool, mesh,
            layout, whole: bool) -> torch.Tensor:
    """A column-parallel projection: this rank's columns where the weight
    is a shard, all-gathered over the model axis where ``whole``."""
    y = _project(x, wb, compute_dtype, allow_kernels)
    if whole and _is_shard(mesh, layout, name):
        y = mesh.all_gather_last(y)
    return y


def _row(x, wb, name: str, x_cols: bool, compute_dtype, allow_kernels: bool,
         mesh, layout, seq_scatter: bool = False) -> torch.Tensor:
    """A row-parallel projection of ``x``, which holds this rank's columns
    of the input where ``x_cols`` (else all of them). A sharded weight
    takes this rank's columns (sliced from a whole ``x``) and sums its
    partial product over the model axis; a whole one takes ``x`` whole
    (gathered from this rank's columns)."""
    if not _is_shard(mesh, layout, name):
        if x_cols:
            x = mesh.all_gather_last(x)
        return _project(x, wb, compute_dtype, allow_kernels)
    if not x_cols:
        n = x.shape[-1] // mesh.model
        x = x[..., mesh.index * n:(mesh.index + 1) * n]
    return _project(x, wb, compute_dtype, allow_kernels, mesh, seq_scatter)


def _per_row(v, B: int, device) -> torch.Tensor:
    """A host int or a (B,) tensor as a (B,) int64 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64).reshape(B)
    return torch.full((B,), int(v), dtype=torch.int64, device=device)


def _positions(past, B: int, N: int, config: BioGptConfig, table, device):
    """(B, N) position ids of rows starting at ``past`` (host int or (B,)
    tensor), clamped to the embedding table."""
    start = _per_row(past, B, device)[:, None]
    pos = start + torch.arange(N, device=device)[None, :] + config.pos_offset
    return torch.clamp(pos, max=table.shape[0] - 1)


def _attention(layer: dict, x, cache: KVCache, layer_ix: int, past,
               config: BioGptConfig, compute_dtype, causal: bool,
               n_valid, allow_kernels: bool,
               kv_window: Optional[int], mesh=None,
               tp_seq_shard: bool = False, layout=None):
    B, N, _ = x.shape
    # under tensor parallelism each shard owns n_head / tp contiguous heads
    # (the sharded route's layout may keep every head on every rank): its
    # q/k/v columns are exactly theirs, and attention is shard-local
    local = mesh is not None and (layout is None or layout.heads)
    tp = mesh.model if local else 1
    H, Dk = config.n_head // tp, config.d_kv
    D = H * Dk
    scaling = 1.0 / math.sqrt(Dk)
    if "qkv" in layer:   # engine-fused projection (a shard's q_s|k_s|v_s)
        qkv = _project(x, layer["qkv"], compute_dtype, allow_kernels)
        q, k, v = torch.split(qkv, D, dim=-1)
        q = q * scaling
    else:
        q, k, v = (_column(x, layer[n], n, compute_dtype, allow_kernels,
                           mesh, layout, whole=not local)
                   for n in ("q", "k", "v"))
        q = q * scaling

    update_layer(cache, layer_ix, k, v, past,
                 group=mesh.group if local else None)
    S = cache.max_len if kv_window is None else min(kv_window, cache.max_len)
    if isinstance(cache, QuantKVCache):
        # int8 levels x row scales, dequantized into the compute dtype
        dq = torch.float32 if compute_dtype == torch.float32 else torch.bfloat16
        k_flat, v_flat = dequant_layer(cache, layer_ix, S, dq)
        kv_dtype = dq
    else:
        k_flat, v_flat = cache.k[layer_ix][:, :S], cache.v[layer_ix][:, :S]
        kv_dtype = cache.k.dtype
    k_all = k_flat.reshape(B, S, H, Dk).to(torch.float32)
    v_all = v_flat.reshape(B, S, H, Dk).to(torch.float32)
    if compute_dtype == torch.float32:
        q_dot = q
    else:
        # the reference feeds the cache dtype into the dots (f32 accumulation)
        q_dot = q.to(kv_dtype).to(torch.float32)
    scores = torch.einsum("bnhd,bshd->bhns", q_dot.reshape(B, N, H, Dk), k_all)
    pos_s = torch.arange(S, device=x.device)[None, None, None, :]
    past_b = _per_row(past, B, x.device)[:, None, None, None]
    if causal:
        pos_n = past_b + torch.arange(N, device=x.device)[None, None, :, None]
        valid = pos_s <= pos_n
    else:
        valid = pos_s < past_b + _per_row(n_valid, B, x.device)[
            :, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    attn = torch.softmax(scores, dim=-1)
    if compute_dtype != torch.float32:
        # the dequantized value dtype, not int8 (which would zero p < 1)
        attn = attn.to(kv_dtype).to(torch.float32)
    ctx = torch.einsum("bhns,bshd->bnhd", attn, v_all).reshape(B, N, D)
    return _row(ctx, layer["o"], "o", local, compute_dtype, allow_kernels,
                mesh, layout, tp_seq_shard)


def forward(params: dict, tokens: torch.Tensor, cache: KVCache, past,
            config: BioGptConfig, compute_dtype=torch.float32,
            causal: bool = True, logits_mode: str = "last",
            allow_kernels: bool = True, kv_window: Optional[int] = None,
            last_index=None, mesh=None, tp_seq_shard: bool = False,
            layout=None):
    """One forward step (prefill or per-op decode) -> (logits, cache):
    (B, n_vocab) for "last" or (B, N, n_vocab) for "all". The cache rows
    [past, past + N) are written in place. ``past``: a host int, or (B,)
    per-slot positions. ``last_index``: the position of the real last
    token (padded prefill), a host int or (B,) per row.

    ``mesh`` (``parallel.mesh.Mesh``): this rank's shard of a tensor-
    parallel forward (``parallel/tp.py``): params and cache are its local
    shards, q/k/v, fc1 and the lm_head are column-parallel and run local, o
    and fc2 are row-parallel and sum over the model axis at their joins,
    and the logits are gathered over it. ``tp_seq_shard`` (N a multiple of
    the axis, N > 1): Megatron sequence parallelism -- the residual stream
    and LayerNorms run on this rank's N / tp rows, activations all-gather
    over the sequence before the column-parallel products, and the
    row-parallel joins reduce-scatter back to local rows.

    ``layout`` (``parallel.sharding.Layout``) with ``mesh``: the sharded
    route of unpacked weights, where only the weights of the layout are
    this rank's shards and the rest are whole; the joins follow each
    weight's kind (``parallel/sharding.py``)."""
    B, N = tokens.shape
    dev = tokens.device
    emb = embedding_lookup(tokens, params["embed_tokens"]) * math.sqrt(
        config.d_model)
    pos_emb = embedding_lookup(
        _positions(past, B, N, config, params["embed_positions"], dev),
        params["embed_positions"])
    x = emb + pos_emb
    if tp_seq_shard:
        nloc = N // mesh.model
        x = x[:, mesh.index * nloc:(mesh.index + 1) * nloc]

    def gather_seq(h):   # local rows -> the whole sequence
        return mesh.all_gather_seq(h) if tp_seq_shard else h

    n_valid = N if last_index is None else last_index + 1
    for i in range(config.n_layer):
        layer = layer_slice(params["layers"], i)
        h = _layer_norm(x, layer["ln0"]["w"], layer["ln0"]["b"], config.ln_eps)
        x = x + _attention(layer, gather_seq(h), cache, i, past, config,
                           compute_dtype, causal, n_valid, allow_kernels,
                           kv_window, mesh, tp_seq_shard, layout)
        h = _layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], config.ln_eps)
        h = _gelu(_column(gather_seq(h), layer["fc1"], "fc1", compute_dtype,
                          allow_kernels, mesh, layout, whole=False))
        x = x + _row(h, layer["fc2"], "fc2", _is_shard(mesh, layout, "fc1"),
                     compute_dtype, allow_kernels, mesh, layout, tp_seq_shard)
    # the final LN is row-independent: local rows first, then gathered
    x = gather_seq(_layer_norm(x, params["final_ln"]["w"],
                               params["final_ln"]["b"], config.ln_eps))
    if logits_mode == "last":
        idx = _per_row(N - 1 if last_index is None else last_index, B, dev)
        x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[-1]))
    logits = matmul(x, params["lm_head"], compute_dtype=compute_dtype,
                    allow_kernels=allow_kernels)
    if _is_shard(mesh, layout, "lm_head"):   # the column-parallel vocab
        logits = mesh.all_gather_last(logits)
    logits = logits[..., :config.n_vocab]   # the lm_head may be lane-padded
    if logits_mode == "last":
        logits = logits[:, 0, :]
    return logits, cache


def logits_for_tokens(params: dict, tokens: torch.Tensor,
                      config: BioGptConfig, compute_dtype=torch.float32,
                      cache_dtype=torch.float16) -> torch.Tensor:
    """Full-sequence logits (B, N, n_vocab) of ``tokens`` (B, N) in one
    causal pass over a fresh cache on the tokens' device."""
    B, N = tokens.shape
    cache = init_cache(config, batch=B, max_len=N, dtype=cache_dtype,
                       device=tokens.device)
    logits, _ = forward(params, tokens, cache, 0, config,
                        compute_dtype=compute_dtype, logits_mode="all")
    return logits


def forward_prefill_fused(params: dict, ids: torch.Tensor,
                          config: BioGptConfig, last_index,
                          compute_dtype=torch.bfloat16,
                          cache_dtype=torch.bfloat16):
    """Fresh-cache forward of a refill group (R, T) of padded prompts,
    ``past`` 0, through ``prefill_fused`` -> (logits (R, n_vocab), small
    cache shaped as ``init_cache(batch=R, max_len=T, dtype=cache_dtype)``).
    The final LN and the lm_head run on each prompt's row ``last_index``
    (R,). An int8 ``cache_dtype`` quantizes the kernel's bf16 rows with
    ``quantize_rows``, as the JAX package does."""
    R, T = ids.shape
    D = config.d_model
    emb = embedding_lookup(ids, params["embed_tokens"]) * math.sqrt(D)
    pos = _positions(0, R, T, config, params["embed_positions"], ids.device)
    x0 = (emb + embedding_lookup(pos, params["embed_positions"])).reshape(
        R * T, D)
    quant = cache_dtype == torch.int8
    x, k_rows, v_rows = prefill_fused(
        x0, params["layers"], rows=R, padded=T, n_head=config.n_head,
        ln_eps=config.ln_eps,
        cache_dtype=torch.bfloat16 if quant else cache_dtype)
    L = k_rows.shape[0]
    sel = (torch.arange(R, device=ids.device) * T
           + _per_row(last_index, R, ids.device))
    xl = _layer_norm(x[sel], params["final_ln"]["w"], params["final_ln"]["b"],
                     config.ln_eps)
    logits = matmul(xl[:, None, :], params["lm_head"],
                    compute_dtype=compute_dtype, allow_kernels=True)
    logits = logits[:, 0, :config.n_vocab]
    if quant:
        kq, ksc = quantize_rows(k_rows)                 # (L, R*T) scales
        vq, vsc = quantize_rows(v_rows)
        small = QuantKVCache(
            k=kq.reshape(L, R, T, D), v=vq.reshape(L, R, T, D),
            ks=ksc.reshape(L, R, 1, T), vs=vsc.reshape(L, R, 1, T))
    else:
        small = KVCache(k=k_rows.reshape(L, R, T, D),
                        v=v_rows.reshape(L, R, T, D))
    return logits, small


def _decode_x0(params: dict, tokens: torch.Tensor, past,
               config: BioGptConfig) -> torch.Tensor:
    """Token plus position embeddings (B, D) of one decode step."""
    B, N = tokens.shape
    if N != 1 or B > 32:
        raise ValueError(f"the fused decode step takes one token for B <= 32 "
                         f"slots, got ({B}, {N})")
    table = params["embed_positions"]
    emb = embedding_lookup(tokens, params["embed_tokens"]) * math.sqrt(
        config.d_model)
    pos = _positions(past, B, 1, config, table, tokens.device)
    return (emb + embedding_lookup(pos, table)).reshape(B, config.d_model)


def _final_logits(params: dict, x, config: BioGptConfig, compute_dtype):
    """Final LN and the lm_head (``qmatmul`` / ``qmatmul_wide`` at m = B)
    -> (B, n_vocab) f32."""
    x = _layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                    config.ln_eps)
    logits = matmul(x, params["lm_head"], compute_dtype=compute_dtype,
                    allow_kernels=True)
    return logits[..., :config.n_vocab]


def _fused_decode_hidden(params: dict, tokens: torch.Tensor, cache: KVCache,
                         past, config: BioGptConfig, kv_window: int = 128,
                         commit: bool = True, per_slot_kv: bool = False):
    """Whole-model decode step (B <= 32) + the KV-row commit -> (hidden
    (B, D) f32 before the final LN, cache). ``past``: the host's int at
    B=1, (B,) per-slot positions on the device at B >= 2 and for the paged
    step (``per_slot_kv``) at every B. ``commit=False`` skips the commit
    and returns (x, k_rows, v_rows) (L, B, D) instead, for the tails that
    fold the commit in. An int8 cache's rows leave the step in f32 and
    quantize in their commit (``kv_commit_quant_rows``, one launch)."""
    B = tokens.shape[0]
    x0 = _decode_x0(params, tokens, past, config)
    quant = isinstance(cache, QuantKVCache)
    x, k_rows, v_rows = decode_step_fused(
        x0, params["layers"], cache.k, cache.v, past, n_head=config.n_head,
        window=kv_window, ln_eps=config.ln_eps,
        k_scales=cache.ks if quant else None,
        v_scales=cache.vs if quant else None, per_slot_kv=per_slot_kv)
    if not commit:
        return x, k_rows, v_rows
    if B == 1 and not isinstance(past, torch.Tensor):
        commit_rows(cache, k_rows, v_rows, past)
    elif quant:
        kv_commit_quant_rows(cache.k, cache.v, cache.ks, cache.vs, k_rows,
                             v_rows, past)
    else:
        kv_commit(cache.k, cache.v, k_rows.transpose(0, 1),
                  v_rows.transpose(0, 1), past)
    return x, cache


def forward_fused_decode(params: dict, tokens: torch.Tensor, cache: KVCache,
                         past, config: BioGptConfig,
                         compute_dtype=torch.bfloat16, kv_window: int = 128,
                         per_slot_kv: bool = False):
    """Decode one token per slot through the fused step, then final LN and
    the lm_head (``qmatmul`` / ``qmatmul_wide`` at m = B) -> (logits
    (B, n_vocab) f32, cache)."""
    x, cache = _fused_decode_hidden(params, tokens, cache, past, config,
                                    kv_window, per_slot_kv=per_slot_kv)
    return _final_logits(params, x, config, compute_dtype), cache


def forward_fused_decode_greedy(params: dict, tokens: torch.Tensor,
                                cache: KVCache, past, config: BioGptConfig,
                                kv_window: int = 128,
                                per_slot_kv: bool = False):
    """Greedy decode with the final LN + lm_head + argmax tail fused ->
    (ids (B,) int32, max logits (B,) f32 -- the health lane's probe, cache).
    At B > 1 with a bf16 cache the tail also commits the KV rows; an int8
    cache commits before the tail. Needs a packed, lane-padded quantized
    lm_head (the engine prepares it)."""
    B = tokens.shape[0]
    fw, fb = params["final_ln"]["w"], params["final_ln"]["b"]
    if B > 1 and not isinstance(cache, QuantKVCache):
        x, k_rows, v_rows = _fused_decode_hidden(
            params, tokens, cache, past, config, kv_window, commit=False,
            per_slot_kv=per_slot_kv)
        ids, mv, _, _ = lm_head_argmax_commit(
            x, fw, fb, params["lm_head"], config.n_vocab, cache.k, cache.v,
            k_rows.transpose(0, 1), v_rows.transpose(0, 1), past,
            ln_eps=config.ln_eps)
        return ids, mv, cache
    x, cache = _fused_decode_hidden(params, tokens, cache, past, config,
                                    kv_window, per_slot_kv=per_slot_kv)
    ids, mv = lm_head_argmax(x, fw, fb, params["lm_head"],
                             n_valid=config.n_vocab, ln_eps=config.ln_eps)
    return ids, mv, cache


def forward_fused_decode_sampled(params: dict, tokens: torch.Tensor,
                                 cache: KVCache, past, config: BioGptConfig,
                                 kv_window: int = 128):
    """Sampled batched decode (2 <= B <= 32) with the final LN + lm_head +
    KV commit tail fused -> (logits (B, d_out) f32 at the lm_head's padded
    width, pad columns -1e30; their 128-column group maxima (B, d_out/128),
    stage 1 of ``sampling.topk_gather``; cache). bf16 cache only."""
    x, k_rows, v_rows = _fused_decode_hidden(
        params, tokens, cache, past, config, kv_window, commit=False)
    logits, gmax, _, _ = lm_head_logits_gmax_commit(
        x, params["final_ln"]["w"], params["final_ln"]["b"],
        params["lm_head"], config.n_vocab, cache.k, cache.v,
        k_rows.transpose(0, 1), v_rows.transpose(0, 1), past,
        ln_eps=config.ln_eps)
    return logits, gmax, cache


def forward_fused_decode_staged(params: dict, tokens: torch.Tensor,
                                cache: KVCache, k_stage, v_stage, past,
                                step_i: int, config: BioGptConfig,
                                compute_dtype=torch.bfloat16,
                                kv_window: int = 128):
    """Decode one token per slot (2 <= B <= 32, bf16 cache) with chunk-local
    KV staging -> (logits (B, n_vocab) f32, k_rows, v_rows (L, B, D)).
    ``past`` (B,) holds the current positions; attention reads the cache
    rows below the chunk-start lengths ``past - step_i`` and the staged rows
    ``k_stage``/``v_stage`` (L, B, C, D) below the host int ``step_i``. The
    cache is not written: the caller writes the rows into the staging at
    ``step_i`` and commits the staging once per chunk."""
    x0 = _decode_x0(params, tokens, past, config)
    x, k_rows, v_rows = decode_step_fused(
        x0, params["layers"], cache.k, cache.v, past, n_head=config.n_head,
        window=kv_window, ln_eps=config.ln_eps, k_stage=k_stage,
        v_stage=v_stage, step_i=step_i)
    return _final_logits(params, x, config, compute_dtype), k_rows, v_rows
