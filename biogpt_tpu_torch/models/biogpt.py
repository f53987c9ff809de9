"""The BioGPT decoder as functions over a params dict
(``biogpt_tpu/models/biogpt.py``, single-stream branches).

OPT-style decoder: token embedding scaled by sqrt(d_model), learned
positions with a +2 offset, pre-LN blocks (eps 1e-5), the query pre-scaled
by 1/sqrt(d_kv), GELU FFN, final LN and an untied lm_head. Prefill applies
a causal mask; ``causal=False`` keeps the reference's unmasked mode (every
new token sees all real tokens written so far).

``forward`` serves prefill and per-op decode; ``forward_fused_decode`` and
``forward_fused_decode_greedy`` run the whole-model decode step
(``ops.decode_kernels.decode_step_fused``) and, for greedy decode, the
fused final-LN + lm_head + argmax tail (``ops.qmatmul_kernels.lm_head_argmax``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import BioGptConfig
from ..modelio.checkpoint import layer_slice
from ..ops import embedding_lookup, matmul
from ..ops.decode_kernels import decode_step_fused
from ..ops.qmatmul_kernels import lm_head_argmax
from ..runtime.cache import KVCache, commit_rows, update_layer


def _layer_norm(x, w, b, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y * w.to(torch.float32) + b.to(torch.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="none")


def _project(x, wb, compute_dtype, allow_kernels: bool) -> torch.Tensor:
    y = matmul(x, wb["w"], compute_dtype=compute_dtype,
               allow_kernels=allow_kernels)
    return y + wb["b"].to(torch.float32)


def _attention(layer: dict, x, cache: KVCache, layer_ix: int, past: int,
               config: BioGptConfig, compute_dtype, causal: bool,
               n_valid: int, allow_kernels: bool,
               kv_window: Optional[int]):
    B, N, D = x.shape
    H, Dk = config.n_head, config.d_kv
    scaling = 1.0 / math.sqrt(Dk)
    if "qkv" in layer:   # engine-fused projection
        qkv = _project(x, layer["qkv"], compute_dtype, allow_kernels)
        q, k, v = torch.split(qkv, D, dim=-1)
        q = q * scaling
    else:
        q = _project(x, layer["q"], compute_dtype, allow_kernels) * scaling
        k = _project(x, layer["k"], compute_dtype, allow_kernels)
        v = _project(x, layer["v"], compute_dtype, allow_kernels)

    update_layer(cache, layer_ix, k, v, past)
    S = cache.max_len if kv_window is None else min(kv_window, cache.max_len)
    k_all = cache.k[layer_ix][:, :S].reshape(B, S, H, Dk).to(torch.float32)
    v_all = cache.v[layer_ix][:, :S].reshape(B, S, H, Dk).to(torch.float32)
    if compute_dtype == torch.float32:
        q_dot = q
    else:
        # the reference feeds the cache dtype into the dots (f32 accumulation)
        q_dot = q.to(cache.k.dtype).to(torch.float32)
    scores = torch.einsum("bnhd,bshd->bhns", q_dot.reshape(B, N, H, Dk), k_all)
    pos_s = torch.arange(S, device=x.device)[None, None, None, :]
    if causal:
        pos_n = past + torch.arange(N, device=x.device)[None, None, :, None]
        valid = pos_s <= pos_n
    else:
        valid = pos_s < past + n_valid
    scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    attn = torch.softmax(scores, dim=-1)
    if compute_dtype != torch.float32:
        attn = attn.to(cache.v.dtype).to(torch.float32)
    ctx = torch.einsum("bhns,bshd->bnhd", attn, v_all).reshape(B, N, D)
    return _project(ctx, layer["o"], compute_dtype, allow_kernels)


def forward(params: dict, tokens: torch.Tensor, cache: KVCache, past: int,
            config: BioGptConfig, compute_dtype=torch.float32,
            causal: bool = True, logits_mode: str = "last",
            allow_kernels: bool = True, kv_window: Optional[int] = None,
            last_index: Optional[int] = None):
    """One forward step (prefill or per-op decode) -> (logits, cache):
    (B, n_vocab) for "last" or (B, N, n_vocab) for "all". The cache rows
    [past, past + N) are written in place."""
    B, N = tokens.shape
    dev = tokens.device
    emb = embedding_lookup(tokens, params["embed_tokens"]) * math.sqrt(
        config.d_model)
    positions = (past + torch.arange(N, device=dev) + config.pos_offset)
    pos_emb = embedding_lookup(positions.expand(B, N), params["embed_positions"])
    x = emb + pos_emb
    n_valid = N if last_index is None else last_index + 1
    for i in range(config.n_layer):
        layer = layer_slice(params["layers"], i)
        h = _layer_norm(x, layer["ln0"]["w"], layer["ln0"]["b"], config.ln_eps)
        x = x + _attention(layer, h, cache, i, past, config, compute_dtype,
                           causal, n_valid, allow_kernels, kv_window)
        h = _layer_norm(x, layer["ln1"]["w"], layer["ln1"]["b"], config.ln_eps)
        h = _gelu(_project(h, layer["fc1"], compute_dtype, allow_kernels))
        x = x + _project(h, layer["fc2"], compute_dtype, allow_kernels)
    x = _layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                    config.ln_eps)
    if logits_mode == "last":
        idx = N - 1 if last_index is None else last_index
        x = x[:, idx:idx + 1]
    logits = matmul(x, params["lm_head"], compute_dtype=compute_dtype,
                    allow_kernels=allow_kernels)
    logits = logits[..., :config.n_vocab]   # the lm_head may be lane-padded
    if logits_mode == "last":
        logits = logits[:, 0, :]
    return logits, cache


def _fused_decode_hidden(params: dict, tokens: torch.Tensor, cache: KVCache,
                         past: int, config: BioGptConfig, kv_window: int = 128):
    """Whole-model decode step + the KV-row commit -> (hidden (1, D) f32
    before the final LN, cache)."""
    B, N = tokens.shape
    if B != 1 or N != 1:
        raise NotImplementedError("the fused decode step runs B=1, N=1 in "
                                  "this slice of the port")
    emb = embedding_lookup(tokens, params["embed_tokens"]) * math.sqrt(
        config.d_model)
    pos = torch.full((1, 1), past + config.pos_offset, device=tokens.device)
    x0 = (emb + embedding_lookup(pos, params["embed_positions"])).reshape(
        1, config.d_model)
    x, k_rows, v_rows = decode_step_fused(
        x0, params["layers"], cache.k, cache.v, past, n_head=config.n_head,
        window=kv_window, ln_eps=config.ln_eps)
    commit_rows(cache, k_rows, v_rows, past)
    return x, cache


def forward_fused_decode(params: dict, tokens: torch.Tensor, cache: KVCache,
                         past: int, config: BioGptConfig,
                         compute_dtype=torch.bfloat16, kv_window: int = 128):
    """Single-token decode through the fused step, then final LN and the
    lm_head (``qmatmul`` at m=1) -> (logits (1, n_vocab) f32, cache)."""
    x, cache = _fused_decode_hidden(params, tokens, cache, past, config,
                                    kv_window)
    x = _layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"],
                    config.ln_eps)
    logits = matmul(x, params["lm_head"], compute_dtype=compute_dtype,
                    allow_kernels=True)
    return logits[..., :config.n_vocab], cache


def forward_fused_decode_greedy(params: dict, tokens: torch.Tensor,
                                cache: KVCache, past: int,
                                config: BioGptConfig, kv_window: int = 128):
    """Greedy decode with the final LN + lm_head + argmax tail fused ->
    (ids (1,) int32, max logits (1,) f32 -- the health lane's probe, cache).
    Needs a packed, lane-padded quantized lm_head (the engine prepares it)."""
    x, cache = _fused_decode_hidden(params, tokens, cache, past, config,
                                    kv_window)
    ids, mv = lm_head_argmax(x, params["final_ln"]["w"],
                             params["final_ln"]["b"], params["lm_head"],
                             n_valid=config.n_vocab, ln_eps=config.ln_eps)
    return ids, mv, cache
