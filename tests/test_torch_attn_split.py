"""The batched steps' attention kernel (``csrc/attn_batched.cuh``) splits
each slot's rows (its live cache rows, then the staged step's staged
rows), all heads, over a cluster of CTAs; this file holds
that split order on the CPU. ``split_attention`` transcribes the kernel's
work division in plain torch, head by head: contiguous per-CTA row
ranges, each CTA's maxima over the KV blocks its rows touch, the prefix
maxima every CTA takes from the exchanged table, p rounded to bf16
against its block's prefix max, each CTA's (l, acc) rescaled to the last
block's max and folded in rank order, then the current token. It is held against ``_softmax_block``'s
sequential fold (bit-equal bf16 p; the context within f32 order) and, in
the plain steps in its place, against the JAX kernel in interpret mode;
and the wrapper's plan (``attn_plan``) is tested as the kernel takes it.
The kernel itself is held against the plain version on the card by
``chip_smoke.py``."""

import math
import pathlib
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops import pallas_decode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime.engine import _pack_matmul_weights

from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import decode_kernels as dk


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def split_attention(qkv, k_cache, v_cache, past, *, n_head, window, kvb,
                    k_scales=None, v_scales=None, k_stage=None, v_stage=None,
                    step_i=0, rows=None, p_out=None):
    """``attn_batched_kernel``'s arithmetic with the signature of
    ``batched_attention_plain`` -> (ctx, k_row, v_row). ``rows``: the rows
    a CTA takes, by default ``attn_plan``'s; ``p_out``, where
    given, gets {(slot, head, row): bf16 p} with the staged rows at ``("st",
    r)``."""
    B, S, D = k_cache.shape
    H = n_head
    Dk = D // H
    W = min(window, S)
    quant = k_scales is not None
    staged_n = int(step_i) if k_stage is not None else 0
    per = rows or dk.attn_plan(W, kvb, staged_n)[1]
    q = _bf16(qkv[:, :D] * (1.0 / math.sqrt(Dk)))
    k, v = qkv[:, D:2 * D], qkv[:, 2 * D:]
    row_dtype = torch.float32 if quant else k_cache.dtype
    if quant:
        k, v = dk.fake_quant_rows(k), dk.fake_quant_rows(v)
    past = torch.as_tensor(past).to(torch.int64).reshape(B)
    scores, st_scores = _scores(q.reshape(B, H, Dk), k_cache, k_scales,
                                k_stage, W, kvb)
    ctx = torch.zeros(B, D)
    for b in range(B):
        # the slot's rows: its live cache rows, then the staged rows
        live = max(0, min(int(past[b]) - int(step_i), W))
        tot = live + staged_n
        cs = max(1, -(-tot // per))   # the active CTAs
        nb = -(-live // kvb)
        nbt = nb + (1 if staged_n > 0 else 0)
        for h in range(H):
            cols = slice(h * Dk, (h + 1) * Dk)
            qh = q[b, cols]
            vc = v_cache[b, :, cols].to(torch.float32)
            # each active CTA: its rows' scores and its maxima over the
            # blocks its rows touch (-1e30 elsewhere): its row of the table
            table = torch.full((cs, nbt), -1e30)
            ctas = []
            for c in range(cs):
                r0 = min(c * per, tot)
                nr = min(per, tot - r0)
                n = max(0, min(nr, live - r0))
                rows = torch.arange(r0, r0 + n)
                s = scores[b, h, rows]
                blocks = rows // kvb
                for j in blocks.unique().tolist():
                    table[c, j] = s[blocks == j].max()
                st = None
                if nr > n:
                    st = torch.arange(max(0, r0 - live),
                                      max(0, r0 - live) + nr - n)
                    table[c, nb] = st_scores[b, h, st].max()
                ctas.append((rows, s, blocks, st))
            # the prefix maxima from -1e30, the last one, the factors
            mj = torch.empty(nbt)
            m = torch.tensor(-1e30)
            for j in range(nbt):
                m = torch.maximum(m, table[:, j].max())
                mj[j] = m
            mlast = mj[-1] if nbt else torch.tensor(-1e30)
            fj = torch.exp(mj - mlast)
            acc, l = torch.zeros(Dk), torch.tensor(0.0)
            for c, (rows, s, blocks, st) in enumerate(ctas):
                p = torch.exp(s - mj[blocks])
                w = _bf16(p * v_scales[b, 0, rows] if quant else p)
                f = fj[blocks]
                l_c = (p * f).sum()
                acc_c = ((w * f)[:, None] * vc[rows]).sum(0)
                if p_out is not None:
                    p_out.update({(b, h, int(r)): float(x)
                                  for r, x in zip(rows, w)})
                if st is not None:
                    p = torch.exp(st_scores[b, h, st] - mj[nb])
                    w = _bf16(p)
                    l_c = l_c + (p * fj[nb]).sum()
                    vsb = v_stage[b, st, cols].to(torch.float32)
                    acc_c = acc_c + ((w * fj[nb])[:, None] * vsb).sum(0)
                    if p_out is not None:
                        p_out.update({(b, h, ("st", int(r))): float(x)
                                      for r, x in zip(st, w)})
                acc, l = acc + acc_c, l + l_c   # rank order
            cur = (qh * k[b, cols]).sum()
            m_fin = torch.maximum(mlast, cur)
            alpha2, pc = torch.exp(mlast - m_fin), torch.exp(cur - m_fin)
            ctx[b, cols] = (acc * alpha2 + pc * v[b, cols]) / (l * alpha2 + pc)
    return ctx, qkv[:, D:2 * D].to(row_dtype), qkv[:, 2 * D:].to(row_dtype)


def _scores(qh, k_cache, k_scales, k_stage, W, kvb):
    """q . k of every window row (B, H, W), in the plain attention's
    per-block products (and, int8, times the rows' K scales), and of the
    staged rows (B, H, C): the split takes the same scores as the fold, so
    what the test compares is how p rounds."""
    B, S, D = k_cache.shape
    H, Dk = qh.shape[1], qh.shape[2]
    kc = k_cache.to(torch.float32).reshape(B, S, H, Dk)
    out = []
    for j in range(W // kvb):
        blk = slice(j * kvb, (j + 1) * kvb)
        s = torch.einsum("bhd,bshd->bhs", qh, kc[:, blk])
        out.append(s * k_scales[:, :, blk] if k_scales is not None else s)
    st = None
    if k_stage is not None:
        C = k_stage.shape[1]
        st = torch.einsum("bhd,bshd->bhs", qh,
                          k_stage.to(torch.float32).reshape(B, C, H, Dk))
    return torch.cat(out, -1), st


def sequential_p(qkv, k_cache, v_cache, past, *, n_head, window, kvb,
                 k_scales=None, v_scales=None, k_stage=None, v_stage=None,
                 step_i=0):
    """The bf16 p of the sequential fold: the running max after each block
    from ``_softmax_block`` itself, each live row's p against it ->
    {(slot, head, row): bf16 p}, as :func:`split_attention` records."""
    B, S, D = k_cache.shape
    H = n_head
    Dk = D // H
    W = min(window, S)
    quant = k_scales is not None
    qh = _bf16(qkv[:, :D] * (1.0 / math.sqrt(Dk))).reshape(B, H, Dk)
    live = torch.as_tensor(past).to(torch.int64).reshape(B) - int(step_i)
    kc = k_cache.to(torch.float32).reshape(B, S, H, Dk)
    vc = v_cache.to(torch.float32).reshape(B, S, H, Dk)
    m = torch.full((B, H, 1), -1e30)
    l = torch.zeros(B, H, 1)
    acc = torch.zeros(B, H, Dk)
    out = {}

    def record(scores, valid, m_new, vscale, key):
        p = torch.exp(scores - m_new)
        w = _bf16(p * vscale if vscale is not None else p)
        for b, h, r in valid.nonzero().tolist():
            out[(b, h, key(r))] = float(w[b, h, r])

    for j in range(W // kvb):
        blk = slice(j * kvb, (j + 1) * kvb)
        scores = torch.einsum("bhd,bshd->bhs", qh, kc[:, blk])
        if quant:
            scores = scores * k_scales[:, :, blk]
        idx = torch.arange(kvb) + j * kvb
        valid = (idx[None, None, :] < live[:, None, None]).expand_as(scores)
        m, l, acc = dk._softmax_block(
            m, l, acc, scores, valid, vc[:, blk],
            v_scales[:, :, blk] if quant else None)
        record(scores, valid, m, v_scales[:, :, blk] if quant else None,
               lambda r, j=j: j * kvb + r)
    if k_stage is not None and step_i > 0:
        C = k_stage.shape[1]
        ks_ = k_stage.to(torch.float32).reshape(B, C, H, Dk)
        scores = torch.einsum("bhd,bshd->bhs", qh, ks_)
        valid = (torch.arange(C) < int(step_i))[None, None, :].expand_as(
            scores)
        m, l, acc = dk._softmax_block(
            m, l, acc, scores, valid,
            v_stage.to(torch.float32).reshape(B, C, H, Dk))
        record(scores, valid, m, None, lambda r: ("st", r))
    return out


def _inputs(seed, B, S, D, quant=False, C=0, rising=None):
    """Seeded qkv (B, 3D), one layer's caches (B, S, D) (bf16, or int8 with
    (B, 1, S) scales), staging (B, C, D) bf16; ``rising`` (slot, rows):
    those rows' K four times larger, so the running max rises there."""
    rng = np.random.RandomState(seed)
    kw = dict(qkv=torch.from_numpy(rng.randn(B, 3 * D).astype(np.float32)))
    if quant:
        for name in ("k", "v"):
            kw[f"{name}_cache"] = torch.from_numpy(
                rng.randint(-127, 128, size=(B, S, D)).astype(np.int8))
            kw[f"{name}_scales"] = torch.from_numpy(
                rng.uniform(0.005, 0.015, size=(B, 1, S)).astype(np.float32))
    else:
        for name in ("k", "v"):
            kw[f"{name}_cache"] = torch.from_numpy(
                rng.randn(B, S, D).astype(np.float32)).bfloat16()
    if C:
        for name in ("k", "v"):
            kw[f"{name}_stage"] = torch.from_numpy(
                rng.randn(B, C, D).astype(np.float32)).bfloat16()
    if rising is not None:
        b, rows = rising
        if quant:
            kw["k_scales"][b, :, rows] *= 4
        else:
            kw["k_cache"][b, rows] *= 4
    return kw


def _vmax(kw):
    """The largest |v| the attention weighs (the context's scale)."""
    v = kw["v_cache"].to(torch.float32)
    if "v_scales" in kw:
        v = v * kw["v_scales"].transpose(1, 2)
    D = kw["k_cache"].shape[-1]
    m = max(v.abs().max(), kw["qkv"][:, 2 * D:].abs().max())
    if "v_stage" in kw:
        m = max(m, kw["v_stage"].to(torch.float32).abs().max())
    return float(m)


# (name, B, S, D, H, window, kvb, past, int8, C, step_i, rising)
CASES = [
    # a dead slot, a slot past the window, live rows no tile (32) or block
    # (8) size divides; several blocks
    ("ragged several blocks", 4, 64, 128, 2, 48, 8, [0, 37, 60, 13], False,
     0, 0, None),
    # one block: the window is the block
    ("one block", 3, 32, 128, 2, 32, 32, [31, 1, 0], False, 0, 0, None),
    ("int8 scales", 4, 64, 128, 2, 48, 16, [0, 37, 60, 13], True, 0, 0,
     None),
    ("staged step 0", 4, 64, 128, 2, 48, 8, [0, 37, 60, 13], False, 4, 0,
     None),
    ("staged step 3", 4, 64, 128, 2, 48, 8, [3, 40, 63, 16], False, 4, 3,
     None),
    # more staged rows than a CTA holds: they continue the slot's rows
    # over the next CTAs
    ("staged step 70", 4, 64, 128, 2, 48, 8, [70, 107, 130, 83], False, 80,
     70, None),
    # eight 128-row blocks; slot 1 at 1000 live rows, its max rising in
    # its last blocks; slot 0 past the window
    ("eight 128-row blocks", 2, 1024, 64, 1, 1024, 128, [1100, 1000], False,
     0, 0, (1, slice(700, 1000))),
    ("eight 128-row blocks int8", 2, 1024, 64, 1, 1024, 128, [1100, 1000],
     True, 0, 0, (1, slice(700, 1000))),
]


def _case(case):
    name, B, S, D, H, W, kvb, past, quant, C, step_i, rising = case
    kw = _inputs(len(name), B, S, D, quant, C, rising)
    kw.update(past=torch.tensor(past), n_head=H, window=W, kvb=kvb)
    if C:
        kw["step_i"] = step_i
    return kw


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("rows", [7, 32, 1024])
def test_split_rounds_p_as_the_sequential_fold(case, rows):
    """Every CTA size gives the bf16 p of ``_softmax_block``'s sequential
    fold bit for bit (each row's p against its block's prefix max, the
    running max after that block), and the context row of the plain
    attention within f32 order: the sums run in another order, and
    exp(M_j - M_last) stands for the fold's product of per-block factors;
    each term is exact to a few f32 ulps of the largest |v|, and at most
    W + C + 1 rows add, so 2^-24 (W + C + 2) * 4 of that |v| bounds the
    difference."""
    kw = _case(case)
    got_p, want_p = {}, sequential_p(**kw)
    ctx, kr, vr = split_attention(**kw, rows=rows, p_out=got_p)
    assert got_p == want_p and len(want_p) > 0
    ctx_p, kr_p, vr_p = dk.batched_attention_plain(**kw)
    W, C = kw["window"], kw.get("k_stage", torch.empty(0, 0)).shape[1]
    tol = 2 ** -24 * (W + C + 2) * 4 * _vmax(kw)
    assert (ctx - ctx_p).abs().max() <= tol
    assert torch.equal(kr, kr_p) and torch.equal(vr, vr_p)


def test_rising_max_reaches_the_late_blocks():
    """In the eight-block case the prefix max rises after block 0, so a
    CTA that rounded against its own rows' max, or the slot's final max,
    would round differently: the split's p equals the fold's, and p
    against the final max does not."""
    kw = _case(next(c for c in CASES if c[0] == "eight 128-row blocks"))
    got_p = {}
    split_attention(**kw, rows=128, p_out=got_p)
    q = _bf16(kw["qkv"][:, :64] * 0.125)
    s = kw["k_cache"][1, :1000].to(torch.float32) @ q[1]
    first, last = s[:128].max(), s.max()
    assert last > first
    against_last = _bf16(torch.exp(s - last))
    assert any(float(against_last[r]) != got_p[(1, 0, r)]
               for r in range(1000))


# ------------------------------------------------ the JAX kernel in place

CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=1, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
L, S, D, H = CFG.n_layer, CFG.n_positions, CFG.d_model, CFG.n_head
WINDOW, KVB, C = 16, 8, 4
# tests/test_torch_paged_staged.py's limits: the same bf16-path arithmetic,
# f32 summation order and the GELU's erf, which can flip a bf16 rounding
X_RTOL, ROW_RTOL = 1e-3, 2 ** -7


@pytest.fixture(scope="module")
def layers():
    p = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=5), CFG, qtype=codecs.GGML_TYPE_Q4_0))
    return p["layers"], params_from_numpy(p["layers"], "cpu")


def _rel_close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", ["lockstep", "lockstep int8", "paged int8",
                                  "staged 3"])
def test_split_in_the_step_matches_pallas(layers, mode, monkeypatch):
    """The plain step with the split in place of its attention against
    ``pallas_decode.decode_step_fused(interpret=True)`` in blocks of 8 rows
    (two a window): a dead slot, a slot past the window, live rows 8 does
    not divide; int8 scales; the paged walk; staged rows at step 3 (step
    0 is the lockstep step, held above)."""
    layers_j, layers_t = layers
    monkeypatch.setattr(dk, "batched_attention_plain",
                        lambda *a, **k: split_attention(*a, rows=5, **k))
    quant, staged = mode.endswith("int8"), mode.startswith("staged")
    step_i = int(mode[-1]) if staged else 0
    B = 4
    past = [n + step_i for n in (0, 5, 20, 11)]
    rng = np.random.RandomState(len(mode))
    x0 = rng.randn(B, D).astype(np.float32)
    if quant:
        kc, vc = (rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.01, size=(L, B, 1, S)).astype(
            np.float32) for _ in range(2))
        jax_kw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        kt, vt = torch.from_numpy(kc), torch.from_numpy(vc)
        t_kw = dict(k_scales=torch.from_numpy(ks),
                    v_scales=torch.from_numpy(vs))
        kj, vj = jnp.asarray(kc), jnp.asarray(vc)
    else:
        kc, vc = ((rng.randn(L, B, S, D) * 0.5).astype(np.float32)
                  for _ in range(2))
        kj, vj = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
        kt, vt = torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16()
        jax_kw, t_kw = {}, {}
    pt = torch.tensor(past, dtype=torch.int32)
    common = dict(n_head=H, window=WINDOW)
    if staged:
        stage = (rng.randn(2, L, B, C, D) * 0.5).astype(np.float32)
        want = pallas_decode.decode_step_fused(
            jnp.asarray(x0), layers_j, kj, vj, jnp.asarray(past, jnp.int32),
            interpret=True, kv_block=KVB,
            k_stage=jnp.asarray(stage[0], jnp.bfloat16),
            v_stage=jnp.asarray(stage[1], jnp.bfloat16),
            step_i=jnp.int32(step_i), **common)
        got = dk.decode_step_fused_staged_plain(
            torch.from_numpy(x0), layers_t, kt, vt, pt,
            torch.from_numpy(stage[0]).bfloat16(),
            torch.from_numpy(stage[1]).bfloat16(), step_i,
            kv_block_size=KVB, **common)
    else:
        paged = mode.startswith("paged")
        want = pallas_decode.decode_step_fused(
            jnp.asarray(x0), layers_j, kj, vj, jnp.asarray(past, jnp.int32),
            interpret=True, kv_block=KVB, per_slot_kv=paged, **common,
            **jax_kw)
        step = (dk.decode_step_fused_paged_plain if paged
                else dk.decode_step_fused_batched_plain)
        got = step(torch.from_numpy(x0), layers_t, kt, vt, pt,
                   kv_block_size=KVB, **common, **t_kw)
    _rel_close(got[0].numpy(), want[0], X_RTOL)
    for g, w in zip(got[1:], want[1:]):
        _rel_close(g.float().numpy(), np.asarray(w, np.float32), ROW_RTOL)


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("W,B,H,kvb,want", [
    (512, 32, 16, 128, (4, 128)),    # the ragged B=32 step
    (128, 32, 16, 128, (1, 128)),    # the serve's window: no cluster
    (1024, 32, 16, 128, (8, 128)),   # eight 128-row blocks
    (512, 1, 16, 128, (4, 128)),     # the paged step at B=1
    (128, 1, 16, 128, (1, 128)),     # one slot: the same plan
    (100, 32, 16, 100, (1, 100)),    # a window 128 rows cover
    (300, 8, 16, 150, (3, 100)),     # ranges that split the window evenly
    (16, 4, 2, 8, (1, 16)),
    (4096, 8, 16, 512, (16, 256)),   # at most 16 CTAs
])
def test_plan(W, B, H, kvb, want):
    """``attn_plan`` -> (cluster, rows_cap): 128 rows a CTA at any B and
    H, at most 16 CTAs; the cluster's CTAs cover the window, and the
    kernel's ranges [c rows_cap, (c + 1) rows_cap) put every live row in
    exactly one of them."""
    cluster, rows_cap = dk.attn_plan(W, kvb)
    assert (cluster, rows_cap) == want
    assert cluster * rows_cap >= W and rows_cap <= 512
    for live in range(W + 1):
        n = [max(0, min(rows_cap, live - c * rows_cap)) for c in range(cluster)]
        assert sum(n) == live and max(n) <= rows_cap


@pytest.mark.parametrize("W,kvb,staged,want", [
    (512, 128, 7, (5, 104)),      # the staged step 7 of 16
    (128, 128, 7, (1, 135)),      # the serve's window: one CTA still
    (128, 128, 384, (1, 512)),    # as long as a CTA holds them
    (128, 128, 385, (5, 103)),
    (512, 128, 70, (5, 117)),     # staged rows over several CTAs
    (128, 128, 1023, (9, 128)),   # a chunk of 1024 at the serve's window
    (1024, 128, 1024, (16, 128)),
    (6000, 128, 2192, (16, 512)),  # the most a cluster holds
])
def test_plan_staged(W, kvb, staged, want):
    """The staged rows continue the slot's rows: the plan covers the
    window and the staged rows (one CTA where the window fits one and the
    staged rows fit beside it), and each CTA's range holds cache rows,
    staged rows or both, every row in exactly one range."""
    cluster, rows_cap = dk.attn_plan(W, kvb, staged)
    assert (cluster, rows_cap) == want
    for live in (0, 1, W // 2, W):
        tot = live + staged
        ranges = [(min(c * rows_cap, tot),
                   min(c * rows_cap, tot) + min(rows_cap,
                                                tot - min(c * rows_cap, tot)))
                  for c in range(cluster)]
        cache = sum(max(0, min(hi, live) - lo) for lo, hi in ranges)
        st = sum(hi - lo for lo, hi in ranges) - cache
        assert (cache, st) == (live, staged)


@pytest.mark.parametrize("W,kvb,staged", [
    (8193, 512, 0),    # over 512 rows a CTA
    (1024, 8, 0),      # 128 KV blocks: over the kernel's table
    (6000, 128, 2193),  # window and staged rows over 16 CTAs of 512
    (0, 128, 0),
])
def test_plan_refuses(W, kvb, staged):
    with pytest.raises(ValueError):
        dk.attn_plan(W, kvb, staged)


CSRC = pathlib.Path(dk.__file__).resolve().parent.parent / "csrc"


def test_cache_writers_are_ordinary_launches():
    """The kernel copies its cache rows in before it waits on the qkv
    GEMV, so every kernel that writes the caches must be an ordinary
    launch that never triggers its dependents early (attn_batched.cuh's
    comment): kv_commit.cu's three commits (the lm_head tails' commits are
    these; the int8 steps' commit quantizes its rows in the kernel) launch
    with ``<<<>>>`` and hold no programmatic-launch call."""
    src = (CSRC / "kv_commit.cu").read_text()
    assert "kv_commit_kernel<<<" in src
    assert "kv_commit_quant_kernel<<<" in src
    assert len(re.findall(r"kv_commit_quant_rows_kernel<\d+><<<", src)) == 3
    for word in ("launch_dependent", "cudaLaunchKernelEx", "pdl_trigger",
                 "pdl_wait", "griddepcontrol", "Programmatic"):
        assert word not in src, word


def test_fed_rows_replays_each_layers_current_rows(layers):
    """``chip_smoke.py::fed_rows`` feeds the plain int8 step's fake
    quantization the rows a kernel returned, each layer's k then its v:
    fed the plain step's own rows it gives the same x bit for bit, and a
    row moved by one int8 level moves x."""
    import importlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    chip_smoke = importlib.import_module("chip_smoke")
    _, layers_t = layers
    B = 4
    rng = np.random.RandomState(3)
    kc, vc = (torch.from_numpy(rng.randint(-127, 128, size=(L, B, S, D))
                               .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.01, size=(L, B, 1, S))
                               .astype(np.float32)) for _ in range(2))
    x0 = torch.from_numpy(rng.randn(B, D).astype(np.float32))
    pt = torch.tensor([0, 5, 20, 11], dtype=torch.int32)

    def plain():
        return dk.decode_step_fused_batched_plain(
            x0, layers_t, kc, vc, pt, n_head=H, window=WINDOW,
            kv_block_size=KVB, k_scales=ks, v_scales=vs)
    x, kr, vr = plain()
    assert torch.equal(chip_smoke.fed_rows(plain, kr, vr)[0], x)
    moved = vr.clone()
    step = moved[0, 0].abs().max() / 127
    moved[0, 0, 3] += step   # slot 0 is dead: its context is this row
    assert not torch.equal(chip_smoke.fed_rows(plain, kr, moved)[0], x)
    assert not chip_smoke.FAILURES
