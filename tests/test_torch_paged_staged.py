"""The port's paged (per-slot KV) and staged (chunk-local KV staging) decode
steps and their serving paths against the JAX package's, on the CPU at a
small configuration: the plain steps against ``decode_step_fused(
per_slot_kv=True)`` and ``decode_step_fused(k_stage=...)`` in interpret
mode, ``BatchedEngine(paged_kv=True)`` and ``BatchedEngine(staged_kv=True)``
against the JAX engines with the same flags, and the cache's clamped block
write against ``update_layer``. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig, GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops import pallas_decode
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime import cache as jax_cache
from biogpt_tpu.runtime.engine import _pack_matmul_weights
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import decode_kernels
from biogpt_tpu_torch.runtime import cache
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=3, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)
L, S, D, H = CFG.n_layer, CFG.n_positions, CFG.d_model, CFG.n_head
WINDOW, KVB = 16, 8
# the kernels' tolerances (tests/test_torch_batched.py): both sides run the
# same bf16-path arithmetic and differ in f32 summation order and the
# GELU's erf, which can flip a bf16 rounding: 1e-3 of the hidden state's
# magnitude, one bf16 ulp (2^-7) of the rows' largest
X_RTOL, ROW_RTOL = 1e-3, 2 ** -7


def _rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def layers():
    """{qtype: (JAX engine-packed layers, the port's)}"""
    out = {}
    for qtype in (codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
                  codecs.GGML_TYPE_Q5_1, codecs.GGML_TYPE_Q8_0):
        p = _pack_matmul_weights(params_from_state_dict(
            make_state_dict(CFG, seed=qtype + 3), CFG, qtype=qtype))
        out[qtype] = (p["layers"], params_from_numpy(p["layers"], "cpu"))
    return out


def _caches(rng, B, quant):
    """Seeded caches -> (JAX kwargs and caches, port kwargs and caches)."""
    if quant:
        kc, vc = (rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.01, size=(L, B, 1, S)).astype(
            np.float32) for _ in range(2))
        return ((jnp.asarray(kc), jnp.asarray(vc),
                 dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))),
                (_t(kc), _t(vc), dict(k_scales=_t(ks), v_scales=_t(vs))))
    kc, vc = ((rng.randn(L, B, S, D) * 0.5).astype(np.float32)
              for _ in range(2))
    return ((jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16), {}),
            (_t(kc).bfloat16(), _t(vc).bfloat16(), {}))


def _check(got, want):
    x_t, kr_t, vr_t = got
    x_j, kr_j, vr_j = want
    assert kr_t.dtype == (torch.float32 if kr_j.dtype == jnp.float32
                          else torch.bfloat16)
    _rel_close(x_t.numpy(), np.asarray(x_j), X_RTOL)
    for g, w in ((kr_t, kr_j), (vr_t, vr_j)):
        _rel_close(g.float().numpy(), np.asarray(w, np.float32), ROW_RTOL)


# ------------------------------------------------------------ the steps

# B = 1, 4, 12; a dead slot at 0 and a slot past the window of 16
PAST = {1: [13], 4: [0, 5, 17, 9],
        12: [3, 0, 9, 31, 12, 0, 1, 22, 15, 7, 16, 25]}


# Q4_0 and Q4_1 at every B; Q5_1 (packed, mins) and Q8_0 (unpacked) at B=4
PAGED_CASES = ([(q, B) for q in (codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1)
                for B in sorted(PAST)]
               + [(codecs.GGML_TYPE_Q5_1, 4), (codecs.GGML_TYPE_Q8_0, 4)])


@pytest.mark.parametrize("qtype,B", PAGED_CASES)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_step_matches_pallas(layers, B, qtype, quant):
    """The plain paged step against ``decode_step_fused(per_slot_kv=True,
    interpret=True)`` in blocks of 8 rows (two per window): ragged
    positions, dead slots, a slot past the window; dequant-then-dot
    projections at B=1 too; int8 rows leave in f32."""
    layers_j, layers_t = layers[qtype]
    past = PAST[B]
    rng = np.random.RandomState(B + 10 * quant)
    x0 = rng.randn(B, D).astype(np.float32)
    (kj, vj, sj), (kt, vt, st) = _caches(rng, B, quant)
    want = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, kj, vj, jnp.asarray(past, jnp.int32),
        n_head=H, window=WINDOW, interpret=True, kv_block=KVB,
        per_slot_kv=True, **sj)
    got = decode_kernels.decode_step_fused_paged_plain(
        _t(x0), layers_t, kt, vt, torch.tensor(past, dtype=torch.int32),
        n_head=H, window=WINDOW, kv_block_size=KVB, **st)
    _check(got, want)


def test_paged_wrapper_walks_the_paged_blocks(layers):
    """Through the dispatcher on the CPU (``per_slot_kv=True``), the default
    blocks: ``kv_block_paged`` equals the JAX choice, and the step equals
    the JAX paged kernel in its own blocks (one of 16 rows here) and,
    bit for bit, the batched plain step in the same blocks (the paged walk
    changes which blocks are read, never the numbers)."""
    for w in (16, 100, 128, 256, 512, 600, 1024):
        assert (decode_kernels.kv_block_paged(w)
                == pallas_decode._kv_block_paged(w))
    layers_j, layers_t = layers[codecs.GGML_TYPE_Q4_0]
    past = PAST[4]
    rng = np.random.RandomState(7)
    x0 = rng.randn(4, D).astype(np.float32)
    (kj, vj, _), (kt, vt, _) = _caches(rng, 4, False)
    want = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, kj, vj, jnp.asarray(past, jnp.int32),
        n_head=H, window=WINDOW, interpret=True, per_slot_kv=True)
    pt = torch.tensor(past, dtype=torch.int32)
    got = decode_kernels.decode_step_fused(
        _t(x0), layers_t, kt, vt, pt, n_head=H, window=WINDOW,
        per_slot_kv=True)
    _check(got, want)
    same = decode_kernels.decode_step_fused_batched_plain(
        _t(x0), layers_t, kt, vt, pt, n_head=H, window=WINDOW)
    for a, b in zip(got, same):
        assert torch.equal(a, b)


C = 4                       # staging rows: the serving chunk
LENGTHS0 = [0, 5, 12, 20]   # chunk-start positions: dead, ragged, past W


def _staged_inputs(rng):
    x0 = rng.randn(4, D).astype(np.float32)
    (kj, vj, _), (kt, vt, _) = _caches(rng, 4, False)
    stage = (rng.randn(2, L, 4, C, D) * 0.5).astype(np.float32)
    return x0, (kj, vj), (kt, vt), stage


@pytest.mark.parametrize("qtype,step_i", [
    (q, i) for q in (codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1)
    for i in (0, 2, C - 1)]
    + [(codecs.GGML_TYPE_Q5_1, 2), (codecs.GGML_TYPE_Q8_0, 2)])
def test_staged_step_matches_pallas(layers, step_i, qtype):
    """The plain staged step against ``decode_step_fused(k_stage=...,
    step_i=..., interpret=True)``: slot b reads its cache rows below
    ``past[b] - step_i`` (two 8-row blocks of the window), then its staged
    rows below ``step_i``."""
    layers_j, layers_t = layers[qtype]
    rng = np.random.RandomState(step_i)
    x0, (kj, vj), (kt, vt), stage = _staged_inputs(rng)
    past = [n + step_i for n in LENGTHS0]
    want = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, kj, vj, jnp.asarray(past, jnp.int32),
        n_head=H, window=WINDOW, interpret=True, kv_block=KVB,
        k_stage=jnp.asarray(stage[0], jnp.bfloat16),
        v_stage=jnp.asarray(stage[1], jnp.bfloat16),
        step_i=jnp.int32(step_i))
    got = decode_kernels.decode_step_fused_staged_plain(
        _t(x0), layers_t, kt, vt, torch.tensor(past, dtype=torch.int32),
        _t(stage[0]).bfloat16(), _t(stage[1]).bfloat16(), step_i,
        n_head=H, window=WINDOW, kv_block_size=KVB)
    _check(got, want)


@pytest.mark.parametrize("step_i", [0, 2, C - 1])
def test_staged_step_against_batched_on_the_committed_cache(layers, step_i):
    """The staged step against the batched step on the cache with the
    staged rows committed at ``past[b] - step_i``. At ``step_i`` 0 there is
    nothing staged and the two are bit-identical. Past it they are not:
    the staged rows fold in as one block with its own running max, so p
    rounds to bf16 relative to another maximum than in the committed
    cache's blocks (the JAX docstring's "bit-identical" holds for the
    values and the masking, not for these roundings). The port reaches the
    kernels' tolerance (x within 1e-3 of its magnitude, rows within one
    bf16 ulp)."""
    layers_t = layers[codecs.GGML_TYPE_Q4_0][1]
    rng = np.random.RandomState(20 + step_i)
    x0, _, (kt, vt), stage = _staged_inputs(rng)
    past = torch.tensor([n + step_i for n in LENGTHS0], dtype=torch.int32)
    ks_, vs_ = _t(stage[0]).bfloat16(), _t(stage[1]).bfloat16()
    got = decode_kernels.decode_step_fused_staged_plain(
        _t(x0), layers_t, kt, vt, past, ks_, vs_, step_i, n_head=H,
        window=WINDOW, kv_block_size=KVB)
    kc, vc = kt.clone(), vt.clone()
    cache.write_block(kc, ks_[:, :, :step_i], past - step_i)
    cache.write_block(vc, vs_[:, :, :step_i], past - step_i)
    want = decode_kernels.decode_step_fused_batched_plain(
        _t(x0), layers_t, kc, vc, past, n_head=H, window=WINDOW,
        kv_block_size=KVB)
    if step_i == 0:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # slots whose rows all stay inside the window; slot 3 starts past it
    live = slice(0, 3)
    _rel_close(got[0][live].numpy(), want[0][live].numpy(), X_RTOL)
    for g, w in zip(got[1:], want[1:]):
        _rel_close(g[:, live].float().numpy(), w[:, live].float().numpy(),
                   ROW_RTOL)


def test_step_argument_checks():
    """As the JAX package asserts (pallas_decode.py:1074-1075, :1196-1199):
    staged is never int8, never paged and never B = 1; kv_groups must
    divide the batch and does not compose with staging (where the lockstep
    window has more than one block)."""
    lt = {}
    kw = dict(n_head=16, window=256)
    for B, dtype, extra in ((4, torch.int8, dict(
            k_scales=torch.zeros(1, 4, 1, 256),
            v_scales=torch.zeros(1, 4, 1, 256))),
            (4, torch.bfloat16, dict(per_slot_kv=True)),
            (1, torch.bfloat16, {})):
        kc = torch.zeros(1, B, 256, 64, dtype=dtype)
        st = torch.zeros(1, B, 4, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="staged KV"):
            decode_kernels.decode_step_fused(
                torch.zeros(B, 64), lt, kc, kc, torch.zeros(B), k_stage=st,
                v_stage=st, step_i=1, **kw, **extra)
    kc = torch.empty(1, 32, 256, 1024, dtype=torch.bfloat16)
    st = torch.zeros(1, 32, 4, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not compose"):
        decode_kernels.decode_step_fused(
            torch.zeros(32, 1024), lt, kc, kc, torch.zeros(32), k_stage=st,
            v_stage=st, step_i=1, kv_groups=16, **kw)
    with pytest.raises(ValueError, match="not divisible by kv_groups"):
        decode_kernels.decode_step_fused(
            torch.zeros(32, 1024), lt, kc, kc, torch.zeros(32),
            kv_groups=12, **kw)


# -------------------------------------------------------------- the cache

@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_update_layer_clamps_like_jax(dtype):
    """A host-int write past ``max_len`` lands where
    ``lax.dynamic_update_slice`` puts it (its start clamped so the rows
    fit; a negative start counted from the end), bit for bit, as does a
    per-slot one."""
    rng = np.random.RandomState(3)
    cfg = BioGptConfig.tiny(d_model=16, n_head=2, n_layer=2, n_positions=8)
    tcfg = TorchConfig.tiny(d_model=16, n_head=2, n_layer=2, n_positions=8)
    jd = jnp.int8 if dtype == "int8" else jnp.bfloat16
    td = torch.int8 if dtype == "int8" else torch.bfloat16
    for past, n in ((6, 3), (11, 2), (-2, 1), ([7, -1], 3)):
        k = rng.randn(2, n, 16).astype(np.float32)
        v = rng.randn(2, n, 16).astype(np.float32)
        cj = jax_cache.update_layer(
            jax_cache.init_cache(cfg, batch=2, max_len=8, dtype=jd), 1,
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(past, jnp.int32))
        ct = cache.init_cache(tcfg, batch=2, max_len=8, dtype=td)
        cache.update_layer(ct, 1, _t(k), _t(v), torch.tensor(past)
                           if isinstance(past, list) else past)
        for name in ("k", "v", "ks", "vs") if dtype == "int8" else ("k", "v"):
            got = getattr(ct, name)
            want = np.asarray(getattr(cj, name))
            if dtype == "bf16":
                got, want = got.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# ------------------------------------------------------------ the engines

PROMPTS = [[2, 41, 7], [2, 19, 3, 8], [2, 5]]


@pytest.fixture(scope="module")
def pair():
    pj = params_from_state_dict(make_state_dict(CFG, seed=11), CFG,
                                qtype=codecs.GGML_TYPE_Q4_0)
    return pj, params_from_numpy(pj, device="cpu")


@pytest.mark.parametrize("flags,sampled", [
    (dict(paged_kv=True), False),
    (dict(paged_kv=True, max_batch=1), False),
    (dict(paged_kv=True, kv_quant=True), False),
    (dict(paged_kv=True), True),
    (dict(staged_kv=True), False),
    (dict(staged_kv=True), True),
], ids=["paged-greedy", "paged-b1-greedy", "paged-int8-greedy",
        "paged-sampled",
        "staged-greedy", "staged-sampled"])
def test_engine_matches_jax(pair, flags, sampled):
    """``BatchedEngine`` with the flags against the JAX engine with the
    same flags, its kernels in interpret mode (tests/test_pallas_decode.py:
    536-563): B=2 (and a paged pool of one slot, whose step takes device
    positions too), chunks of 3 and 5 new tokens (chunk boundaries), three
    requests (a refill wave). Greedy rows are token-identical; in a sampled
    batch the sampled row draws from other random bits and is only checked
    for range."""
    pj, pt = pair
    kw = dict(dict(max_batch=2, chunk=3, max_seq=32), **flags)
    gen = dict(temp=0.8 if sampled else 0.0, top_k=12, top_p=0.9,
               stop_at_eos=False, seed=5)

    def reqs(cls):
        return [cls(prompt_ids=list(p), n_predict=5, request_id=i,
                    **(dict(temp=0.0) if sampled and i != 1 else {}))
                for i, p in enumerate(PROMPTS)]
    je = JaxBatchedEngine(CFG, pj, compute_dtype=jnp.bfloat16, **kw)
    try:
        set_pallas_mode(True)
        want = je.serve(reqs(JaxRequest), JaxGen(**gen))
    finally:
        set_pallas_mode("auto")
    te = BatchedEngine(TCFG, pt, device="cpu", **kw)
    assert (te._paged_kv, te._staged_kv) == (je._paged_kv, je._staged_kv)
    assert te._kv_groups == je._kv_groups
    assert te._fused_sampled == je._fused_sampled
    assert te._fused_decode and te._fused_greedy
    got = te.serve(reqs(Request), GenerationParams(**gen))
    for i, p in enumerate(PROMPTS):
        if sampled and i == 1:
            assert len(got[i].ids) == len(p) + 5
            assert all(0 <= t < CFG.n_vocab for t in got[i].ids)
        else:
            assert got[i].ids == want[i].ids, i
