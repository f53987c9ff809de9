"""The port's int8 KV cache (``runtime/cache.py::QuantKVCache``, the int8
mode of the decode steps, ``kv_commit_quant``, ``kv_quant`` in the
engines) against the JAX package's, on the CPU at a small configuration.
The JAX kernels run in interpret mode, the port's as their plain versions;
the CUDA kernels are held against those on the card by ``chip_smoke.py``."""

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
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.runtime.engine import _pack_matmul_weights
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatchedEngine
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import decode_kernels
from biogpt_tpu_torch.runtime import cache
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=3, n_vocab=256,
              n_positions=64)
CFG = BioGptConfig.tiny(**CFG_KW)
TCFG = TorchConfig.tiny(**CFG_KW)


def _rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(seed, shape):
    """Rows of varied magnitudes, a zero row and exact half-level ties."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.uniform(0.01, 5.0, shape[:-1] + (1,))).astype(
        np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1, :4] = [127.0, 2.5, -3.5, 0.5]          # scale 1: ties to even
    flat[1, 4:] = 0.0
    return x


# ------------------------------------------------------------ the cache

def test_quantize_and_dequant_bit_equal_to_jax():
    x = _rows(0, (3, 5, 7, 128))
    qj, sj = jax_cache.quantize_rows(jnp.asarray(x))
    qt, st = cache.quantize_rows(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and list(qt.numpy()[0, 0, 1, :4]) == \
        [127, 2, -4, 0]

    cj = jax_cache.init_cache(CFG, batch=2, max_len=16, dtype=jnp.int8)
    ct = cache.init_cache(TCFG, batch=2, max_len=16, dtype=torch.int8)
    assert isinstance(ct, cache.QuantKVCache)
    for a, b in ((ct.k, cj.k), (ct.v, cj.v), (ct.ks, cj.ks), (ct.vs, cj.vs)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    rng = np.random.RandomState(1)
    lv = rng.randint(-127, 128, size=(3, 2, 16, 128)).astype(np.int8)
    sc = rng.uniform(1e-3, 0.1, size=(3, 2, 1, 16)).astype(np.float32)
    cj = jax_cache.QuantKVCache(k=jnp.asarray(lv), v=jnp.asarray(-lv),
                                ks=jnp.asarray(sc), vs=jnp.asarray(sc * 2))
    ct = cache.QuantKVCache(k=_t(lv), v=_t(-lv), ks=_t(sc), vs=_t(sc * 2))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        kj, vj = jax_cache.dequant_layer(cj, 1, 12, dt_j)
        kt, vt = cache.dequant_layer(ct, 1, 12, dt_t)
        np.testing.assert_array_equal(kt.float().numpy(),
                                      np.asarray(kj, np.float32))
        np.testing.assert_array_equal(vt.float().numpy(),
                                      np.asarray(vj, np.float32))


@pytest.mark.parametrize("past", [4, [2, 9], [0, 15]])
def test_update_layer_quant_bit_equal_to_jax(past):
    """A host int and per-slot positions (the last one clamped to
    [0, max_len - n] as dynamic_update_slice clamps)."""
    n = 3 if isinstance(past, int) else 2
    k = _rows(2, (2, n, 128))
    v = _rows(3, (2, n, 128))
    cj = jax_cache.init_cache(CFG, batch=2, max_len=16, dtype=jnp.int8)
    cj = jax_cache.update_layer(cj, 1, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(past, jnp.int32))
    ct = cache.init_cache(TCFG, batch=2, max_len=16, dtype=torch.int8)
    pt = past if isinstance(past, int) else torch.tensor(past)
    cache.update_layer(ct, 1, _t(k), _t(v), pt)
    for a, b in ((ct.k, cj.k), (ct.v, cj.v), (ct.ks, cj.ks), (ct.vs, cj.vs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kv_commit_quant_matches_pallas_exactly():
    """S = 128 (the TPU kernel's lane-aligned scale tiles); the levels and
    scales land bit for bit, in place."""
    rng = np.random.RandomState(4)
    L, B, S, D = 3, 5, 128, 128
    kc, vc = (rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.rand(L, B, 1, S).astype(np.float32) for _ in range(2))
    kq, vq = (rng.randint(-127, 128, size=(B, L, D)).astype(np.int8)
              for _ in range(2))
    ksc, vsc = (rng.rand(B, L, 1).astype(np.float32) for _ in range(2))
    past = np.array([0, 7, 127, 64, 33], np.int32)
    want = pallas_decode.kv_commit_quant_pallas(
        *map(jnp.asarray, (kc, vc, ks, vs, kq, vq, ksc, vsc, past)),
        interpret=True)
    ct = [_t(a).clone() for a in (kc, vc, ks, vs)]
    got = decode_kernels.kv_commit_quant(*ct, *map(_t, (kq, vq, ksc, vsc)),
                                         _t(past))
    assert all(g is c for g, c in zip(got, ct))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a position outside [0, S) lands on the clamped row
    decode_kernels.kv_commit_quant(*ct, *map(_t, (kq, vq, ksc, vsc)),
                                   torch.tensor([-4, S + 3, 1, 2, 3]))
    np.testing.assert_array_equal(ct[0][:, 0, 0].numpy(), kq[0])
    np.testing.assert_array_equal(ct[3][:, 1, 0, S - 1].numpy(), vsc[1, :, 0])


# --------------------------------------------------- the int8 decode step

def _packed_layers(qtype, seed):
    p = _pack_matmul_weights(params_from_state_dict(
        make_state_dict(CFG, seed=seed), CFG, qtype=qtype))
    return p["layers"], params_from_numpy(p["layers"], "cpu")


@pytest.mark.parametrize("qtype,past,window,kv_block", [
    (codecs.GGML_TYPE_Q4_0, [9], 16, None),                 # B=1, one block
    (codecs.GGML_TYPE_Q4_1, [21], 32, 8),                   # B=1, 4 blocks
    (codecs.GGML_TYPE_Q4_0, [0, 5, 17, 40], 32, None),      # B=4
    (codecs.GGML_TYPE_Q4_1,
     [3, 0, 9, 31, 12, 0, 1, 22, 30, 7, 16, 25], 32, 8),    # B=12
    (codecs.GGML_TYPE_Q5_0, [21], 32, 8),                   # B=1, 4 blocks
    (codecs.GGML_TYPE_Q8_0, [0, 5, 17, 40], 32, None),      # B=4
])
def test_int8_decode_step_matches_pallas(qtype, past, window, kv_block):
    """The int8 mode of the plain steps against ``decode_step_fused(
    k_scales=..., interpret=True)``: ragged positions, dead slots, a slot
    past the window, one and several KV blocks; the rows leave in f32.
    Tolerance: 1e-3 of the hidden state's magnitude, one bf16 ulp of the
    rows' largest (summation order and the GELU's erf, as in
    tests/test_torch_batched.py)."""
    layers_j, layers_t = _packed_layers(qtype, seed=qtype + len(past))
    L, S, D = CFG.n_layer, CFG.n_positions, CFG.d_model
    B = len(past)
    rng = np.random.RandomState(B)
    x0 = rng.randn(B, D).astype(np.float32)
    kc, vc = (rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.01, size=(L, B, 1, S)).astype(np.float32)
              for _ in range(2))
    pj = jnp.asarray(past[0] if B == 1 else past, jnp.int32)
    x_j, kr_j, vr_j = pallas_decode.decode_step_fused(
        jnp.asarray(x0), layers_j, jnp.asarray(kc), jnp.asarray(vc), pj,
        n_head=CFG.n_head, window=window, interpret=True, kv_block=kv_block,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    pt = past[0] if B == 1 else torch.tensor(past, dtype=torch.int32)
    args = (_t(x0), layers_t, _t(kc), _t(vc), pt)
    kw = dict(n_head=CFG.n_head, window=window, k_scales=_t(ks),
              v_scales=_t(vs))
    if kv_block is None:     # the wrapper walks the TPU kernel's own blocks
        x_t, kr_t, vr_t = decode_kernels.decode_step_fused(*args, **kw)
    else:
        step = (decode_kernels.decode_step_fused_plain if B == 1
                else decode_kernels.decode_step_fused_batched_plain)
        x_t, kr_t, vr_t = step(*args, kv_block_size=kv_block, **kw)
    assert kr_t.dtype == torch.float32 and kr_j.dtype == jnp.float32
    _rel_close(x_t.numpy(), np.asarray(x_j), 1e-3)
    for got, want in ((kr_t, kr_j), (vr_t, vr_j)):
        _rel_close(got.numpy(), np.asarray(want), 2 ** -7)


def test_fake_quant_rows_bit_equal_to_jax():
    x = _rows(5, (6, 128))
    np.testing.assert_array_equal(
        decode_kernels.fake_quant_rows(_t(x)).numpy(),
        np.asarray(pallas_decode._fake_quant_rows(jnp.asarray(x))))


# --------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def f32_pair():
    p = params_from_state_dict(make_state_dict(CFG, seed=5), CFG)
    return p, params_from_numpy(p, device="cpu")


def test_engine_kv_quant_matches_jax(f32_pair):
    """f32 compute (the per-op path, tests/test_kv_quant.py:184-198):
    ``Engine(kv_quant=True)`` ids equal the JAX engine's."""
    pj, pt = f32_pair
    prompt = [2, 10, 25, 48]
    want = JaxEngine(CFG, pj, compute_dtype=jnp.float32, kv_quant=True) \
        .generate(prompt, JaxGen(n_predict=8, temp=0.0,
                                 stop_at_eos=False)).ids
    et = Engine(TCFG, pt, compute_dtype=torch.float32, kv_quant=True,
                device="cpu")
    assert et.cache_dtype == torch.int8
    assert isinstance(et.new_cache(), cache.QuantKVCache)
    got = et.generate(prompt, GenerationParams(n_predict=8, temp=0.0,
                                               stop_at_eos=False)).ids
    assert got == want and len(got) == len(prompt) + 8


def test_batched_engine_kv_quant_matches_jax(f32_pair):
    """``BatchedEngine(kv_quant=True)`` at f32 (tests/test_kv_quant.py:
    201-216): every request's ids equal the JAX engine's and the port's
    own single-stream int8 engine's."""
    pj, pt = f32_pair
    prompts = [[2, 5, 9], [2, 11, 30, 41, 8], [2, 7]]
    kw = dict(max_batch=2, chunk=4, kv_quant=True)
    want = JaxBatchedEngine(CFG, pj, compute_dtype=jnp.float32, **kw).serve(
        [JaxRequest(prompt_ids=p, n_predict=5, request_id=i)
         for i, p in enumerate(prompts)], JaxGen(temp=0.0, stop_at_eos=False))
    got = BatchedEngine(TCFG, pt, compute_dtype=torch.float32, device="cpu",
                        **kw).serve(
        [Request(prompt_ids=p, n_predict=5, request_id=i)
         for i, p in enumerate(prompts)],
        GenerationParams(temp=0.0, stop_at_eos=False))
    eng = Engine(TCFG, pt, compute_dtype=torch.float32, kv_quant=True,
                 device="cpu")
    for i, p in enumerate(prompts):
        assert got[i].ids == want[i].ids, i
        assert got[i].ids == eng.generate(p, GenerationParams(
            n_predict=5, temp=0.0, stop_at_eos=False)).ids


@pytest.mark.parametrize("qtype,prompt_len", [(codecs.GGML_TYPE_Q4_0, 6),
                                              (codecs.GGML_TYPE_Q4_1, 12)])
def test_engine_kv_quant_fused_matches_jax(qtype, prompt_len):
    """bf16 compute, packed planes: the int8 mode of the B=1 fused step and
    the argmax tail; 16 new ids equal the JAX engine's (megakernel in
    interpret mode)."""
    pj = params_from_state_dict(make_state_dict(CFG, seed=prompt_len), CFG,
                                qtype=qtype)
    pt = params_from_numpy(pj, device="cpu")
    prompt = [2] + np.random.RandomState(prompt_len).randint(
        3, CFG.n_vocab, size=prompt_len - 1).tolist()
    gen = dict(n_predict=16, temp=0.0, seed=0, stop_at_eos=False)
    ej = JaxEngine(CFG, pj, compute_dtype=jnp.bfloat16, kv_quant=True)
    assert ej._fused_greedy
    try:
        set_pallas_mode(True)
        want = ej.generate(prompt, JaxGen(**gen), stream_cb=lambda _: None).ids
    finally:
        set_pallas_mode("auto")
    et = Engine(TCFG, pt, kv_quant=True, device="cpu")
    assert et._fused_greedy and et.cache_dtype == torch.int8
    assert et.generate(prompt, GenerationParams(**gen)).ids == want
