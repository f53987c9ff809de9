"""Row 11 with the rows' quantization folded in (``decode_kernels.
kv_commit_quant_rows``, the int8 steps' commit): its plain version on the
CPU against the JAX package's ``quantize_rows`` and
``kv_commit_quant_pallas`` in interpret mode, bit for bit, and the int8
steps' routes through it (``models.biogpt._fused_decode_hidden`` and
``runtime.cache.commit_rows``). The CUDA kernel (``csrc/kv_commit.cu``)
is held against the plain version on the card by ``chip_smoke.py``."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.ops import pallas_decode
from biogpt_tpu.runtime import cache as jax_cache

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.modelio.checkpoint import load_params
from biogpt_tpu_torch.modelio.synthetic import write_random_quantized_model
from biogpt_tpu_torch.models import biogpt
from biogpt_tpu_torch.ops import decode_kernels
from biogpt_tpu_torch.runtime import cache
from biogpt_tpu_torch.runtime.engine import Engine

L, S, D = 3, 128, 128   # S: the TPU kernel's lane-aligned scale tiles
CFG_KW = dict(d_model=128, d_ff=256, n_head=2, n_layer=L, n_vocab=256,
              n_positions=64)


def _rows(seed, B):
    """f32 rows (L, B, D) of varied magnitudes; slot 0 holds a zero row and
    rows whose every element divides to an exact .5 tie (absmax 127 and
    odd halves; absmax 254 and odd integers)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(L, B, D) * rng.uniform(0.01, 5.0, (L, B, 1))).astype(
        np.float32)
    ar = np.arange(D, dtype=np.float32) % 254 - 127
    x[0, 0] = 0.0
    x[1, 0] = ar + 0.5
    x[1, 0, 0] = 127.0
    x[2, 0] = 2 * ar + 1
    x[2, 0, 0] = 254.0
    return x


def _caches(seed, B):
    rng = np.random.RandomState(seed)
    lv = [rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
          for _ in range(2)]
    sc = [rng.rand(L, B, 1, S).astype(np.float32) for _ in range(2)]
    return lv + sc


@pytest.mark.parametrize("B,past", [(1, [77]), (5, [0, 7, 127, 64, 33])])
def test_fused_commit_matches_pallas(B, past):
    """Positions in range: the JAX commit kernel takes the rows the JAX
    ``quantize_rows`` makes, slot-major; the port's commit quantizes the
    step-major f32 rows itself. Levels and scales bit for bit, in place."""
    k, v = _rows(1 + B, B), _rows(2 + B, B)
    caches = _caches(B, B)
    (kq, ksc), (vq, vsc) = (jax_cache.quantize_rows(jnp.asarray(r))
                            for r in (k, v))
    want = pallas_decode.kv_commit_quant_pallas(
        *map(jnp.asarray, caches), kq.transpose(1, 0, 2),
        vq.transpose(1, 0, 2), ksc.T[..., None], vsc.T[..., None],
        jnp.asarray(past, jnp.int32), interpret=True)
    ct = [torch.from_numpy(a.copy()) for a in caches]
    got = decode_kernels.kv_commit_quant_rows(
        *ct, torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(past, dtype=torch.int32))
    assert all(g is c for g, c in zip(got, ct))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # scale 1: -125.5 and -124.5 tie to the even -126 and -124
    assert [int(q) for q in got[0][1, 0, past[0], 1:3]] == [-126, -124]


@pytest.mark.parametrize("B,past", [(1, -3), (1, S + 5),
                                    (5, [-3, S + 5, 0, S - 1, 40])])
def test_fused_commit_clamps_positions(B, past):
    """Positions outside [0, S) land on the clamped row (-3 on row 0, S + 5
    on row S - 1), as the int8-row commit's contract has it (the JAX
    commit kernel leaves such rows to its tiling); the rows quantize as the
    JAX ``quantize_rows`` does; a host int commits every slot at it."""
    k, v = _rows(7, B), _rows(8, B)
    caches = [torch.from_numpy(a) for a in _caches(9, B)]
    (kq, ksc), (vq, vsc) = (jax_cache.quantize_rows(jnp.asarray(r))
                            for r in (k, v))
    pv = past if isinstance(past, list) else [past] * B
    want = decode_kernels.kv_commit_quant_plain(
        *(c.clone() for c in caches),
        *(torch.from_numpy(np.array(a)) for a in (
            kq.transpose(1, 0, 2), vq.transpose(1, 0, 2), ksc.T[..., None],
            vsc.T[..., None])), torch.tensor(pv, dtype=torch.int32))
    pt = torch.tensor(past, dtype=torch.int32) if isinstance(past, list) \
        else past
    got = decode_kernels.kv_commit_quant_rows(
        *(c.clone() for c in caches), torch.from_numpy(k),
        torch.from_numpy(v), pt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    row = min(max(pv[0], 0), S - 1)
    np.testing.assert_array_equal(got[0][:, 0, row].numpy(),
                                  np.asarray(kq)[:, 0])


@pytest.fixture(scope="module")
def int8_params(tmp_path_factory):
    cfg = TorchConfig.tiny(**CFG_KW)
    path = os.path.join(tmp_path_factory.mktemp("m"), "m.bin")
    write_random_quantized_model(path, cfg, seed=0)
    config, _, _, params = load_params(path, device="cpu")
    return config, Engine(config, params, kv_quant=True, device="cpu").params


def _recorder(monkeypatch, module):
    calls = []
    real = decode_kernels.kv_commit_quant_rows

    def rec(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(module, "kv_commit_quant_rows", rec)
    return calls


@pytest.mark.parametrize("B,per_slot", [(3, False), (3, True), (1, False)])
def test_int8_steps_commit_through_the_fused_commit(monkeypatch, int8_params,
                                                    B, per_slot):
    """The lockstep and paged int8 steps (per-slot positions) and the single
    stream (the host's position, through ``commit_rows``) commit once a
    step through ``kv_commit_quant_rows``, with the step's f32 rows, and
    the caches hold what ``quantize_rows`` and the plain commit give."""
    config, P = int8_params
    calls = _recorder(monkeypatch, biogpt if B > 1 else decode_kernels)
    rng = np.random.RandomState(B)
    toks = torch.from_numpy(rng.randint(4, config.n_vocab - 2, (B, 1)))
    past = torch.tensor([5, 0, 17][:B], dtype=torch.int32) if B > 1 else 9
    ch = cache.init_cache(config, batch=B, max_len=32, dtype=torch.int8)
    _, got = biogpt._fused_decode_hidden(P, toks, ch, past, config,
                                         kv_window=32, per_slot_kv=per_slot)
    assert len(calls) == 1
    k_rows, v_rows = calls[0][4], calls[0][5]
    assert k_rows.dtype == torch.float32 and tuple(k_rows.shape) == (
        config.n_layer, B, config.d_model)
    want = cache.init_cache(config, batch=B, max_len=32, dtype=torch.int8)
    pt = past if B > 1 else torch.full((1,), past, dtype=torch.int32)
    (kq, ksc), (vq, vsc) = (cache.quantize_rows(r) for r in (k_rows, v_rows))
    decode_kernels.kv_commit_quant_plain(
        want.k, want.v, want.ks, want.vs, kq.transpose(0, 1),
        vq.transpose(0, 1), ksc.transpose(0, 1)[..., None],
        vsc.transpose(0, 1)[..., None], pt)
    for a, b in ((got.k, want.k), (got.v, want.v), (got.ks, want.ks),
                 (got.vs, want.vs)):
        assert torch.equal(a, b)


def test_commit_rows_commits_through_the_fused_commit(monkeypatch):
    """``commit_rows`` on an int8 cache: one call of the fused commit at the
    host's position, every slot's rows there."""
    cfg = TorchConfig.tiny(**CFG_KW)
    calls = _recorder(monkeypatch, decode_kernels)
    ch = cache.init_cache(cfg, batch=2, max_len=16, dtype=torch.int8)
    k, v = (torch.from_numpy(_rows(s, 2)) for s in (3, 4))
    cache.commit_rows(ch, k, v, 6)
    assert len(calls) == 1 and calls[0][6] == 6
    kq, ksc = cache.quantize_rows(k)
    assert torch.equal(ch.k[:, :, 6], kq) and torch.equal(ch.ks[:, :, 0, 6],
                                                          ksc)
    assert not ch.k[:, :, 5].any() and not ch.k[:, :, 7].any()
