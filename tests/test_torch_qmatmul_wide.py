"""``qmatmul_wide`` (its plain version on the CPU) at odd row counts and
over two of the TPU kernel's 1024-row chunks of d_in, and the M <= 8
lm_head tails at odd row counts, against the JAX package's Pallas kernels
(``qmatmul_pallas_wide``, ``lm_head_argmax_pallas``) in interpret mode;
then the wrapper's pure-Python route logic: the streaming GEMV's grid
(``stream_plan``: the vocab-width and projection regimes, the split of a
long d_in, its refusals), the tails' row counts and their workspace
cache.

The same planes (carried across byte for byte by ``params_from_numpy``)
and the same seeded numpy inputs go through both. The CUDA kernels
(``csrc/qgemv_stream.cuh``) are held against these plain versions on the
card by ``chip_smoke.py``.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from biogpt_tpu.ops import pallas_qmatmul
from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import pack_nibble_planes, quantize_to_planes

from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.ops import qmatmul_kernels as qk

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
# the plain versions transcribe the TPU kernels' arithmetic (bf16 rows and
# weights, exact products); the two differ only in the order of their f32
# sums, ~1e-5 of the output's magnitude
SUM_ORDER_RTOL = 1e-5
H100_SMS = 132
# BioGPT-347M's widths: the four projections and the padded lm_head
D, F, V_PAD = 1024, 4096, 42496
SHAPES_347M = {"qkv": (D, 3 * D), "o": (D, D), "fc1": (D, F), "fc2": (F, D),
               "lm_head": (D, V_PAD)}


def _qt_pair(qtype, d_out, d_in, seed, bf16_scales=False):
    """(JAX planes, port planes) of one random weight, nibble-packed where
    the format packs; optionally with the engine's bf16 scale planes."""
    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(d_out, d_in).astype(np.float32), qtype))
    if bf16_scales:
        qt = qt._replace(
            scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
            mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
                  if qt.mins is not None else None))
    return qt, params_from_numpy(qt, device="cpu")


def _rel_close(got, want, rtol):
    """|got - want| <= rtol * max|want| elementwise."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------- against the TPU kernels

@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m", [9, 17, 31])
def test_qmatmul_wide_odd_rows_match_pallas(qtype, m):
    """Row counts that fill neither m16 tile: the kernel's rows past M are
    zero, the plain version's are not there."""
    qt_j, qt_t = _qt_pair(qtype, d_out=256, d_in=256, seed=50 + qtype)
    x = np.random.RandomState(m).randn(m, 256).astype(np.float32)
    want = np.asarray(pallas_qmatmul.qmatmul_pallas_wide(
        jnp.asarray(x), qt_j, interpret=True))
    got = qk.qmatmul_wide(torch.from_numpy(x), qt_t).numpy()
    assert got.shape == (m, 256)
    _rel_close(got, want, SUM_ORDER_RTOL)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_qmatmul_wide_two_chunks_match_pallas(qtype):
    """d_in = 2048: the TPU kernel dequantizes in two 1024-row chunks; the
    gates of both packages admit it."""
    qt_j, qt_t = _qt_pair(qtype, d_out=128, d_in=2048, seed=60 + qtype)
    x = np.random.RandomState(7).randn(17, 2048).astype(np.float32)
    assert qk.supports_wide(qt_t, 17) and pallas_qmatmul.supports_wide(qt_j, 17)
    want = np.asarray(pallas_qmatmul.qmatmul_pallas_wide(
        jnp.asarray(x), qt_j, interpret=True))
    got = qk.qmatmul_wide(torch.from_numpy(x), qt_t).numpy()
    _rel_close(got, want, SUM_ORDER_RTOL)


@pytest.mark.parametrize("qtype", [codecs.GGML_TYPE_Q4_0,
                                   codecs.GGML_TYPE_Q5_1,
                                   codecs.GGML_TYPE_Q8_0])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_small_tails_match_pallas(qtype, m):
    """The M <= 8 greedy tail (X' numerics) at row counts the streaming
    GEMV takes as they come: ids exactly, winning logits to summation
    order; n_valid < d_out masks pad columns."""
    qt_j, qt_t = _qt_pair(qtype, d_out=1024, d_in=128, seed=70 + qtype,
                          bf16_scales=True)
    rng = np.random.RandomState(80 + m)
    x = rng.randn(m, 128).astype(np.float32)
    lnw = rng.randn(128).astype(np.float32)
    lnb = (rng.randn(128) * 0.1).astype(np.float32)
    n_valid = 1024 - 37
    ids_j, mv_j = pallas_qmatmul.lm_head_argmax_pallas(
        jnp.asarray(x), jnp.asarray(lnw), jnp.asarray(lnb), qt_j,
        n_valid=n_valid, interpret=True, with_max=True)
    ids_t, mv_t = qk.lm_head_argmax(
        torch.from_numpy(x), torch.from_numpy(lnw), torch.from_numpy(lnb),
        qt_t, n_valid)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _rel_close(mv_t.numpy(), np.asarray(mv_j), SUM_ORDER_RTOL)


# ------------------------------------------------------------ the grid

def _groups_per_warp(d_in: int, splits: int) -> int:
    gpb = math.ceil(d_in // 64 / splits)
    return math.ceil(gpb / qk.STREAM_WARPS)


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 32])
def test_stream_plan_vocab_width_is_persistent(m):
    """At the lm_head (664 column tiles) the blocks are as many as the card
    holds at once, each walking tiles, with no split of d_in."""
    grid_x, splits = qk.stream_plan(m, D, V_PAD, H100_SMS)
    assert splits == 1
    assert grid_x == H100_SMS
    assert grid_x < V_PAD // 64
    assert _groups_per_warp(D, splits) <= qk.STREAM_GPW


@pytest.mark.parametrize("name", ["qkv", "o", "fc1", "fc2"])
@pytest.mark.parametrize("m", [9, 16, 32])
def test_stream_plan_projections_fill_one_wave(name, m):
    """At the layer projections a block per column tile, d_in split over a
    cluster: the blocks fit on the card at once, every warp holds one
    packed group, and the split covers d_in."""
    d_in, d_out = SHAPES_347M[name]
    grid_x, splits = qk.stream_plan(m, d_in, d_out, H100_SMS)
    assert grid_x == d_out // 64
    assert 1 < splits <= qk.STREAM_MAX_SPLITS
    assert grid_x * splits <= H100_SMS
    assert _groups_per_warp(d_in, splits) == 1
    assert math.ceil(d_in // 64 / splits) * splits >= d_in // 64


@pytest.mark.parametrize("d_in,least", [(2048, 2), (4096, 4), (8192, 8),
                                        (16384, 16), (32768, 16)])
def test_stream_plan_splits_long_d_in(d_in, least):
    """Past 1024 rows of d_in a block's slice would exceed two groups a
    warp: the plan splits d_in over at least d_in / 1024 blocks of a
    cluster, at vocab width and at projection widths alike, up to the 16
    of a cluster (past them a warp takes more groups, two at a time)."""
    for d_out in (1024, V_PAD):
        grid_x, splits = qk.stream_plan(32, d_in, d_out, H100_SMS)
        assert least <= splits <= qk.STREAM_MAX_SPLITS
        if d_in <= 16384:
            assert _groups_per_warp(d_in, splits) <= qk.STREAM_GPW
        assert grid_x * splits <= max(H100_SMS, (d_out // 64) * splits)


def test_stream_plan_covers_the_gate():
    """Every (d_in, d_out) that ``supports_wide`` admits, up to d_in = 32768,
    gets a grid within its limits at every row count the wide kernel
    takes: no more splits than groups, a cluster at most."""
    for d_in in [64 * k for k in range(1, 17)] + [1024 * k for k in
                                                  range(2, 33)]:
        for d_out in (128, 384, 1024, 8448, V_PAD):
            for m in range(9, 33):
                grid_x, splits = qk.stream_plan(m, d_in, d_out, H100_SMS)
                assert 1 <= grid_x <= d_out // 64
                assert 1 <= splits <= min(qk.STREAM_MAX_SPLITS, d_in // 64)


@pytest.mark.parametrize("m,d_in,d_out", [(0, 1024, 1024), (33, 1024, 1024),
                                          (16, 1000, 1024), (16, 1024, 1000)])
def test_stream_plan_refuses(m, d_in, d_out):
    """Rows outside 1..32 and widths off the 64-wide groups and tiles."""
    with pytest.raises(ValueError):
        qk.stream_plan(m, d_in, d_out, H100_SMS)


# ------------------------------------------------------- the tails' rows

def test_tail_rows():
    """The tails' kernels run M rows as they come up to 8 and 16 or 32 rows
    above (the M = 16, 32 GEMV, zero rows padded)."""
    assert [qk.tail_rows(m) for m in (1, 2, 5, 8)] == [1, 2, 5, 8]
    assert [qk.tail_rows(m) for m in (9, 16, 17, 32)] == [16, 16, 32, 32]


def test_tail_workspace_is_cached_per_key():
    """One workspace per (device, kernel rows, d_in, d_out), made once: the
    triples of every (row, 64-column tile) and, above 8 rows, the bf16
    LayerNorm'd rows."""
    cpu = torch.device("cpu")
    ws = qk.tail_workspace(cpu, 5, 128, 1024)
    assert qk.tail_workspace(cpu, 5, 128, 1024) is ws
    for key in ((4, 128, 1024), (5, 256, 1024), (5, 128, 2048)):
        assert qk.tail_workspace(cpu, *key) is not ws
    assert ws["bmax"].dtype == torch.float32 and ws["bidx"].dtype == torch.int32
    assert all(ws[k].numel() == 5 * 1024 // 64 for k in ("bmax", "bidx",
                                                         "bnan"))
    assert ws["xn"] is None
    big = qk.tail_workspace(cpu, 16, 128, 1024)
    assert big["xn"].shape == (16, 128) and big["xn"].dtype == torch.bfloat16
