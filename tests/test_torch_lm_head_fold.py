"""The lm_head tails' argmax in the two stages the CUDA kernels take it
(``argmax_fold_blocks`` below: a triple per block of 64 or 128 columns,
folded per lane tile, then over the tiles) against the TPU
epilogue's one-pass rule (``argmax_fold``), which the plain versions
transcribe: ties keep the lowest index, a tile holding a NaN yields (NaN,
n_valid - 1), pad columns are -1e30 and an id clamps to n_valid - 1."""

import numpy as np
import pytest
import torch

from biogpt_tpu_torch.ops.qmatmul_kernels import argmax_fold

D_OUT, TILE = 1024, 256


def argmax_fold_blocks(logits: torch.Tensor, n_valid: int, tile: int,
                       block: int):
    """:func:`argmax_fold` in the two stages the CUDA tails take it
    (``csrc/lm_head_argmax.cu``: blocks of ``block`` columns, 64 at every
    M since the M <= 8 tails run the streaming GEMV, 128 before, run in
    any order): per block and row the triple
    (max over its non-NaN values, the lowest column holding it, any NaN),
    pad columns at -1e30; then per lane tile its blocks in column order --
    a NaN anywhere gives (NaN, n_valid-1), else the first block's pair,
    replaced by a later block's only where its max is strictly larger, the
    id clamped to n_valid-1 -- and the tiles from tile 0 with a strict `>`.
    Returns ((M,) int32 ids, (M,) f32 max values)."""
    M, d_out = logits.shape
    col = torch.arange(d_out, device=logits.device)
    v = torch.where(col < n_valid, logits, torch.full_like(logits, -1e30))
    vb = v.reshape(M, d_out // block, block)
    nan = torch.isnan(vb)
    bmax = torch.where(nan, torch.full_like(vb, -float("inf")), vb).amax(-1)
    colb = col.reshape(d_out // block, block).expand(M, -1, -1)
    bidx = torch.where(vb == bmax[..., None], colb,
                       torch.full_like(colb, 2 ** 31 - 1)).amin(-1)
    bnan = nan.any(-1)
    per = tile // block
    tv = torch.empty(M, d_out // tile, device=logits.device)
    ti = torch.empty(M, d_out // tile, dtype=torch.long, device=logits.device)
    for j in range(d_out // tile):
        best, bi = bmax[:, j * per].clone(), bidx[:, j * per].clone()
        for b in range(j * per + 1, (j + 1) * per):
            better = bmax[:, b] > best
            best = torch.where(better, bmax[:, b], best)
            bi = torch.where(better, bidx[:, b], bi)
        tnan = bnan[:, j * per:(j + 1) * per].any(-1)
        tv[:, j] = torch.where(tnan, torch.full_like(best, float("nan")), best)
        ti[:, j] = torch.where(tnan, torch.full_like(bi, n_valid - 1),
                               torch.clamp(bi, max=n_valid - 1))
    bv, bi = tv[:, 0].clone(), ti[:, 0].clone()
    for j in range(1, tv.shape[1]):
        better = tv[:, j] > bv
        bv = torch.where(better, tv[:, j], bv)
        bi = torch.where(better, ti[:, j], bi)
    return bi.to(torch.int32), bv


def _logits(seed, n_valid, tile=TILE):
    """Rows of coarse values (many ties), with NaNs placed per row: none, one
    inside a tile, a whole first tile, one in a pad column."""
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(6, D_OUT) * 2) / 2
    x[1, 300] = np.nan
    x[2, :tile] = np.nan
    x[3, 5] = np.nan
    x[4, D_OUT - 1] = np.nan            # a pad column when n_valid < D_OUT
    x[5] = 0.0                          # every column tied
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("n_valid", [D_OUT, 1000, 700])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_stage_fold_equals_the_tpu_rule(block, n_valid, seed):
    x = _logits(seed, n_valid)
    ids, mv = argmax_fold_blocks(x, n_valid, TILE, block)
    want_ids, want_mv = argmax_fold(x, n_valid, TILE)
    assert torch.equal(ids, want_ids)
    assert torch.equal(torch.isnan(mv), torch.isnan(want_mv))
    assert torch.equal(mv[~torch.isnan(mv)], want_mv[~torch.isnan(want_mv)])


def test_two_stage_fold_rules():
    """The rules themselves: the lowest of tied maxima; a NaN in the first
    tile pins (NaN, n_valid - 1), since no later tile compares greater;
    pad columns hold -1e30, and where that wins the id clamps to
    n_valid - 1."""
    x = torch.full((3, D_OUT), -5.0)
    x[0, 700] = x[0, 300] = 2.0                      # a tie across tiles
    x[1, 10] = float("nan")                          # NaN in the first tile
    x[1, 900] = 9.0
    x[2, :] = -1e31                                  # real columns below pad
    for block in (64, 128):
        ids, mv = argmax_fold_blocks(x, 1000, TILE, block)
        assert ids.tolist()[0] == 300 and mv[0] == 2.0
        assert ids.tolist()[1] == 999 and torch.isnan(mv[1])
        assert ids.tolist()[2] == 999 and mv[2] == -1e30


@pytest.mark.parametrize("n_valid", [D_OUT, 1000, 700])
@pytest.mark.parametrize("seed", [3, 4])
def test_two_stage_fold_at_eight_blocks_a_tile(n_valid, seed):
    """The lm_head's lane tile at BioGPT-347M is 512 columns: eight 64-column
    blocks a tile, as the M <= 8 tails fold them (``tile_blocks`` = 8)."""
    x = _logits(seed, n_valid, tile=512)
    ids, mv = argmax_fold_blocks(x, n_valid, 512, 64)
    want_ids, want_mv = argmax_fold(x, n_valid, 512)
    assert torch.equal(ids, want_ids)
    assert torch.equal(torch.isnan(mv), torch.isnan(want_mv))
    assert torch.equal(mv[~torch.isnan(mv)], want_mv[~torch.isnan(want_mv)])
