"""``qmatmul`` at M <= 8 (row 1, ``csrc/qmatmul.cu``): the orders of f32
sums of its two routes -- its own kernel (:func:`qmatmul_sum_order`) and,
at projection widths of up to 1024 rows, the streaming GEMV's M <= 8 X'
path (:func:`stream_sum_order`) -- against the plain version
``qmatmul_plain`` (and through it the JAX kernel, which
``tests/test_torch_kernels.py::test_qmatmul_matches_pallas`` holds it to),
and the wrapper's pure-Python route and grid (``qmm_plan``) against the
limits the launchers check. No JAX: the kernels themselves are held on the
card by ``chip_smoke.py``."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from biogpt_tpu_torch.ops import qmatmul_kernels as qk
from biogpt_tpu_torch.quant import codecs
from biogpt_tpu_torch.quant.layouts import QuantizedTensor

ALL_QTYPES = [codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1,
              codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
              codecs.GGML_TYPE_Q8_0]
# only the order of the f32 sums differs: ~1e-5 of the output's magnitude
SUM_ORDER_RTOL = 1e-5
H100_SMS = 132
D, F, V_PAD = 1024, 4096, 42496
SHAPES_347M = {"qkv": (D, 3 * D), "o": (D, D), "fc1": (D, F), "fc2": (F, D)}
KERNEL = Path(__file__).resolve().parent.parent / "biogpt_tpu_torch" / \
    "csrc" / "qmatmul.cu"


def _planes(qtype, d_in, d_out, seed) -> QuantizedTensor:
    """Random planes as the engines hand them to the kernels: packed 4/5-bit
    levels (any byte is a valid pair of levels; Q5 its fifth-bit plane
    after the nibble rows) or Q8_0's int8 levels, bf16 scales and mins."""
    rng = np.random.RandomState(seed)
    bits = {codecs.GGML_TYPE_Q8_0: 8, codecs.GGML_TYPE_Q5_0: 5,
            codecs.GGML_TYPE_Q5_1: 5}.get(qtype, 4)
    if bits == 8:
        lv = torch.from_numpy(rng.randint(-128, 128, (d_in, d_out))
                              .astype(np.int8))
    else:
        rows = qk.level_rows(d_in, bits)
        lv = torch.from_numpy(rng.randint(0, 256, (rows, d_out))
                              .astype(np.uint8))
    sc = torch.from_numpy(rng.uniform(0.005, 0.02, (d_in // 32, d_out))
                          .astype(np.float32)).to(torch.bfloat16)
    mn = (torch.from_numpy(-rng.uniform(0.05, 0.2, (d_in // 32, d_out))
                           .astype(np.float32)).to(torch.bfloat16)
          if qtype in (codecs.GGML_TYPE_Q4_1, codecs.GGML_TYPE_Q5_1)
          else None)
    return QuantizedTensor(levels=lv, scales=sc, mins=mn, qtype=qtype,
                           packed=bits != 8)


def qmatmul_sum_order(x: torch.Tensor, qt: QuantizedTensor,
                      splits: int) -> torch.Tensor:
    """qmatmul_kernel's order of f32 sums: per 32-level block n the partial
    p_n of the bf16 rows and the uncentered levels, its X' term (p_n -
    offset * xsum_n) * scale_n [+ xsum_n * min_n]; each block of the
    cluster sums its slice of ceil(G / splits) packed groups (G = d_in / 64)
    in order, each group's low level block (n = g) before its high one (n
    = g + G); the slices then add in split order."""
    xb = qk._bf16(x.to(torch.float32))
    lv = qk._raw_levels(qt).to(torch.float32)
    M, d_in = xb.shape
    G = d_in // 64
    sc = qt.scales.to(torch.float32)
    mn = None if qt.mins is None else qt.mins.to(torch.float32)
    off = float(qk._offset(qt))

    def term(n):
        xs = xb[:, 32 * n:32 * (n + 1)]
        p = xs @ lv[32 * n:32 * (n + 1)]
        s = xs.sum(1, keepdim=True)
        t = (p - off * s) * sc[n]
        return t + s * mn[n] if mn is not None else t
    gpb = math.ceil(G / splits)
    total = torch.zeros(M, qt.d_out)
    for k in range(splits):
        acc = torch.zeros(M, qt.d_out)
        for g in range(k * gpb, min(G, (k + 1) * gpb)):
            acc = acc + term(g)
            acc = acc + term(g + G)
        total = total + acc
    return total


def stream_sum_order(x: torch.Tensor, qt: QuantizedTensor,
                     splits: int) -> torch.Tensor:
    """The streaming GEMV's M <= 8 X' order of f32 sums
    (``csrc/qgemv_stream.cuh``): the same per-block X' terms; in each block
    of the cluster's slice of ceil(G / splits) packed groups, warp w takes
    the groups g0 + w, g0 + w + 8, ... in order, each group's low level
    block before its high one; the 8 warps' sums add in warp order, then
    the slices in split order."""
    xb = qk._bf16(x.to(torch.float32))
    lv = qk._raw_levels(qt).to(torch.float32)
    M, d_in = xb.shape
    G = d_in // 64
    sc = qt.scales.to(torch.float32)
    mn = None if qt.mins is None else qt.mins.to(torch.float32)
    off = float(qk._offset(qt))

    def term(n):
        xs = xb[:, 32 * n:32 * (n + 1)]
        p = xs @ lv[32 * n:32 * (n + 1)]
        s = xs.sum(1, keepdim=True)
        t = (p - off * s) * sc[n]
        return t + s * mn[n] if mn is not None else t
    gpb = math.ceil(G / splits)
    total = torch.zeros(M, qt.d_out)
    for k in range(splits):
        g0, g1 = k * gpb, min(G, (k + 1) * gpb)
        block = torch.zeros(M, qt.d_out)
        for w in range(qk.STREAM_WARPS):
            acc = torch.zeros(M, qt.d_out)
            for g in range(g0 + w, g1, qk.STREAM_WARPS):
                acc = acc + term(g)
                acc = acc + term(g + G)
            block = block + acc
        total = total + block
    return total


def _rel_close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m,d_in,splits", [(1, 256, 1), (3, 512, 3),
                                           (8, 1024, 16), (5, 1024, 1)])
def test_sum_order_matches_plain(qtype, m, d_in, splits):
    """The kernel's order of sums, with and without a split of d_in, agrees
    with the plain version to the f32 order."""
    qt = _planes(qtype, d_in, 128, seed=qtype + d_in)
    x = torch.from_numpy(np.random.RandomState(m).randn(m, d_in)
                         .astype(np.float32))
    _rel_close(qmatmul_sum_order(x, qt, splits).numpy(),
               qk.qmatmul_plain(x, qt).numpy(), SUM_ORDER_RTOL)


@pytest.mark.parametrize("qtype", ALL_QTYPES)
@pytest.mark.parametrize("m,d_in", [(1, 1024), (3, 640), (8, 1024)])
def test_stream_route_sum_order_matches_plain(qtype, m, d_in):
    """The streaming route's order of sums, on the grid ``qmm_plan`` gives
    it at a projection width, agrees with the plain version to the f32
    order."""
    d_out = 256
    grid_x, splits, warps = qk.qmm_plan(m, d_in, d_out, H100_SMS)
    assert warps == 0
    qt = _planes(qtype, d_in, d_out, seed=qtype + d_in + 1)
    x = torch.from_numpy(np.random.RandomState(m + 7).randn(m, d_in)
                         .astype(np.float32))
    _rel_close(stream_sum_order(x, qt, splits).numpy(),
               qk.qmatmul_plain(x, qt).numpy(), SUM_ORDER_RTOL)


def _units(grid_x, x, units):
    """The 32-column units of block x (the kernel's u0, u1)."""
    return x * units // grid_x, (x + 1) * units // grid_x


def _src_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         KERNEL.read_text()).group(1))


# (bits, mins) of the five formats
FORMATS = {"q4_0": (4, False), "q4_1": (4, True), "q5_0": (5, False),
           "q5_1": (5, True), "q8_0": (8, False)}


def _align(v):
    return (v + 127) // 128 * 128


def _layout_bytes(bits, mins, warps, m, gpb, splits, sg, stages):
    """(bytes of a stage, bytes of the block): qmm_layout's transcription."""
    lv, sc = sg * 32 * qk.QMM_UNIT, 2 * sg * qk.QMM_UNIT * 2
    extra = _align(lv)
    scale = extra + (0 if bits == 4 else _align(lv))
    unit = scale + _align(sc) + (_align(sc) if mins else 0)
    stage = warps * unit
    xs = 2 * _src_const("QMM_MAX_STAGES") * 8 + 128 + stages * stage
    red = xs + 2 * gpb * m * 64 + 2 * gpb * 8 * 4
    return stage, red + (m * warps * qk.QMM_UNIT * 4 if splits > 1 else 0)


def fifth_box(d_in, sg):
    """qmm_fifth_box: the fifth-bit rows of a Q5 box."""
    return math.gcd(d_in // 8, sg * 32)


def _stages(bits, mins, m, d_in, d_out, plan):
    """launch_qmm's choice of a stage's groups and of the ring's stages ->
    (sg, stages), or None where it finds none."""
    grid_x, splits, warps = plan
    groups, units = d_in // 64, d_out // qk.QMM_UNIT
    gpb = math.ceil(groups / splits)
    passes = math.ceil(math.ceil(units / grid_x) / warps)
    smem_max, max_stages = _src_const("QMM_SMEM_MAX"), _src_const(
        "QMM_MAX_STAGES")
    for sg in (2, 4, 1):
        if gpb % sg:
            continue
        stage, fixed = _layout_bytes(bits, mins, warps, m, gpb, splits, sg, 0)
        items = passes * (gpb // sg)
        fit = min(max_stages, (smem_max - fixed) // stage)
        if fit >= min(2, items) or sg == 1:
            return (sg, min(fit, items)) if min(fit, items) >= 1 else None
    return None


def _launch_ok(m, d_in, d_out, plan, fmt="q4_0") -> bool:
    """The limits the launcher of the plan's route checks before it
    launches (``csrc/qmatmul.cu``): ``launch_stream`` for warps 0 (X', not
    chunked: at most two packed groups a warp), else ``launch_qmm``,
    including the ring it must fit in shared memory."""
    grid_x, splits, warps = plan
    groups = d_in // 64
    gpb = math.ceil(groups / splits)
    if warps == 0:
        return (d_out % 64 == 0 and 1 <= m <= 8 and grid_x >= 1
                and 1 <= splits <= qk.STREAM_MAX_SPLITS and splits <= groups
                and gpb <= qk.STREAM_WARPS * qk.STREAM_GPW)
    units = d_out // qk.QMM_UNIT
    return (1 <= grid_x <= units and 1 <= splits <= qk.STREAM_MAX_SPLITS
            and 1 <= warps <= qk.QMM_MAX_WARPS
            and (splits - 1) * gpb < groups
            and gpb <= qk.QMM_MAX_SLICE_GROUPS
            and (splits == 1 or math.ceil(units / grid_x) <= warps)
            and _stages(*FORMATS[fmt], m, d_in, d_out, plan) is not None)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("d_out", [V_PAD, V_PAD // 2, V_PAD // 4])
def test_plan_vocab_width_is_persistent(m, d_out):
    """At the lm_head and the TP ranks' local lm_heads one persistent block
    per SM, a warp for each of its 32-column units (the units split within
    one of even), d_in not split at 1024 rows."""
    grid_x, splits, warps = qk.qmm_plan(m, D, d_out, H100_SMS)
    units = d_out // 32
    assert (grid_x, splits) == (H100_SMS, 1)
    assert warps == math.ceil(units / grid_x)
    counts = [b - a for a, b in (_units(grid_x, x, units)
                                 for x in range(grid_x))]
    assert sum(counts) == units and max(counts) - min(counts) <= 1
    assert max(counts) <= warps


@pytest.mark.parametrize("name", list(SHAPES_347M))
@pytest.mark.parametrize("m", [1, 8])
def test_plan_projections_fill_the_card(name, m):
    """At the layer projections of up to 1024 rows (qkv, o, fc1) the
    streaming GEMV's route on its own grid; past them (fc2) qmatmul's
    kernel, a block of 4 warps per 128 columns, d_in split over a cluster
    so that the blocks fill most of the card at once, every split holding
    a packed group."""
    d_in, d_out = SHAPES_347M[name]
    plan = qk.qmm_plan(m, d_in, d_out, H100_SMS)
    grid_x, splits, warps = plan
    if d_in <= qk.QMM_STREAM_MAX_D_IN:
        assert plan == (*qk.stream_plan(m, d_in, d_out, H100_SMS), 0)
    else:
        assert warps == qk.QMM_PROJ_WARPS and grid_x == d_out // 128
        assert H100_SMS // 2 <= grid_x * splits <= H100_SMS
    assert _launch_ok(m, d_in, d_out, plan)


@pytest.mark.parametrize("d_in,d_out,route", [
    (1024, 3072, "stream"), (1024, 1024, "stream"), (640, 2560, "stream"),
    (4096, 1024, "kernel"), (1600, 6400, "kernel"), (4096, 4096, "kernel"),
    (1024, V_PAD, "kernel"), (1024, V_PAD // 4, "kernel"),
    (1600, V_PAD, "kernel"), (256, 8448, "kernel")])
def test_plan_routes_by_width(d_in, d_out, route):
    """The streaming route only at projection widths (fewer 64-column tiles
    than SMs) of up to 1024 rows; qmatmul's kernel at vocab width and past
    1024 rows."""
    for m in (1, 8):
        plan = qk.qmm_plan(m, d_in, d_out, H100_SMS)
        assert (plan[2] == 0) == (route == "stream"), plan
        if route == "kernel":
            assert plan == qk.qmm_kernel_plan(m, d_in, d_out, H100_SMS)


def test_plan_splits_past_4096_rows():
    """Past 64 packed groups a block's bf16 rows would pass 64 KB: d_in
    splits even at vocab width, each block then taking its units in one
    pass."""
    grid_x, splits, warps = qk.qmm_plan(8, 8192, V_PAD, H100_SMS)
    assert splits == 2 and math.ceil(V_PAD // 32 / grid_x) <= warps
    assert _launch_ok(8, 8192, V_PAD, (grid_x, splits, warps))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_plan_covers_the_gate(fmt):
    """Every (d_in, d_out) ``supports`` admits, d_in up to 65,536, gets a
    route and grid whose launcher takes it, in every format and at every M
    it serves (Q5 at d_in 320, 640 or 1600, whose fifth-bit plane ends
    inside a stage's rows, included)."""
    for d_in in [64 * k for k in range(1, 26)] + [1024 * k for k in
                                                  (2, 3, 4, 8, 16, 64)]:
        for d_out in (128, 384, 1024, 2560, 3072, 6400, 8448, 8576, V_PAD):
            for m in range(1, 9):
                plan = qk.qmm_plan(m, d_in, d_out, H100_SMS)
                assert _launch_ok(m, d_in, d_out, plan, fmt), (
                    m, d_in, d_out, plan)
                kplan = qk.qmm_kernel_plan(m, d_in, d_out, H100_SMS)
                assert _launch_ok(m, d_in, d_out, kplan, fmt), (
                    m, d_in, d_out, kplan)


@pytest.mark.parametrize("d_in", [64, 128, 192, 320, 640, 768, 1024, 1600,
                                  4096])
def test_fifth_boxes_stay_in_the_plane(d_in):
    """Q5's fifth-bit boxes: the stage's sg * 32 packed rows in boxes of
    ``fifth_box`` rows, box r at plane row (row + r) % (d_in / 8), each box
    inside the plane and the boxes landing each packed row's plane row in
    its place, for every group and every stage size."""
    e8 = d_in // 8
    for sg in (1, 2, 4):
        fb = fifth_box(d_in, sg)
        assert fb >= 8 and (sg * 32) % fb == 0 and e8 % fb == 0
        for grp in range(0, d_in // 64, sg):
            row = grp * 32
            got = []
            for r in range(0, sg * 32, fb):
                start = (row + r) % e8
                assert start + fb <= e8
                got.extend(range(start, start + fb))
            assert got == [(row + r) % e8 for r in range(sg * 32)]


@pytest.mark.parametrize("m,d_in,d_out", [(0, 1024, 1024), (9, 1024, 1024),
                                          (1, 1000, 1024), (1, 1024, 1000),
                                          (1, 65536 + 64, 1024)])
def test_plan_refuses(m, d_in, d_out):
    """Rows outside 1..8, widths off the 64-row groups or the 32-column
    units, and d_in past 16 slices of 64 groups."""
    with pytest.raises(ValueError):
        qk.qmm_plan(m, d_in, d_out, H100_SMS)


def test_plan_constants_match_the_kernel():
    """The plan's limits are the launcher's (``csrc/qmatmul.cu``)."""
    src = KERNEL.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("QMM_UNIT") == qk.QMM_UNIT
    assert const("QMM_MAX_WARPS") == qk.QMM_MAX_WARPS
    assert const("QMM_MAX_SPLITS") == qk.STREAM_MAX_SPLITS
    assert const("QMM_MAX_SLICE_GROUPS") == qk.QMM_MAX_SLICE_GROUPS
    stream = (KERNEL.parent / "qgemv_stream.cuh").read_text()
    for name, value in (("STREAM_WARPS", qk.STREAM_WARPS),
                        ("STREAM_GPW", qk.STREAM_GPW),
                        ("STREAM_MAX_SPLITS", qk.STREAM_MAX_SPLITS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             stream).group(1)) == value
