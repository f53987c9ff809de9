"""The port's bounds tool (``tools/kernel_bounds.py``), which ``PERF.md``'s
kernel table and ``chip_smoke.py`` take every kernel's bound from, and the
spin length of ``chip_smoke.py``'s device timer (``utils/profiling.py``):
the bytes it counts are the bytes the engines' planes hold, it has one
row per TPU kernel of the JAX package, and the batched steps' projection
rows add up to the step's parameters."""

import re
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import pack_nibble_planes, quantize_to_planes

from biogpt_tpu_torch.config import BioGptConfig
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.tools import kernel_bounds as kb
from biogpt_tpu_torch.utils import profiling
from biogpt_tpu_torch.utils.profiling import spin_cycles

QTYPES = {"q4_0": codecs.GGML_TYPE_Q4_0, "q4_1": codecs.GGML_TYPE_Q4_1,
          "q5_0": codecs.GGML_TYPE_Q5_0, "q5_1": codecs.GGML_TYPE_Q5_1,
          "q8_0": codecs.GGML_TYPE_Q8_0}
OPS = Path(__file__).resolve().parent.parent / "biogpt_tpu" / "ops"


@pytest.mark.parametrize("fmt", kb.FORMATS)
@pytest.mark.parametrize("d_in,d_out", [(256, 384), (1024, 3072)])
def test_q_bytes_equals_the_engines_planes(fmt, d_in, d_out):
    """q_bytes counts the planes as the engines prepare them: packed
    nibbles (and Q5's fifth-bit plane) or Q8_0's int8 levels, bf16 scales
    and mins."""
    rng = np.random.RandomState(d_in)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(d_out, d_in).astype(np.float32), QTYPES[fmt]))
    qt = qt._replace(
        scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
        mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
              if qt.mins is not None else None))
    t = params_from_numpy(qt, device="cpu")
    nbytes = sum(p.numel() * p.element_size()
                 for p in (t.levels, t.scales, t.mins) if p is not None)
    assert kb.q_bytes(d_in, d_out, fmt) == nbytes


def test_rows_hold_one_row_per_tpu_kernel():
    """Rows 1-15 of PERF.md's table, each replacing a function of the JAX
    package's ops at a line of its file; the JAX package has 15
    ``pl.pallas_call`` sites."""
    sites = sum(len(re.findall(r"pl\.pallas_call\(", f.read_text()))
                for f in OPS.glob("*.py"))
    assert sites == 15
    recs = kb.rows()
    assert sorted({r["row"] for r in recs}) == list(range(1, 16))
    for r in recs:
        path, line = r["replaces"].rsplit(":", 1)
        src = (OPS.parent.parent / path).read_text().splitlines()
        assert 1 <= int(line) <= len(src)
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")


@pytest.mark.parametrize("fmt", kb.FORMATS)
@pytest.mark.parametrize("m", [8, 16, 32])
def test_gemv_rows_sum_to_the_step(fmt, m):
    """The four projection sub-rows' parameters are one layer's planes,
    biases and LayerNorms (the batched step's weight bytes over L), and
    their operations the step's projections."""
    c = BioGptConfig()
    recs = kb.gemv_rows(c, M=m, fmt=fmt)
    assert [r["projection"] for r in recs] == list(kb.PROJECTIONS)
    assert sum(r["param_bytes"] for r in recs) == kb.layer_bytes(c, fmt)
    assert sum(r["flops"] for r in recs) == kb.layer_flops(c, m)
    for r in recs:
        assert r["bytes"] > r["param_bytes"] and r["bound_by"] == "bytes"


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_b1_gemv_rows_sum_to_the_step(fmt):
    """The B=1 step's four M=1 projection sub-rows: L times their
    parameters, with the live K/V rows, the new rows, x in and out and the
    position, are the bytes of the step's row (past 100), and L times
    their operations with attention's its operations."""
    c = BioGptConfig()
    L, D = c.n_layer, c.d_model
    recs = kb.gemv_rows(c, M=1, fmt=fmt)
    assert [r["kernel"] for r in recs] == ["decode_gemv_b1"] * 4
    assert [r["projection"] for r in recs] == list(kb.PROJECTIONS)
    step = next(r for r in kb.rows(c, fmt)
                if r["kernel"] == "decode_step_fused B=1")
    assert (L * sum(r["param_bytes"] for r in recs) + 2 * L * 100 * D * 2
            + 2 * L * D * 2 + 2 * D * 4 + 4) == step["bytes"]
    assert (L * sum(r["flops"] for r in recs) + 4 * L * 100 * D
            == step["flops"])
    for r in recs:
        assert r["bytes"] > r["param_bytes"] and r["bound_by"] == "bytes"


@pytest.mark.parametrize("fmt", kb.FORMATS)
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_gemv_rows_sum_to_the_step(fmt, tp):
    """One rank's four TP GEMV sub-rows: tp ranks' planes are the layer's
    planes and their operations the layer's projections; L times one
    rank's rows fit inside that rank's step (row 13)."""
    c = BioGptConfig()
    recs = kb.tp_gemv_rows(c, tp=tp, M=32, fmt=fmt)
    assert [r["projection"] for r in recs] == list(kb.PROJECTIONS)
    planes = sum(kb.q_bytes(*kb.projection_shape(c, n), fmt)
                 for n in kb.PROJECTIONS)
    assert tp * sum(r["plane_bytes"] for r in recs) == planes
    assert tp * sum(r["flops"] for r in recs) == kb.layer_flops(c, 32)
    step, _ = kb.tp_step_cost(c, kb.RAGGED_PAST, kb.WINDOW,
                              c.n_layer * kb.layer_bytes(c, fmt), tp)
    assert c.n_layer * sum(r["plane_bytes"] for r in recs) < step
    for r in recs:
        assert r["bytes"] > r["plane_bytes"] and r["bound_by"] == "bytes"


@pytest.mark.parametrize("fmt", kb.FORMATS)
@pytest.mark.parametrize("R,T", kb.PREFILL_SHAPES)
def test_prefill_sub_rows_sum_to_the_row(fmt, R, T):
    """Row 12's five parts (the four GEMMs and attention over all layers)
    sum to the row's bytes and operations at each refill shape."""
    c = BioGptConfig()
    recs = kb.prefill_sub_rows(c, R=R, T=T, fmt=fmt)
    assert [r["part"] for r in recs] == ["qkv", "attention", "o", "fc1",
                                         "fc2"]
    row = next(r for r in kb.rows(c, fmt) if r["kernel"] == "prefill_fused"
               and r["shape"] == f"R={R} prompts x T={T}")
    assert sum(r["bytes"] for r in recs) == row["bytes"]
    assert sum(r["flops"] for r in recs) == row["flops"]
    assert all(r["row"] == row["row"] == 12 for r in recs)


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_tail_sub_rows_sum_to_the_rows(fmt):
    """Rows 4 and 5 split into the lm_head GEMV and the KV commit, each
    pair summing to its row; the commit's part is row 10's bytes."""
    c = BioGptConfig()
    recs = kb.tail_sub_rows(c, fmt)
    rows = {r["row"]: r for r in kb.rows(c, fmt)}
    for n in (4, 5):
        parts = [r for r in recs if r["row"] == n]
        assert [r["part"] for r in parts] == ["lm_head GEMV", "KV commit"]
        assert sum(r["bytes"] for r in parts) == rows[n]["bytes"]
        assert sum(r["flops"] for r in parts) == rows[n]["flops"]
        assert parts[1]["bytes"] == rows[10]["bytes"]


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_prefill_gemm_cost_counts_its_planes(fmt):
    """The GEMM alone reads its planes and bias and the bf16 rows, and its
    operations are the projection's; at 1024 rows the four projections'
    operations are one layer's of row 12 at 32 x 32."""
    c = BioGptConfig()
    costs = [kb.prefill_gemm_cost(c, n, 1024, fmt) for n in kb.PROJECTIONS]
    for n, (nbytes, _) in zip(kb.PROJECTIONS, costs):
        d_in, d_out = kb.projection_shape(c, n)
        assert nbytes > kb.q_bytes(d_in, d_out, fmt) + 1024 * d_in * 2
    assert sum(f for _, f in costs) == kb.layer_flops(c, 1024)


def test_spin_covers_the_host():
    """Four times the host's enqueue time, 0.5 ms at least, 100 ms at
    most."""
    rate = 1.98e6   # cycles per ms at 1980 MHz
    assert spin_cycles(0.01, rate) == int(np.ceil(0.5 * rate))
    assert spin_cycles(1.5, rate) == int(np.ceil(6.0 * rate))
    assert spin_cycles(500.0, rate) == int(np.ceil(100.0 * rate))
    assert spin_cycles(1.5, rate) / rate > 1.5   # the spin covers the host
    with pytest.raises(ValueError):
        spin_cycles(-1.0, rate)


def test_timer_report_trace_and_memory_stats(tmp_path):
    """``Timer.report`` prints the JAX package's report for the same
    phases (totals, and ms a call past one call); ``trace`` writes a
    Chrome trace of the block; ``device_memory_stats`` is empty without a
    card and names each card's bytes with one."""
    from biogpt_tpu.utils.profiling import Timer as JaxTimer

    t, j = profiling.Timer(), JaxTimer()
    for timer in (t, j):
        for name, secs in (("decode", 0.25), ("decode", 0.5), ("load", 1.0)):
            timer.totals[name] += secs
            timer.counts[name] += 1
    assert t.report() == j.report()
    assert "750.00 ms" in t.report() and "over 2" in t.report()
    with t.phase("sum"):
        pass
    assert t.counts["sum"] == 1 and t.ms("sum") >= 0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with profiling.trace() as prof:   # no export without a directory
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert [p.name for p in tmp_path.iterdir()] == ["tr"]
    stats = profiling.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    else:
        assert set(stats["cuda:0"]) == {"bytes_in_use", "bytes_limit",
                                        "peak_bytes_in_use"}


class _Span:
    def __init__(self, start):
        self.start = start

    def elapsed_us(self):
        return 10.0


class _Event:
    def __init__(self, name, start):
        self.name, self.time_range = name, _Span(start)
        self.device_type = torch.autograd.DeviceType.CUDA


def test_kernel_trace_counts_only_the_window_it_keeps(monkeypatch):
    """``chip_smoke.py::kernel_trace`` takes a window again where the
    tracer returned no device record, which calls ``run`` again: the
    launch counts it hands back are those of the window it keeps, not the
    sum over the retakes (a retaken staged step once counted 192 GEMVs
    for 96)."""
    import importlib
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    chip_smoke = importlib.import_module("chip_smoke")
    from biogpt_tpu_torch.ops import cuda_lib

    windows = [[], [], [_Event("qgemv_mma_kernel", 5), _Event("x", 1)]]

    class FakeProfile:
        def __init__(self, activities):
            self.recs = windows.pop(0)

        def start(self):
            pass

        def stop(self):
            pass

        def events(self):
            return self.recs

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: None)
    monkeypatch.setitem(cuda_lib.LAUNCHES, "decode_gemv", 0)
    calls = []

    def run():
        calls.append(1)
        cuda_lib.LAUNCHES["decode_gemv"] += 96

    counted, seq = {}, []
    names = chip_smoke.kernel_trace(run, seq, counted)
    assert len(calls) == 3 and cuda_lib.LAUNCHES["decode_gemv"] == 288
    assert counted["decode_gemv"] == 96 and counted["prefill_gemm"] == 0
    assert names == {"qgemv_mma_kernel": [1, 0.01], "x": [1, 0.01]}
    assert [r[0] for r in seq] == ["x", "qgemv_mma_kernel"]


def test_port_kernel_names_find_every_kernel():
    """``chip_smoke.py::port_kernel_names`` names every ``__global__``
    function of the port's sources, past a ``__launch_bounds__`` of nested
    parentheses (``qmatmul_kernel``'s), with every kernel the script's
    route checks name among them; a ``__global__`` it cannot name fails
    the run."""
    import importlib
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    chip_smoke = importlib.import_module("chip_smoke")
    n_failures = len(chip_smoke.FAILURES)
    names = chip_smoke.port_kernel_names()
    assert len(chip_smoke.FAILURES) == n_failures
    assert set(chip_smoke.ROUTE_KERNELS) <= set(names)
    assert "__launch_bounds__" not in names
    text = ("__global__ void __launch_bounds__((W + 1) * 32, 1)\n"
            "k1(const __grid_constant__ M m, A a) {}\n"
            "template <int N> __global__ void k2(int* x) {}\n"
            "__global__ void __launch_bounds__(f(g(1), 2)) k3 (int y);")
    got = [chip_smoke.global_name(text, m.end())
           for m in re.finditer(r"__global__", text)]
    assert got == ["k1", "k2", "k3"]
    assert chip_smoke.global_name("__global__ void", 10) is None


def _engine_plane_bytes(qtype, d_in, d_out, seed):
    """The bytes of one (d_in, d_out) weight's planes as the engines prepare
    them: packed nibbles (and Q5's fifth-bit plane) or Q8_0's int8 levels,
    bf16 scales and mins."""
    rng = np.random.RandomState(seed)
    qt = pack_nibble_planes(quantize_to_planes(
        rng.randn(d_out, d_in).astype(np.float32), qtype))
    qt = qt._replace(
        scales=np.asarray(qt.scales).astype(ml_dtypes.bfloat16),
        mins=(np.asarray(qt.mins).astype(ml_dtypes.bfloat16)
              if qt.mins is not None else None))
    t = params_from_numpy(qt, device="cpu")
    return sum(p.numel() * p.element_size()
               for p in (t.levels, t.scales, t.mins) if p is not None)


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_wide_sub_rows_count_the_engines_planes(fmt):
    """Row 2's sub-rows (each projection and the lm_head, M = 16 and 32)
    read the planes the engines hold at those widths (a small config, so
    the planes are made here), x in and y out in f32; the M = 32 lm_head
    sub-row reads the plane and the rows the M=32 tail's GEMV reads
    (``tail_sub_rows``), which reads the LayerNorm's parameters besides
    and writes ids and winning logits instead of the logits."""
    c = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_vocab=300)
    V = -(-c.n_vocab // 128) * 128
    recs = kb.wide_sub_rows(c, fmt)
    assert [(r["shape"], r["m"]) for r in recs] == [
        (n, m) for n in kb.WIDE_SHAPES for m in (16, 32)]
    for r in recs:
        d_in, d_out = (int(w) for w in r["widths"].split(" -> "))
        assert (d_in, d_out) == ((c.d_model, V) if r["shape"] == "lm_head"
                                 else kb.projection_shape(c, r["shape"]))
        assert r["plane_bytes"] == _engine_plane_bytes(
            QTYPES[fmt], d_in, d_out, d_in + d_out)
        assert r["bytes"] == (r["plane_bytes"] + r["m"] * d_in * 4
                              + r["m"] * d_out * 4)
        assert r["flops"] == 2 * r["m"] * d_in * d_out and r["row"] == 2
    c = BioGptConfig()
    V, D = -(-c.n_vocab // 128) * 128, c.d_model
    lm32 = next(r for r in kb.wide_sub_rows(c, fmt)
                if (r["shape"], r["m"]) == ("lm_head", 32))
    gemv = next(r for r in kb.tail_sub_rows(c, fmt)
                if r["row"] == 4 and r["part"] == "lm_head GEMV")
    assert (lm32["bytes"] - 32 * V * 4
            == gemv["bytes"] - 2 * D * 4 - 32 * 8)
    assert lm32["flops"] == gemv["flops"]


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_small_tail_rows_count_the_engines_planes(fmt):
    """Row 3 at M = 1 and 8 and the sampled tail's GEMV: the lm_head planes
    as the engines hold them (a small config), and at BioGPT-347M the M = 1
    greedy sub-row is row 3 itself."""
    c = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_vocab=300)
    V = -(-c.n_vocab // 128) * 128
    recs = kb.small_tail_rows(c, fmt)
    assert [(r["row"], r["m"]) for r in recs] == [(3, 1), (5, 1), (3, 8),
                                                   (5, 8)]
    for r in recs:
        assert r["plane_bytes"] == _engine_plane_bytes(QTYPES[fmt], 128, V,
                                                       7)
        into = r["plane_bytes"] + r["m"] * 128 * 4 + 2 * 128 * 4
        out = (r["m"] * 8 if r["row"] == 3
               else r["m"] * V * 4 + r["m"] * (V // 128) * 4)
        assert r["bytes"] == into + out
    c = BioGptConfig()
    row3 = next(r for r in kb.rows(c, fmt) if r["row"] == 3)
    m1 = kb.small_tail_rows(c, fmt)[0]
    assert (m1["bytes"], m1["flops"]) == (row3["bytes"], row3["flops"])


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_attn_sub_rows_with_the_projections_sum_to_the_step(fmt):
    """Rows 7, 8, 9, 14 and 15: L times the four projections' parameters,
    the attention sub-row and x in and out are the step's bytes, and L
    times the projections' operations with the attention's are its
    operations; a sub-row is one launch a layer."""
    c = BioGptConfig()
    L, D, B = c.n_layer, c.d_model, len(kb.RAGGED_PAST)
    params = L * sum(r["param_bytes"] for r in kb.gemv_rows(c, M=32, fmt=fmt))
    flops = L * sum(r["flops"] for r in kb.gemv_rows(c, M=B, fmt=fmt))
    steps = {(r["row"], r["shape"]): r for r in kb.rows(c, fmt)}
    subs = kb.attn_sub_rows(c)
    assert [r["row"] for r in subs] == [7, 8, 9, 14, 15]
    for sub in subs:
        step = next(r for (row, shape), r in steps.items()
                    if row == sub["row"] and "B=32" in shape)
        assert params + sub["bytes"] + 2 * B * D * 4 == step["bytes"]
        assert flops + sub["flops"] == step["flops"]
        assert sub["launches"] == L and sub["bound_by"] == "bytes"
        assert sub["bound_ms"] < step["bound_ms"]


def test_attn_call_cost_is_one_layer_of_the_step():
    """One ``batched_attention`` call: a layer's share of the step's
    attention bytes with its qkv rows in and context rows out."""
    c = BioGptConfig()
    past, W = kb.RAGGED_PAST, kb.WINDOW
    B, D, L = len(past), c.d_model, c.n_layer
    for int8 in (False, True):
        step, step_flops = kb.attn_cost(c, past, W, int8)
        one, flops = kb.attn_call_cost(c, past, W, int8)
        assert L * (one - B * 4 * D * 4) == step - B * 4 + L * B * 4
        assert L * flops == step_flops


@pytest.mark.parametrize("fmt", kb.FORMATS)
def test_qmatmul_sub_rows_count_the_engines_planes(fmt):
    """Row 1's sub-rows (each projection and the lm_head, M = 1 and 8) read
    the planes the engines hold at those widths (a small config), x in and
    y out in f32; at BioGPT-347M the M = 1 lm_head sub-row is row 1."""
    c = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_vocab=300)
    V = -(-c.n_vocab // 128) * 128
    recs = kb.qmatmul_sub_rows(c, fmt)
    assert [(r["shape"], r["m"]) for r in recs] == [
        (n, m) for n in kb.WIDE_SHAPES for m in (1, 8)]
    for r in recs:
        d_in, d_out = (int(w) for w in r["widths"].split(" -> "))
        assert (d_in, d_out) == ((c.d_model, V) if r["shape"] == "lm_head"
                                 else kb.projection_shape(c, r["shape"]))
        assert r["plane_bytes"] == _engine_plane_bytes(
            QTYPES[fmt], d_in, d_out, d_in + 3 * d_out)
        assert r["bytes"] == (r["plane_bytes"] + r["m"] * d_in * 4
                              + r["m"] * d_out * 4)
        assert r["flops"] == 2 * r["m"] * d_in * d_out and r["row"] == 1
    c = BioGptConfig()
    row1 = next(r for r in kb.rows(c, fmt) if r["row"] == 1)
    lm1 = next(r for r in kb.qmatmul_sub_rows(c, fmt)
               if (r["shape"], r["m"]) == ("lm_head", 1))
    assert (lm1["bytes"], lm1["flops"]) == (row1["bytes"], row1["flops"])


def test_commit_quant_sub_rows_read_the_f32_rows():
    """Row 11 with the quantization folded in reads the step's f32 rows
    where the int8-row entry (row 11 itself) reads int8 rows and their
    scales; both write the same levels and scales; the single stream's
    position comes from the host."""
    c = BioGptConfig()
    D, L = c.d_model, c.n_layer
    row11 = next(r for r in kb.rows(c) if r["row"] == 11)
    fused = {r["B"]: r for r in kb.commit_quant_sub_rows(c)}
    assert set(fused) == {32, 1} and all(r["row"] == 11
                                         for r in fused.values())
    assert (fused[32]["bytes"] - row11["bytes"]
            == 2 * L * 32 * D * 4 - 2 * L * 32 * (D + 4))
    assert fused[1]["bytes"] == 2 * L * D * 4 + 2 * L * (D + 4)
    assert fused[32]["bound_by"] == "bytes" and fused[32]["flops"] == 0
    assert fused[32]["bound_ms"] == pytest.approx(
        fused[32]["bytes"] / kb.HBM_BYTES_PER_S * 1e3)
