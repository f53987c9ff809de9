"""The yardstick's arithmetic at BioGPT-347M against hand-reckoned values,
and the metrics' readers over made-up records: rates over whole windows,
tails over all requests, misses counted."""

import math
from types import SimpleNamespace

import pytest

from portbench import bounds as B
from portbench.devtrace import reduce
from portbench.run import reader
from portbench.stats import decode_positions, p95
from portbench.traffic import Req, Window

M347 = dict(d_model=1024, n_layer=24, n_head=16, d_ff=4096, n_vocab=42384,
            n_positions=1024, pos_offset=2)


def test_plane_and_weight_bytes_at_347m():
    assert B.q_bytes(1024, 1024, "q4_0") == 589_824        # 0.5625 B/weight
    assert B.q_bytes(1024, 1024, "q8_0") == 1_114_112      # 1.0625 B/weight
    assert B.q_bytes(1024, 3072, "q4_0") == 1_769_472
    assert B.q_bytes(4096, 1024, "q4_0") == 2_359_296
    # planes 7,077,888 + biases 36,864 + LayerNorms 16,384
    assert B.layer_bytes(M347, "q4_0") == 7_131_136
    # 24 layers, the final LayerNorm, the lm_head's 1024 x 42384 planes
    assert B.weight_bytes(M347, "q4_0") == 195_568_640
    assert B.weight_bytes(M347, "q8_0") == (
        24 * (12_582_912 * 17 // 16 + 53_248) + 8_192 + 46_113_792)


def test_flops_at_347m():
    # 2 x (24 x 12 d^2 + vocab d) + 4 x 24 x d x context
    assert B.token_flops(M347, 1) == 690_782_208 + 98_304
    assert B.token_flops(M347, 100, head=False) == 603_979_776 + 9_830_400
    for P, n in ((5, 1), (17, 40), (380, 96)):
        loop = (sum(B.token_flops(M347, c, head=c == P)
                    for c in range(1, P + 1))
                + sum(B.token_flops(M347, c) for c in range(P + 1, P + n)))
        assert B.request_flops(M347, P, n) == loop
    assert B.request_flops(M347, 10, 0) == 0


def test_least_times():
    assert B.bound_s(3.35e9, 0) == pytest.approx(1e-3)
    assert B.bound_s(0, 989e9) == pytest.approx(1e-3)
    nbytes, flops = B.decode_cost(M347, "q4_0", 1, [0])
    assert nbytes == 195_568_640 + 2 * 24 * 1024 * 2 + 2 * 1024 * 4 + 8
    # a slot at position 100 reads its 100 K and V rows of every layer
    nb100, _ = B.decode_cost(M347, "q4_0", 1, [100])
    assert nb100 - nbytes == 2 * 24 * 100 * 1024 * 2
    # 32 live slots share one read of the weights
    nb32, f32 = B.decode_cost(M347, "q4_0", 1, [100] * 32)
    assert nb32 == 195_568_640 + 32 * (nb100 - 195_568_640)
    assert f32 == 32 * B.token_flops(M347, 101)
    rb, rf = B.refill_cost(M347, "q4_0", [32, 5])
    assert rb == 195_568_640 + 2 * 24 * 37 * 1024 * 2 + 37 * 8
    assert rf == (24 * B.layer_flops(M347, 37) + 4 * 24 * 1024 * (528 + 15)
                  + 2 * 2 * 1024 * 42384)


def test_p95_nearest_rank_and_misses():
    assert p95(range(1, 101)) == 95
    assert p95([3.0]) == 3.0
    assert p95([]) is None
    xs = list(range(1, 20)) + [math.inf]       # rank 19 of 20: a value
    assert p95(xs) == 19
    assert p95(list(range(1, 19)) + [math.inf, math.inf]) is None


def req(P, n, t_due, t_first, t_last, greedy=True, done=True):
    r = Req(prompt=[5] * P, n_predict=n, greedy=greedy, t_due=t_due,
            t_first=t_first, t_last=t_last)
    r.new_ids = [7] * n if done else None
    return r


def fake_run(cell_kind, reqs, calls=(), **kw):
    w = Window(t0=0.0, t1=10.0, requests=list(reqs), calls=list(calls))
    w.counters0 = {"chunks_launched": 0}
    w.counters1 = {"chunks_launched": kw.pop("chunks", 0)}
    w.graphs0, w.graphs1 = {"captures": 3}, {"captures": kw.pop("caps", 3)}
    w.extra["backlog"] = kw.pop("backlog", [])
    return SimpleNamespace(
        window=w, model=M347, fmt="q4_0", setup_s=12.5,
        cfg={"engine": {"class": cell_kind, "chunk": 16}},
        span_ms=kw.pop("span_ms", {}), trace_summary=kw.pop("trace", None))


def read(name, run):
    return reader(name).read(run, name)


def test_rates_over_whole_windows():
    reqs = [req(10, 100, 0, 1, 2)] * 3 + [req(10, 300, 0, 1, 2)]
    run = fake_run("BatchedEngine", reqs, calls=[(0.0, 2.0), (2.0, 6.0)])
    assert read("gen_tokens_per_s", run) == pytest.approx(600 / 6.0)
    run = fake_run("Engine", reqs, calls=[(0.0, 0.5), (0.5, 1.5)])
    assert read("stream_ms_per_token", run) == pytest.approx(1500 / 600)
    assert read("setup_s", run) == 12.5
    flops = 3 * B.request_flops(M347, 10, 100) + B.request_flops(M347, 10, 300)
    assert read("mfu_pct.batch", run) == pytest.approx(
        100 * flops / (1.5 * 989e12))


def test_serving_mfu_over_the_spans_device_time():
    reqs = [req(10, 100, 0, 1, 2), req(300, 16, 0, 1, 2)]
    run = fake_run("BatchedEngine", reqs, span_ms={
        "refill": [(1.0, [10], -0.5), (3.0, [300], 1.0)],
        "chunk": [(4.0, None, 2.0), (2.0, None, 11.0)]})
    run.window.tail = [req(20, 32, 10.2, 11, 12)]
    flops = (B.request_flops(M347, 10, 100) + B.request_flops(M347, 300, 16)
             + B.request_flops(M347, 20, 32))
    # the span before the window's start is left out; the tail's are in
    assert read("mfu_pct.serve", run) == pytest.approx(
        100 * flops / (9e-3 * 989e12))
    run.window.tail = [req(20, 32, 10.2, 11, None, done=False)]
    assert read("mfu_pct.serve", run) is None


def test_tails_over_all_requests_with_misses():
    reqs = [req(5, 17, 0.0, 0.010 * (i + 1), 0.010 * (i + 1) + 0.032)
            for i in range(40)]
    run = fake_run("BatchedEngine", reqs)
    assert read("ttft_p95_ms", run) == pytest.approx(380.0)   # rank 38 of 40
    assert read("tpot_p95_ms", run) == pytest.approx(2.0)
    reqs[0] = req(5, 17, 0.0, None, None, done=False)
    reqs[1] = req(5, 17, 0.0, 0.5, 0.6, done=False)
    reqs[2] = req(5, 17, 0.0, 0.5, 0.6, done=False)
    run = fake_run("BatchedEngine", reqs)
    assert read("ttft_p95_ms", run) is None    # the rank falls on a miss


def test_span_readers():
    reqs = [req(10, 5, 0, 1, 2), req(20, 3, 0, 1, 2)]
    assert decode_positions(reqs) == [10, 11, 12, 13, 20, 21]
    spans = {"chunk": [(2.0, None, 1.0), (2.0, None, 2.0), (9.0, None, 11.0)],
             "refill": [(1.0, [10, 20], 0.5)]}
    run = fake_run("BatchedEngine", reqs, chunks=2, span_ms=spans)
    assert read("decode_device_ms_per_step.batch", run) == pytest.approx(
        4.0 / 32)
    least = B.bound_s(*B.decode_cost(M347, "q4_0", 32, decode_positions(reqs)))
    assert read("decode_roofline.batch", run) == pytest.approx(
        100 * least / 4e-3)
    assert read("refill_device_share_pct.serve", run) == pytest.approx(20.0)
    assert read("refill_roofline.serve", run) == pytest.approx(
        100 * B.bound_s(*B.refill_cost(M347, "q4_0", [10, 20])) / 1e-3)
    stream = fake_run("Engine", reqs, span_ms={"decode": [(3.0, 4, 1.0),
                                                          (3.0, 2, 1.5)]})
    assert read("decode_roofline.stream", stream) == pytest.approx(
        100 * B.bound_s(*B.decode_cost(M347, "q4_0", 6,
                                       decode_positions(reqs))) / 6e-3)
    assert read("decode_roofline.batch",
                fake_run("BatchedEngine", reqs)) is None


def test_counter_and_trace_readers():
    run = fake_run("BatchedEngine", [], caps=5, backlog=[0, 3, 7, 2],
                   trace={"busy_s": 0.75, "window_s": 2.0})
    assert read("window_captures.serve", run) == 2.0
    assert read("backlog_max.serve", run) == 7.0
    assert read("device_idle_pct.serve", run) == pytest.approx(62.5)
    assert read("device_idle_pct.batch", fake_run("BatchedEngine", [])) is None


def test_device_trace_reduction():
    ev = [("k1", 10, 20), ("k2", 15, 30), ("k1", 40, 50), ("k3", 70, 95)]
    host = [("chunk", 0, 35), ("refill", 30, 45)]
    out = reduce(ev, 0, 80, host)
    assert out["busy_s"] == pytest.approx(40e-9)    # union, clipped at 80
    assert out["window_s"] == pytest.approx(80e-9)
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    assert [g[0] for g in out["idle_gaps"]] == [
        "host outside the program's spans at +0.000 s", "chunk at +0.000 s",
        "refill at +0.000 s"]
    assert reduce([], 0, 80, host) is None
    assert reduce([("k", 100, 120)], 0, 80, host) is None
