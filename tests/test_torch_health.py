"""Failure detection and serving observability of the port
(``biogpt_tpu_torch/runtime/health.py``, ``runtime/metrics.py``, the
finite lanes of ``runtime/serving.py`` and ``runtime/engine.py``): the
counterparts of the JAX package's ``tests/test_health.py`` serving and
single-stream cases, on the same tiny model (its weights carried across by
``params_from_numpy``), on the CPU.
"""

import copy
import time

import numpy as np
import pytest
import torch

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.runtime import serving as serving_mod
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.health import DrainStallError, ModelHealthError
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

TINY = BioGptConfig.tiny()
CFG = TorchConfig.tiny()
GREEDY = GenerationParams(temp=0.0, stop_at_eos=False)


@pytest.fixture(scope="module")
def tiny_params():
    return params_from_state_dict(make_state_dict(TINY, seed=21), TINY)


def _poison(params):
    """Corrupt one FFN weight so every forward produces NaN logits."""
    bad = copy.deepcopy(params)
    w = np.array(bad["layers"]["fc1"]["w"], dtype=np.float32)
    w[..., 0] = np.nan
    bad["layers"]["fc1"]["w"] = w
    return bad


def _engine(params, **kw):
    return BatchedEngine(CFG, params_from_numpy(params, "cpu"), max_batch=2,
                         compute_dtype=torch.float32, chunk=4, device="cpu",
                         **kw)


def _single(params, **kw):
    return Engine(CFG, params_from_numpy(params, "cpu"),
                  compute_dtype=torch.float32, device="cpu", **kw)


def test_serve_detects_nonfinite_logits(tiny_params):
    be = _engine(_poison(tiny_params))
    reqs = [Request(prompt_ids=[2, 5, 9], n_predict=6, request_id=0)]
    with pytest.raises(ModelHealthError, match="chunk"):
        be.serve(reqs, GREEDY)
    assert be.metrics.snapshot()["health_failures"] >= 1


def test_health_check_off_does_not_raise(tiny_params):
    be = _engine(_poison(tiny_params), health_check=False)
    reqs = [Request(prompt_ids=[2, 5, 9], n_predict=6, request_id=0)]
    results = be.serve(reqs, GREEDY)
    assert len(results[0].new_ids) == 6   # garbage tokens, but delivered


def test_healthy_serve_does_not_trip(tiny_params):
    be = _engine(tiny_params)
    reqs = [Request(prompt_ids=[2, 5, 9], n_predict=6, request_id=0),
            Request(prompt_ids=[2, 7], n_predict=4, request_id=1)]
    results = be.serve(reqs, GREEDY)
    assert len(results) == 2
    assert be.metrics.snapshot()["health_failures"] == 0


def test_metrics_counters_track_a_serve(tiny_params):
    be = _engine(tiny_params)
    n_pred = [6, 4, 5]
    reqs = [Request(prompt_ids=[2, 5 + i], n_predict=n, request_id=i)
            for i, n in enumerate(n_pred)]
    results = be.serve(reqs, GREEDY)
    snap = be.metrics.snapshot()
    total = sum(len(r.new_ids) for r in results.values())
    assert total == sum(n_pred)
    assert snap["tokens_emitted"] == total
    assert snap["requests_accepted"] == 3
    assert snap["requests_completed"] == 3
    assert snap["chunks_launched"] >= 1
    assert snap["drains_landed"] == snap["chunks_launched"]
    assert snap["refill_programs"] >= 1
    assert snap["serve_calls"] == 1
    assert snap["last_serve"]["tokens"] == total
    assert snap["serve_wall_s"] > 0


def test_request_latency_metrics(tiny_params):
    """TTFT and end-to-end latency aggregates appear in the snapshot and
    are sane (ttft <= e2e <= the largest e2e)."""
    be = _engine(tiny_params)
    reqs = [Request(prompt_ids=[2, 5, 9], n_predict=6, request_id=0),
            Request(prompt_ids=[2, 7], n_predict=4, request_id=1)]
    be.serve(reqs, GREEDY)
    snap = be.metrics.snapshot()
    assert snap["ttft_mean_s"] > 0
    assert snap["e2e_mean_s"] >= snap["ttft_mean_s"]
    assert snap["e2e_max_s"] >= snap["e2e_mean_s"]


def test_metrics_accumulate_across_serves(tiny_params):
    be = _engine(tiny_params)
    for k in range(2):
        be.serve([Request(prompt_ids=[2, 5], n_predict=3, request_id=k)],
                 GREEDY)
    snap = be.metrics.snapshot()
    assert snap["serve_calls"] == 2
    assert snap["requests_completed"] == 2
    assert snap["tokens_emitted"] == 6


def test_watchdog_fires_on_stalled_drains(tiny_params, monkeypatch):
    """Drains that stop landing must raise DrainStallError, not hang: every
    chunk's host read (``_Fetch.numpy``) is stalled past the watchdog."""
    be = _engine(tiny_params, watchdog_s=0.5)
    real = serving_mod._Fetch.numpy

    def stalled(self):
        time.sleep(3.0)
        return real(self)

    monkeypatch.setattr(serving_mod._Fetch, "numpy", stalled)
    reqs = [Request(prompt_ids=[2, 5], n_predict=4, request_id=0)]
    with pytest.raises(DrainStallError, match="watchdog"):
        be.serve(reqs, GREEDY)


def test_engine_generate_detects_nonfinite(tiny_params):
    """The single-stream (CLI) path's finite lane: poisoned weights fail
    the generation before tokens are emitted, greedy and sampled."""
    eng = _single(_poison(tiny_params))
    with pytest.raises(ModelHealthError, match="non-finite"):
        eng.generate([2, 5, 9], GenerationParams(
            temp=0.0, n_predict=6, stop_at_eos=False))
    with pytest.raises(ModelHealthError, match="non-finite"):
        eng.generate([2, 5, 9], GenerationParams(
            temp=0.8, seed=3, n_predict=6, stop_at_eos=False))


def test_engine_generate_detects_nonfinite_streaming(tiny_params):
    eng = _single(_poison(tiny_params))
    seen = []
    with pytest.raises(ModelHealthError):
        eng.generate([2, 5, 9], GenerationParams(
            temp=0.0, n_predict=6, stop_at_eos=False), stream_cb=seen.append)
    assert seen == []   # tokens withheld, not delivered


def test_engine_health_off_delivers(tiny_params):
    eng = _single(_poison(tiny_params), health_check=False)
    res = eng.generate([2, 5, 9], GenerationParams(
        temp=0.0, n_predict=6, stop_at_eos=False))
    assert len(res.new_ids) == 6   # garbage tokens, but delivered
