"""Whole runs of every cell at a tiny size on the CPU (the kernels' plain
versions), the faults that must turn ``correct`` false, the refusal
without a card, and the import rule."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run as R
from tiny import CELLS, tweak, tweak_deep

ROOT = Path(R.__file__).resolve().parent.parent


def tiny_run(cell, trace=False, seed=20251019, deep=False):
    return R.run_cell(cell, seed, 0.6, trace, device="cpu",
                      tweak=tweak_deep if deep else tweak)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_of_each_cell(cell):
    out = tiny_run(cell)
    res, rec = out["result"], out["record"]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in R.cell_metrics(bench, cell, False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert rec["compared"]["tokens"] >= 4
    assert list(res)[-1] == "checks"


def test_traced_tiny_run_reads_no_device_number_off_the_card():
    res = tiny_run("q4_0.serve.mixed", trace=True)["result"]
    assert res["correct"]
    # host counters read; nothing from a device trace or device spans
    assert set(res["metrics"]) == {"backlog_max.serve",
                                   "window_captures.serve"}
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_same_seed_same_work():
    """The same seed gives the same weights, requests and served greedy
    tokens (how many calls fit the window is the clock's)."""
    def first_call(seed):
        run, _, kind, sess = R.setup("q4_0.batch32.decode", seed, 0.1,
                                     False, "cpu", tweak)
        R.measure(run, kind, sess, 0.0)
        return [(r.prompt, r.new_ids) for r in run.window.requests[:8]]
    assert first_call(7) == first_call(7)
    assert first_call(7) != first_call(8)


# ---- faults of the timed path: each must come out as not correct

VOCAB = 512   # tiny.tweak_deep's vocabulary


def fault_token(real):
    """Every slot's first token of each chunk altered where it is made."""
    def run_chunk(self, *a, **k):
        cache, vec = real(self, *a, **k)
        vec = vec.clone()
        vec[self.B:2 * self.B] = (vec[self.B:2 * self.B] + 1) % VOCAB
        return cache, vec
    return run_chunk


def fault_state(real):
    """A chunk that leaves the KV cache as it found it."""
    def run_chunk(self, *a, **k):
        c = self._pool_cache()
        k0, v0 = c.k.clone(), c.v.clone()
        out = real(self, *a, **k)
        c.k.copy_(k0)
        c.v.copy_(v0)
        return out
    return run_chunk


def fault_half(real):
    """Half of the batch (the odd slots) left out of every step: their
    tokens stay what they were."""
    def run_chunk(self, st, *a, **k):
        before = st.toks.clone()
        cache, vec = real(self, st, *a, **k)
        vec = vec.clone()
        ring = vec[self.B:self.B + self.chunk * self.B].view(self.chunk,
                                                              self.B)
        ring[:, 1::2] = before[1::2]
        return cache, vec
    return run_chunk


def test_the_deep_tiny_cells_pass_unbroken():
    for cell in CELLS:
        out = tiny_run(cell, deep=True)
        assert out["result"]["correct"], out["record"]["compared"]


@pytest.mark.parametrize("cell", ["q4_0.batch32.decode", "q4_0.serve.mixed"])
@pytest.mark.parametrize("fault", [fault_token, fault_state, fault_half])
def test_faults_of_the_batched_engine_fail(monkeypatch, cell, fault):
    from biogpt_tpu_torch.runtime.serving import BatchedEngine

    monkeypatch.setattr(BatchedEngine, "_run_chunk",
                        fault(BatchedEngine._run_chunk))
    out = tiny_run(cell, deep=True)
    assert not out["result"]["correct"], out["record"]["compared"]


def stream_fault_token(real):
    def run_steps(self, cache, st, n, *a, **k):
        real(self, cache, st, n, *a, **k)
        st.ring[:n] = (st.ring[:n] + 1) % VOCAB
    return run_steps


def stream_fault_state(real):
    def run_steps(self, cache, *a, **k):
        k0, v0 = cache.k.clone(), cache.v.clone()
        real(self, cache, *a, **k)
        cache.k.copy_(k0)
        cache.v.copy_(v0)
    return run_steps


@pytest.mark.parametrize("cell", ["q8_0.stream.sampled", "q8_0.stream.greedy"])
@pytest.mark.parametrize("fault", [stream_fault_token, stream_fault_state])
def test_faults_of_the_stream_engine_fail(monkeypatch, cell, fault):
    from biogpt_tpu_torch.runtime.engine import Engine

    monkeypatch.setattr(Engine, "_run_steps", fault(Engine._run_steps))
    out = tiny_run(cell, deep=True)
    assert not out["result"]["correct"], out["record"]["compared"]


def sampler_argmax(real):
    """The sampler takes each row's best token whatever was asked."""
    def sample(logits, *a, **k):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample


def sampler_no_top_k(real):
    """The sampler draws from the top-p nucleus of the whole vocabulary."""
    def sample(logits, generator, *a, **k):
        if "top_k" in k and not isinstance(k["top_k"], torch.Tensor):
            return real(logits, generator, **dict(k, top_k=VOCAB))
        top_k, top_p, temp = a[:3]
        return real(logits, generator, torch.full_like(top_k, VOCAB),
                    top_p, temp, *a[3:], **dict(k, max_top_k=VOCAB,
                                                 gmax=None))
    return sample


@pytest.mark.parametrize("cell,module,name", [
    ("q8_0.stream.sampled", "engine", "sample_top_k_top_p"),
    ("q4_0.serve.mixed", "serving", "sample_per_request")])
@pytest.mark.parametrize("fault", [sampler_argmax, sampler_no_top_k])
def test_sampler_faults_fail(monkeypatch, cell, module, name, fault):
    import importlib

    mod = importlib.import_module(f"biogpt_tpu_torch.runtime.{module}")
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    out = tiny_run(cell, deep=True)
    assert not out["result"]["correct"], out["record"]["compared"]


# ---- no card, no result; the import rule

def _run_main(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "q4_0.batch32.decode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_card_no_result():
    p = _run_main(ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_main(tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_import_rule():
    files = list((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & set(R.FORBIDDEN), f
    ref = ROOT / "portbench" / "configs" / "biogpt_ref.py"
    assert _imports(ref) <= {"__future__", "math", "typing", "numpy", "torch"}


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "from tiny import tweak; from portbench import run as R;"
            "out = R.run_cell('q4_0.serve.mixed', 3, 0.4, True, "
            "device='cpu', tweak=tweak);"
            "print(out['result']['correct'], R.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["True", "[]"]
