"""One run of one cell of the benchmark of ``biogpt_tpu_torch`` (the
PyTorch and CUDA port) on the card:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout. Everything is found by name: the cell in
``BENCHMARK.json``, its traffic mix in ``portbench/workloads/<cell>.json``
(which names its kind, ``portbench/traffic/<kind>.py``), its configuration in
``portbench/configs/<config>.json`` with the plain reference it names
beside it, and each metric's reader in ``portbench/metrics/<name>.py``
(or, for ``<base>.<variant>``, ``portbench/metrics/<base>.py``).

A run: the seed's weights made on the card and loaded through the
program's own loader; the engine built and warmed up on the cell's own
shapes (set-up, ``setup_s``); the measured window; with ``--trace 1``
also the benchmark's spans around the engine's calls and a device trace
of a short sub-window after it; then, with the program's state freed,
the served tokens held against the reference (``check.py``).

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; a line before it holds the run's other readings (the graphs'
pool bytes, the peak memory, the card's power limit). Standard error
ends with the comparisons. Without a CUDA card, with fewer cards than
the cell asks for, or if JAX or the JAX package was loaded, it prints no
result and exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "biogpt_tpu")
TRACE_LEAD_S, TRACE_S = 0.5, 2.0   # the device trace's sub-window


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The metric's reader: ``metrics/<name>.py``, else the file of the
    part of its name before the first dot."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return load_file(path, f"portbench_metric_{stem}")
    raise FileNotFoundError(f"no reader for metric {name}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or its per-layer ones: those that
    list it, and those without a list that move a metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


class Run:
    """One run's inputs and, as it goes, its readings (the metrics'
    readers take it whole)."""

    def __init__(self, bench, cell, wl, cfg, seed, seconds, trace, device):
        self.bench, self.cell, self.wl, self.cfg = bench, cell, wl, cfg
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.fmt = cfg["weights"]
        self.model = {"d_model": cfg["hidden_size"],
                      "n_layer": cfg["num_hidden_layers"],
                      "n_head": cfg["num_attention_heads"],
                      "d_ff": cfg["intermediate_size"],
                      "n_vocab": cfg["vocab_size"],
                      "n_positions": cfg["max_position_embeddings"],
                      "pos_offset": cfg["position_offset"]}
        self.pcfg = self.params = None          # the program's config, weights
        self.window = self.spans = self.devtrace = None
        self.readers = {}          # metric name -> its reader module
        self.span_ms = {}          # span kind -> [(device ms, meta, host s)]
        self.trace_summary = None  # devtrace.reduce's reading, traced runs
        self.setup_s = 0.0
        self.setup_parts = {}


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    wl = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    return bench, cell, wl, cfg


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def setup(name: str, seed: int, seconds: float, trace: bool,
          device: str = "cuda", tweak=None):
    """The run's set-up: the seed's weights made on the device and loaded
    through the program's own loader, the engine built and warmed up on
    the cell's shapes -> (run, its seed's weights, traffic kind, session).
    ``tweak(cfg, wl)`` resizes the cell in place (the CPU tests' tiny
    runs)."""
    import torch

    from . import weights

    bench, cell, wl, cfg = load_cell(name)
    if tweak is not None:
        tweak(cfg, wl)
    dev = torch.device(device)
    run = Run(bench, cell, wl, cfg, seed, seconds, trace, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from biogpt_tpu_torch.config import BioGptConfig
    from biogpt_tpu_torch.modelio.checkpoint import params_from_records

    m = run.model
    marks = [T_START, time.perf_counter()]
    seedw = weights.make(m, run.fmt, seed, dev)
    marks.append(time.perf_counter())
    run.pcfg = BioGptConfig(
        n_vocab=m["n_vocab"], d_ff=m["d_ff"], d_model=m["d_model"],
        n_layer=m["n_layer"], n_head=m["n_head"],
        n_positions=m["n_positions"], pos_offset=m["pos_offset"])
    run.params = params_from_records(seedw.records(), run.pcfg)
    marks.append(time.perf_counter())
    kind = importlib.import_module(f"portbench.traffic.{wl['kind']}")
    sess = kind.build(run)
    run.params = None
    marks.append(time.perf_counter())
    kind.warm(run, sess)
    marks.append(time.perf_counter())
    run.setup_parts = dict(zip(
        ("start_s", "weights_s", "loader_s", "engine_s", "warmup_s"),
        (b - a for a, b in zip(marks, marks[1:]))))
    return run, seedw, kind, sess


def measure(run, kind, sess, t_start: float) -> dict:
    """The window (with ``run.trace`` also the benchmark's spans and the
    device trace's sub-window after it) -> the run's record; the readings
    land in ``run``."""
    import torch

    from .devtrace import DeviceTrace
    from .spans import SpanLog

    cuda = run.device.type == "cuda"
    eng = kind.engine(sess)
    metrics = cell_metrics(run.bench, run.cell["name"], run.trace)
    run.readers = {mt["name"]: reader(mt["name"]) for mt in metrics}
    bindings = {}
    for rd in run.readers.values():
        bindings.update(getattr(rd, "SPANS", {}).get(type(eng).__name__, {}))
    run.spans = SpanLog(run.device)
    run.devtrace = DeviceTrace(math.inf, TRACE_S, run.trace and cuda)
    run.spans.on_call = run.devtrace.tick
    if run.trace:
        run.spans.install(eng, bindings)
        if cuda:   # the profiler's first start sets up CUPTI: not in a window
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.cuda.synchronize()
    if cuda:
        torch.cuda.synchronize()
    w = run.window = kind.window(run, sess, dtrace=run.devtrace)
    run.setup_s = w.t0 - t_start
    if run.trace:
        if run.devtrace.start_s == math.inf:
            run.devtrace.start_s = time.perf_counter() + TRACE_LEAD_S
        kind.tail(run, sess, run.devtrace)
    if cuda:
        torch.cuda.synchronize()
    graphs = eng.graphs.stats()
    run.span_ms = run.spans.device_ms()
    run.trace_summary = run.devtrace.summary(run.spans.host_intervals())
    SpanLog.uninstall(eng, bindings)
    return {
        "cell": run.cell["name"], "seed": run.seed, "seconds": run.seconds,
        "trace": run.trace, "window_s": w.t1 - w.t0, "setup_s": run.setup_s,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else 0),
        "graph_pool_bytes": graphs["pool_bytes"],
        "graph_captures_in_window": (w.graphs1.get("captures", 0)
                                     - w.graphs0.get("captures", 0)),
        "graph_captures_after_window": (graphs["captures"]
                                        - w.graphs1.get("captures", 0)),
        "graphs": graphs["graphs"], "requests": len(w.requests),
        "calls": len(w.calls), "setup_parts": run.setup_parts,
        **{k: v for k, v in w.extra.items() if k != "backlog"},
    }


def judge(run, seedw, record: dict, sources=None) -> dict:
    """The served tokens against the reference, once the program's state
    is freed (not part of set-up) -> the verdict. ``sources(ref, seed)``
    -> more sources of tokens to judge beside the served ones (the
    control's and the faults', ``calibrate``): their numbers and verdicts
    land in ``record["others"]``."""
    from . import check

    ref_mod = load_file(HERE / "configs" / f"{run.cfg['reference']}.py",
                        "portbench_reference")
    t = time.perf_counter()
    ref = ref_mod.Reference(run.model, run.fmt, seedw.blocks, seedw.where,
                            seedw.dense, run.device)
    c = run.wl["check"]
    src = {"program": check.served}
    if sources is not None:
        src.update(sources(ref, run.seed))
    nums = check.compare(ref, check.picked(run.window.requests, run.seed, c),
                         src)
    del ref
    record["reference_s"] = time.perf_counter() - t
    record["compared"] = nums.pop("program")
    record["others"] = {
        k: dict(v, correct=check.verdict(run.window.requests, v, c)["correct"])
        for k, v in nums.items()}
    return check.verdict(run.window.requests, record["compared"], c)


def result_line(run, record: dict, verdict: dict) -> dict:
    """The result's JSON object: the cell's metrics that have a reading."""
    import torch

    cuda = run.device.type == "cuda"
    values = {}
    for mt in cell_metrics(run.bench, run.cell["name"], run.trace):
        v = run.readers[mt["name"]].read(run, mt["name"])
        if v is not None:
            values[mt["name"]] = {"value": v, "unit": mt["unit"]}
    w = run.window
    result = {
        "correct": verdict["correct"], "attempted": len(w.requests),
        "failed": sum(1 for r in w.requests if not r.done),
        "metrics": values,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": run.cell["chips"],
                   "memory_peak_bytes": record["memory_peak_bytes"]},
    }
    if run.trace and run.trace_summary is not None:
        result["device"]["busy_s"] = run.trace_summary["busy_s"]
        result["device"]["window_s"] = run.trace_summary["window_s"]
        result["breakdown"] = {k: run.trace_summary[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = verdict["checks"]
    return result


def free(kind, sess) -> None:
    """Close the session and give its device memory back."""
    import torch

    kind.close(sess)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tweak=None, sources=None,
             t_start: float = T_START) -> dict:
    """Run the cell once -> {"result": the result line's object,
    "record": the earlier line's}."""
    run, seedw, kind, sess = setup(name, seed, seconds, trace, device, tweak)
    record = measure(run, kind, sess, t_start)
    free(kind, sess)
    del sess
    if run.device.type == "cuda":
        record["card"] = power_limit()
    verdict = judge(run, seedw, record, sources)
    return {"result": result_line(run, record, verdict), "record": record}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside
    # the checkout
    build = ROOT / "build"
    os.environ["BIOGPT_TORCH_BUILD_DIR"] = str(build / "biogpt_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "portbench" / "triton")
    os.environ["USE_FLAX"] = "0"

    import torch

    _, cell, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps({"portbench_record": out["record"]}), flush=True)
    for k, (v, op, lim) in out["result"]["checks"].items():
        print(f"check {k}: {v!r} {op} {lim!r}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
