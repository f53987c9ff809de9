"""Build and load the port's CUDA kernels (``biogpt_tpu_torch/csrc``).

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes``: every pointer
and the stream pass as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Libraries build on first use into ``build/biogpt_tpu_torch/`` at the root
of the checkout (``BIOGPT_TORCH_BUILD_DIR`` overrides it), named by a hash
of the sources, so an edited kernel rebuilds and an unchanged one loads at
once. Nothing builds while a module is imported. :func:`build_all` starts
one ``nvcc`` per source at the same time.

``LAUNCHES`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else. ``decode_gemv`` counts the
tensor-core GEMV's launches: one per call of its own wrapper, and the
number the batched, paged and staged steps' C entries report launching;
``decode_gemv_b1`` likewise the single-stream step's M=1 GEMV,
``prefill_gemm`` the refill kernel's wgmma GEMM (4 L a ``prefill_fused``
call), and ``batched_attention`` the batched steps' attention kernel (L a
batched, paged or staged step, and one a call of its own wrapper).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

# kernel library -> source file
SOURCES = {
    "qmatmul": "qmatmul.cu",
    "lm_head_argmax": "lm_head_argmax.cu",
    "decode_step": "decode_step.cu",
    "decode_batched": "decode_batched.cu",
    "decode_paged": "decode_paged.cu",
    "kv_commit": "kv_commit.cu",
    "prefill": "prefill.cu",
    "decode_tp": "decode_tp.cu",
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: (library, function) -> argtypes; all return int. The
# weight-reading entry points take the level format (4, 5 or 8) after the
# level offset.
SIGNATURES = {
    ("qmatmul", "bgt_qmatmul"): [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                 _P],
    ("qmatmul", "bgt_qmatmul_splits"): [_I],
    ("qmatmul", "bgt_qmatmul_wide"): [_P] * 4 + [_I] * 7 + [_P, _P],
    ("lm_head_argmax", "bgt_lm_head_argmax"): (
        [_P, _P, _P, _F, _P, _P, _P] + [_I] * 9 + [_P] * 7),
    ("lm_head_argmax", "bgt_lm_head_logits_gmax"): (
        [_P, _P, _P, _F, _P, _P, _P] + [_I] * 8 + [_P] * 5),
    ("decode_step", "bgt_decode_head_dim"): [],
    ("decode_step", "bgt_decode_step"): (
        [_P] + [_I] * 7 + [_P, _F, _I, _I] + [_P] * 4
        + [_P] * 16 + [_P] * 6 + [_P] * 3 + [_P] + [_P]),
    ("decode_step", "bgt_decode_gemv_b1"): (
        [_P, _I, _I, _P, _P, _F, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P]),
    ("decode_batched", "bgt_decode_batched"): (
        [_P] + [_I] * 8 + [_P, _F, _I, _I] + [_P] * 4
        + [_P] * 16 + [_P] * 6 + [_P] * 4 + [_I] * 3 + [_P] * 2 + [_P]),
    ("decode_batched", "bgt_decode_gemv"): (
        [_P, _I, _I, _I, _P, _P, _F, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P,
         _P]),
    ("decode_paged", "bgt_decode_paged"): (
        [_P] + [_I] * 8 + [_P, _F, _I, _I] + [_P] * 4
        + [_P] * 16 + [_P] * 6 + [_P] * 3 + [_I] * 5 + [_P] * 2 + [_P] * 3
        + [_P]),
    ("decode_paged", "bgt_batched_attention"): (
        [_P] + [_I] * 5 + [_P] + [_I] * 3 + [_P] * 4 + [_I] * 2 + [_P] * 5
        + [_P]),
    ("kv_commit", "bgt_kv_commit"): [_P, _P, _P, _P, _LL, _LL, _P, _I, _I, _I,
                                     _I, _P],
    ("kv_commit", "bgt_kv_commit_quant"): (
        [_P] * 6 + [_LL, _LL, _P, _P, _LL, _LL, _P] + [_I] * 4 + [_P]),
    ("prefill", "bgt_prefill"): (
        [_P] + [_I] * 6 + [_F, _I, _I] + [_P] * 4 + [_P] * 16 + [_P] * 6
        + [_P] + [_P]),
    ("prefill", "bgt_prefill_gemm"): (
        [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _F,
         _P]),
    ("decode_tp", "bgt_tp_attn"): (
        [_P] + [_I] * 10 + [_P, _F, _I, _I] + [_P] * 2 + [_P] * 4 + [_P] * 3
        + [_P] * 4 + [_P] * 3 + [_P] * 6 + [_P]),
    ("decode_tp", "bgt_tp_qkv"): (
        [_P] + [_I] * 6 + [_F, _I, _I] + [_P] * 2 + [_P] * 4 + [_P] * 3
        + [_P]),
    ("decode_tp", "bgt_tp_ffn"): (
        [_P] + [_I] * 5 + [_F, _I, _I] + [_P] * 2 + [_P] * 4 + [_P] * 3
        + [_P] * 3 + [_P]),
}

LAUNCHES = {"qmatmul": 0, "qmatmul_wide": 0, "lm_head_argmax": 0,
            "decode_step_fused": 0, "decode_step_fused_batched": 0,
            "kv_commit": 0, "lm_head_argmax_commit": 0,
            "lm_head_logits_gmax_commit": 0, "prefill_fused": 0,
            "decode_step_fused_int8": 0, "decode_step_fused_batched_int8": 0,
            "kv_commit_quant": 0, "decode_step_fused_paged": 0,
            "decode_step_fused_paged_int8": 0, "decode_step_fused_staged": 0,
            "tp_attn_half": 0, "tp_attn_half_int8": 0, "tp_qkv_half": 0,
            "tp_ffn_half": 0, "decode_gemv": 0, "decode_gemv_b1": 0,
            "prefill_gemm": 0, "batched_attention": 0}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    env = os.environ.get("BIOGPT_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "biogpt_tpu_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out, cmd, time.perf_counter()


def _finish_build(job) -> float:
    """Wait for a build -> its seconds."""
    _, proc, tmp, out, cmd, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(names=None) -> dict:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together -> {library: seconds its nvcc took}."""
    with _LOCK:
        jobs = [j for j in (_start_build(n) for n in (names or SOURCES)) if j]
        done = {}   # library -> its seconds, or the build's error

        def finish(job):   # one waiting thread per build: each its own time
            try:
                done[job[0]] = _finish_build(job)
            except RuntimeError as e:
                done[job[0]] = e
        waiters = [threading.Thread(target=finish, args=(j,)) for j in jobs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        errors = [str(v) for v in done.values() if isinstance(v, Exception)]
        if errors:
            raise RuntimeError("\n".join(errors))
        return done


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for (lname, fn), argtypes in SIGNATURES.items():
        if lname == name:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
