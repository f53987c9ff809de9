"""The single-stream generation engine (``biogpt_tpu/runtime/engine.py``, B=1).

Prefill pads the prompt to a power-of-two bucket (floor 8) and runs the
per-op ``forward``; its quantized projections go through the GEMV kernels
(m <= 8: ``qmatmul``, 9..32: ``qmatmul_wide``) and larger buckets through
one dense product. Decode runs the fused whole-model step; greedy decode
adds the fused LN + lm_head + argmax tail where the lm_head is packed (the
4- and 5-bit formats), sampled decode, and greedy decode on an unpacked
Q8_0 lm_head (as in the JAX engine), the final LN, the lm_head GEMV and
the torch sampler or argmax. Every format has its CUDA kernels. ``kv_quant=True`` keeps the KV cache in int8 with
per-row scales (``runtime.cache.QuantKVCache``); the fused step then runs
in its int8 mode.

On a mesh (``mesh``, ``parallel.mesh.make_mesh``; one process per rank,
each holding its shard) the weights are TP-packed and sharded
(``parallel/tp.py``) and every forward runs the tensor-parallel one: the
prompt per op (sequence-parallel where its bucket divides the model
axis), and decode per op or, with ``tp_fused_decode``, through the TP
decode step's kernel halves with a bf16 (default) or int8 cache. Every
rank runs ``generate`` with the same arguments; the logits, and so the
tokens, are the same on every rank. ``pack_q4=False`` on a mesh (the JAX
package's GSPMD path) belongs to a later slice and raises.

``generate`` decodes in chunks of ``SCAN_LEN`` steps. The sampled token,
the token buffer, the EOS flag and the health bit stay on the device; the
host knows ``past`` as a Python int and reads the device once per chunk.
Steps after an EOS inside a chunk still run (their tokens are discarded at
the drain), where the JAX scan skipped them with a ``cond``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import BioGptConfig, GenerationParams
from ..device import resolve_device
from ..models.biogpt import (forward, forward_fused_decode,
                             forward_fused_decode_greedy)
from ..modelio.checkpoint import tree_map
from ..ops.decode_kernels import supports_layers
from ..ops.qmatmul_kernels import LANES, supports
from ..quant.layouts import QuantizedTensor, pack_nibble_planes
from .cache import KVCache, init_cache
from .sampling import greedy, sample_top_k_top_p


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _pack_matmul_weights(params: dict) -> dict:
    """Prepare quantized matmul weights for the kernels, as the JAX engine
    does: q/k/v fused into one (d_in, 3*d_model) projection, 4/5-bit levels
    nibble-packed, scale and min planes stored as bf16, and the lm_head's
    d_out lane-padded to a multiple of 128 with zero levels and scales.
    Embeddings stay row-major and unpacked (gather path)."""

    def maybe_pack(w, pad_out: bool = False):
        if not isinstance(w, QuantizedTensor) or w.packed:
            return w
        if pad_out and w.d_out % LANES != 0:
            pad = LANES - w.d_out % LANES
            w = w.map(lambda a: torch.nn.functional.pad(a, (0, pad)))
        if not supports(w, 1):
            return w
        w = pack_nibble_planes(w)
        return dataclasses.replace(
            w, scales=w.scales.to(torch.bfloat16),
            mins=w.mins.to(torch.bfloat16) if w.mins is not None else None)

    def fuse_qkv(layers: dict) -> dict:
        ws = [layers.get(n, {}).get("w") for n in ("q", "k", "v")]
        if not all(isinstance(w, QuantizedTensor) and not w.packed for w in ws):
            return layers
        qw, kw, vw = ws
        fused = QuantizedTensor(
            levels=torch.cat([qw.levels, kw.levels, vw.levels], dim=-1),
            scales=torch.cat([qw.scales, kw.scales, vw.scales], dim=-1),
            mins=(torch.cat([qw.mins, kw.mins, vw.mins], dim=-1)
                  if qw.mins is not None else None),
            qtype=qw.qtype)
        bias = torch.cat([layers[n]["b"] for n in ("q", "k", "v")], dim=-1)
        out = {k: v for k, v in layers.items() if k not in ("q", "k", "v")}
        out["qkv"] = {"w": fused, "b": bias}
        return out

    out = dict(params)
    out["lm_head"] = maybe_pack(params["lm_head"], pad_out=True)
    out["layers"] = {
        k: ({"w": maybe_pack(v["w"]), "b": v["b"]}
            if isinstance(v, dict) and isinstance(v.get("w"), QuantizedTensor)
            else v)
        for k, v in fuse_qkv(params["layers"]).items()}
    return out


def place_params(config: BioGptConfig, params: dict, pack_q4: bool, device,
                 mesh=None, tp_fused_decode: bool = False):
    """The engines' weights on their device -> (params, forward, device).
    Without a mesh: the kernels' packing (:func:`_pack_matmul_weights`,
    where ``pack_q4``) on ``device``, and ``models.biogpt.forward``. On a
    mesh (the JAX engines' mesh gates): TP-packed params sharded onto the
    rank's device, and the TP forward; a model the TP path cannot split,
    or unpacked weights (the JAX package's GSPMD path), raises."""
    if mesh is None:
        dev = resolve_device(device)
        if pack_q4:
            params = _pack_matmul_weights(params)
        return tree_map(lambda a: a.to(dev), params), forward, dev
    from ..parallel.tp import (make_tp_forward, pack_params_tp,
                               shard_params_tp, supports_tp)

    tp = mesh.model
    if not pack_q4 or not supports_tp(config, tp):
        raise NotImplementedError(
            "a mesh without the packed tensor-parallel path (pack_q4=False, "
            f"or a model that does not split over {tp} shards: the JAX "
            "package's GSPMD sharding) belongs to a later slice of the "
            "PyTorch port")
    params = shard_params_tp(pack_params_tp(params, tp), mesh)
    return (params, make_tp_forward(mesh, fused_decode=tp_fused_decode),
            mesh.device)


@dataclass
class GenerationResult:
    ids: List[int]
    prompt_len: int
    timings: dict = field(default_factory=dict)

    @property
    def new_ids(self) -> List[int]:
        return self.ids[self.prompt_len:]


class Engine:
    """Single-stream generation engine.

    ``compute_dtype``: torch.bfloat16 (default) or torch.float32 for
    parity work. ``cache_dtype`` defaults to bf16 when the fused decode step
    is live, else float16; ``kv_quant`` forces an int8 cache.
    ``causal=False`` keeps the reference's unmasked mode in every forward
    (each new token sees every real token written so far) and turns the
    fused decode step off, as in the JAX engine. ``device``
    defaults to "cuda" and raises without a card; the CPU runs every
    kernel's plain version. ``mesh`` / ``tp_fused_decode``: this rank's
    shard of a tensor-parallel engine (see the module docstring; the
    mesh's device is the engine's). ``health_check=False`` delivers the
    tokens of a generation whose logits went non-finite instead of raising
    ``ModelHealthError``.
    """

    SCAN_LEN = 64   # decode steps per chunk (one device read per chunk)

    def __init__(self, config: BioGptConfig, params: dict,
                 compute_dtype=torch.bfloat16, cache_dtype=None,
                 causal: bool = True,
                 max_seq: Optional[int] = None, pack_q4: bool = True,
                 kv_quant: bool = False, device="cuda", mesh=None,
                 tp_fused_decode: bool = False, health_check: bool = True):
        if kv_quant:
            if cache_dtype not in (None, torch.int8):
                raise ValueError("kv_quant forces an int8 cache")
            cache_dtype = torch.int8
        self.config = config
        self.compute_dtype = compute_dtype
        self.causal = causal
        self.max_seq = max_seq or config.n_positions
        self.allow_kernels = pack_q4
        # a tripped on-device finite bit fails the generation (the bit is
        # read with each chunk's tokens) unless the check is off
        self.health_check = health_check
        self.mesh = mesh
        self._tp_fused = mesh is not None and tp_fused_decode
        self.params, self._fwd, self.device = place_params(
            config, params, pack_q4, device, mesh, tp_fused_decode)
        self._fused_decode = (
            mesh is None and pack_q4 and causal
            and compute_dtype != torch.float32
            and cache_dtype in (None, torch.bfloat16, torch.int8)
            and supports_layers(self.params.get("layers", {}), torch.bfloat16,
                                batch=1, n_new=1))
        if cache_dtype is None:
            cache_dtype = (torch.bfloat16
                           if self._fused_decode or self._tp_fused
                           else torch.float16)
        self.cache_dtype = cache_dtype
        lm_head = self.params.get("lm_head")
        self._fused_greedy = (self._fused_decode
                              and isinstance(lm_head, QuantizedTensor)
                              and lm_head.packed and supports(lm_head, 1))

    # ------------------------------------------------------------ plumbing

    def _window(self, needed: int) -> int:
        """KV-attention window: the live length bucketed up (floor 128)."""
        return min(_bucket(needed, floor=128), self.max_seq)

    def warmup(self, prompt_len: int = 8, n_tokens: int = 4,
               sampled: bool = True) -> None:
        """Run the paths of a first request before it comes: two
        generations from a ``prompt_len``-token prompt (sampled when
        ``sampled``), then a greedy one when ``sampled``. On the card this
        builds the kernels' libraries and pays the first launches and the
        allocator's first requests."""
        gen = GenerationParams(n_predict=n_tokens, seed=0, stop_at_eos=False,
                               temp=0.8 if sampled else 0.0)
        prompt = list(range(2, 2 + prompt_len))
        self.generate(prompt, gen)
        self.generate(prompt, gen)
        if sampled:
            self.generate(prompt, dataclasses.replace(gen, temp=0.0))

    def new_cache(self, batch: int = 1, max_len: Optional[int] = None) -> KVCache:
        return init_cache(self.config, batch=batch,
                          max_len=max_len or self.max_seq,
                          dtype=self.cache_dtype, device=self.device,
                          tp=self.mesh.model if self.mesh is not None else 1)

    def prefill(self, cache: KVCache, token_ids):
        """Run the prompt through the model -> (logits (1, V), cache, n)."""
        ids = np.asarray(token_ids, dtype=np.int64).reshape(1, -1)
        n = ids.shape[1]
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq {self.max_seq}")
        padded = min(_bucket(n), self.max_seq)
        buf = np.zeros((1, padded), dtype=np.int64)
        buf[:, :n] = ids
        logits, cache = self._fwd(
            self.params, torch.from_numpy(buf).to(self.device), cache, 0,
            self.config, compute_dtype=self.compute_dtype, causal=self.causal,
            allow_kernels=self.allow_kernels, logits_mode="last",
            kv_window=self._window(padded), last_index=n - 1)
        return logits, cache, n

    def decode_step(self, cache: KVCache, token, past: int,
                    window: Optional[int] = None):
        """One-token decode -> (logits (1, V), cache). ``window`` (>= past+1)
        is the KV window, by default the bucket of past + 1."""
        tok = torch.as_tensor(token, device=self.device).reshape(1, 1).long()
        window = window or self._window(past + 1)
        if self._fused_decode:
            return forward_fused_decode(self.params, tok, cache, past,
                                        self.config,
                                        compute_dtype=self.compute_dtype,
                                        kv_window=window)
        return self._fwd(self.params, tok, cache, past, self.config,
                         compute_dtype=self.compute_dtype, causal=self.causal,
                         allow_kernels=self.allow_kernels, logits_mode="last",
                         kv_window=window)

    def _step(self, cache, tok, past: int, window: int, use_greedy: bool,
              gen, generator):
        """One decode step -> (next token (1,) int32, finite bit, cache)."""
        if use_greedy and self._fused_greedy:
            nxt, mv, cache = forward_fused_decode_greedy(
                self.params, tok, cache, past, self.config, kv_window=window)
            return nxt, torch.isfinite(mv).all(), cache
        logits, cache = self.decode_step(cache, tok, past, window)
        ok = torch.isfinite(logits).all()
        if use_greedy:
            return greedy(logits), ok, cache
        return sample_top_k_top_p(logits, generator, top_k=gen.top_k,
                                  top_p=gen.top_p, temp=gen.temp), ok, cache

    # ------------------------------------------------------------ generation

    def generate(self, prompt_ids: List[int],
                 gen: GenerationParams | None = None,
                 stream_cb: Optional[Callable[[int], None]] = None
                 ) -> GenerationResult:
        """Prefill + chunked decode. Streaming reads every token."""
        from .health import ModelHealthError

        gen = gen or GenerationParams()
        seed = gen.seed if gen.seed >= 0 else int(time.time())
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        use_greedy = gen.temp <= 0
        chunk = 1 if stream_cb is not None else self.SCAN_LEN

        limit = min(self.max_seq, self.config.n_positions)
        n_predict = min(gen.n_predict, limit - len(prompt_ids))
        ids = list(prompt_ids)
        if n_predict <= 0:
            return GenerationResult(ids=ids, prompt_len=len(prompt_ids))

        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda: None)
        t0 = time.perf_counter()
        cache = self.new_cache(batch=1)
        logits, cache, past = self.prefill(cache, ids)
        sync()
        t_prefill = time.perf_counter() - t0
        health = torch.isfinite(logits).all()

        td0 = time.perf_counter()
        if use_greedy:
            tok = greedy(logits)
        else:
            tok = sample_top_k_top_p(logits, generator, top_k=gen.top_k,
                                     top_p=gen.top_p, temp=gen.temp)
        eos = gen.eos_token_id if gen.stop_at_eos else -1
        done = tok[0] == eos

        # tokens land in a device buffer that the host reads once per chunk
        out_buf = torch.zeros(n_predict, dtype=torch.int32, device=self.device)
        out_buf[0:1] = tok
        queued, emitted, stopped, steps = 1, 0, False, 0

        def drain():
            nonlocal emitted, stopped
            vals = torch.cat([out_buf, health.to(torch.int32)[None]]).cpu()
            if self.health_check and int(vals[-1]) == 0:
                raise ModelHealthError(
                    "non-finite logits during generation (after "
                    f"{emitted} emitted tokens) -- corrupt checkpoint or "
                    "numerics bug; tokens withheld")
            while emitted < min(queued, n_predict) and not stopped:
                tid = int(vals[emitted])
                ids.append(tid)
                emitted += 1
                if stream_cb is not None:
                    stream_cb(tid)
                if gen.stop_at_eos and tid == gen.eos_token_id:
                    stopped = True

        td = time.perf_counter()
        if stream_cb is not None:
            drain()
        while queued < n_predict and not stopped:
            if stream_cb is None and bool(done):   # the chunk's one read
                break
            budget = min(chunk, n_predict - queued)
            # one KV window per chunk, as the JAX engine compiles one per scan
            window = self._window(past + queued + (budget if stream_cb else chunk))
            for _ in range(budget):
                tok, ok, cache = self._step(cache, tok.reshape(1, 1).long(),
                                            past + queued - 1, window,
                                            use_greedy, gen, generator)
                out_buf[queued:queued + 1] = tok
                health = health & ok
                done = done | (tok[0] == eos)
                queued += 1
                steps += 1
            if stream_cb is not None:
                drain()
        if stream_cb is None:
            drain()
        sync()
        t_decode = time.perf_counter() - td
        return GenerationResult(
            ids=ids, prompt_len=len(prompt_ids),
            timings={"prefill_s": t_prefill, "sample_s": td - td0,
                     "decode_s": t_decode, "n_new": len(ids) - len(prompt_ids),
                     "ms_per_token": t_decode / max(steps, 1) * 1e3})

    # -------------------------------------------------------------- scoring

    def logits(self, token_ids) -> torch.Tensor:
        """Full-sequence logits (B, N, V) f32 on the engine's device, from
        one forward over a fresh cache; a 1-D ``token_ids`` is one row."""
        ids = torch.as_tensor(np.asarray(token_ids, dtype=np.int64))
        if ids.dim() == 1:
            ids = ids[None, :]
        cache = self.new_cache(batch=ids.shape[0], max_len=ids.shape[1])
        logits, _ = self._fwd(self.params, ids.to(self.device), cache, 0,
                              self.config, compute_dtype=self.compute_dtype,
                              causal=self.causal,
                              allow_kernels=self.allow_kernels,
                              logits_mode="all")
        return logits.float()

    def score(self, token_ids, batch: bool = False) -> np.ndarray:
        """:meth:`logits` as numpy (B, N, V), for perplexity and parity
        tests. ``batch`` is the JAX engine's flag, which changes nothing
        there either: the rows come from the array's shape."""
        return self.logits(token_ids).cpu().numpy()
