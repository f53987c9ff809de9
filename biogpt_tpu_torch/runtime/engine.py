"""The single-stream generation engine (``biogpt_tpu/runtime/engine.py``, B=1).

Prefill pads the prompt to a power-of-two bucket (floor 8) and runs the
per-op ``forward``; its quantized projections go through the GEMV kernels
(m <= 8: ``qmatmul``, 9..32: ``qmatmul_wide``) and larger buckets through
one dense product. The prompt and its last position reach the device in
one copy, and the forward is one body over static tensors: on the card,
without a mesh, a (cache dtype, bucket, KV window) key's third prefill
into the engine's own cache is captured as a CUDA graph and later ones
replay it (a cold process's single prefill runs eagerly). Scoring
(``logits``, ``score``: the JAX engine's one jitted step) is such a body
too, its fresh cache allocated inside it, under the key (cache dtype,
causal, rows, length): perplexity's full windows replay one graph, its
last, shorter window runs eagerly. Decode runs
the fused whole-model step; greedy decode
adds the fused LN + lm_head + argmax tail where the lm_head is packed (the
4- and 5-bit formats), sampled decode, and greedy decode on an unpacked
Q8_0 lm_head (as in the JAX engine), the final LN, the lm_head GEMV and
the torch sampler or argmax. Every format has its CUDA kernels. ``kv_quant=True`` keeps the KV cache in int8 with
per-row scales (``runtime.cache.QuantKVCache``); the fused step then runs
in its int8 mode.

On a mesh (``mesh``, ``parallel.mesh.make_mesh``; one process per rank,
each holding its shard) the weights take one of two routes, by the JAX
engine's gates (:func:`place_params`). With ``pack_q4`` and a model that
splits over the model axis they are TP-packed and sharded
(``parallel/tp.py``) and every forward runs the tensor-parallel one: the
prompt per op (sequence-parallel where its bucket divides the model
axis), and decode per op or, with ``tp_fused_decode``, through the TP
decode step's kernel halves with a bf16 (default) or int8 cache.
Otherwise (``pack_q4=False``, or heads, widths or scale blocks the model
axis does not divide: the JAX package's GSPMD route) the unpacked weights
are sharded where their planes divide and whole elsewhere
(``parallel/sharding.py``), and the per-op forward runs without a kernel.
Every rank runs ``generate`` with the same arguments; the logits, and so
the tokens, are the same on every rank. ``generate`` (B=1) runs whole on
every replica of a data axis, with no collective over it; ``score`` of B
rows runs each replica's own rows where the data axis divides B.

``generate`` decodes in chunks of ``SCAN_LEN`` steps, the JAX engine's
``decode_scan``. The token, the position (a (1,) device tensor, JAX's
``past_dev``), the EOS flag, the health bit and the sampling parameters
live in the engine's own device tensors (:meth:`Engine._decode_state`),
and so does the B=1 KV cache, reused by every generation (prefill writes
rows ``[0, padded)``; every read stops below the position). A chunk of
``budget`` steps runs as the bodies of its binary decomposition
(``runtime.graphs.binary_chunks``: 64, 32, ..., 1 steps), each through
``runtime.graphs.ChunkGraphs``: on the card, on every single-device route
(the fused step with a bf16 or int8 cache, and the per-op step: an f16
cache, f32 compute, unpacked weights), a body of one (cache dtype, greedy
or sampled, top_k, KV window, steps) runs eagerly twice, then becomes a
CUDA graph of the chunk's launches, captured once and replayed (a one-off
generation's chunks pay no capture; :meth:`Engine.warmup` captures the
first window's); the mesh routes run every body eagerly (the mesh's
collectives are gloo's).
Sampled chunks draw from the engine's generator, reseeded by each
generation. The host reads the device once per chunk (``bool(done)``);
streaming runs one-step bodies and reads every token. Steps after an EOS
inside a chunk still run (their tokens are discarded at the drain), where
the JAX scan skipped them with a ``cond``; no body steps past the cache,
where JAX's last chunk over-generates into clamped writes.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
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
from .cache import KVCache, clear_cache, init_cache
from .graphs import ChunkGraphs, binary_chunks
from .sampling import greedy, sample_top_k_top_p


def _host(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as the source of a copy to ``device``: pinned for the
    card, so that the copy does not wait for the work already queued."""
    t = torch.from_numpy(a)
    return t.pin_memory() if device.type == "cuda" else t


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


@dataclass
class Placement:
    """The engines' weights on their device (:func:`place_params`):
    ``route`` is None without a mesh, "tp" for the packed tensor-parallel
    route, "sharded" for the route of unpacked weights (the JAX package's
    GSPMD route); ``kv_shards`` is the model-axis shards of the KV cache's
    features (1: whole)."""
    params: dict
    forward: Callable
    device: torch.device
    route: Optional[str] = None
    kv_shards: int = 1


def place_params(config: BioGptConfig, params: dict, pack_q4: bool, device,
                 mesh=None, tp_fused_decode: bool = False) -> Placement:
    """The engines' weights on their device, by the JAX engines' gates.
    Without a mesh: the kernels' packing (:func:`_pack_matmul_weights`,
    where ``pack_q4``) on ``device``, and ``models.biogpt.forward``. On a
    mesh, where ``pack_q4`` and the model splits over the model axis
    (``parallel.tp.supports_tp``): TP-packed params sharded onto the
    rank's device, and the TP forward. On a mesh otherwise: the unpacked
    weights' shards (``parallel/sharding.py``), and a forward that runs no
    kernel."""
    if mesh is None:
        dev = resolve_device(device)
        if pack_q4:
            params = _pack_matmul_weights(params)
        return Placement(tree_map(lambda a: a.to(dev), params), forward, dev)
    from ..parallel.tp import (make_tp_forward, pack_params_tp,
                               shard_params_tp, supports_tp)

    tp = mesh.model
    if pack_q4 and supports_tp(config, tp):
        params = shard_params_tp(pack_params_tp(params, tp), mesh)
        return Placement(params,
                         make_tp_forward(mesh, fused_decode=tp_fused_decode),
                         mesh.device, "tp", tp)
    from ..parallel.sharding import (make_sharded_forward, shard_layout,
                                     shard_params)

    layout = shard_layout(params, config, mesh)
    return Placement(shard_params(params, mesh, layout),
                     make_sharded_forward(mesh, layout), mesh.device,
                     "sharded", tp if layout.heads else 1)


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
    ``ModelHealthError``. An engine runs one generation at a time: its
    cache and decode state are its own.
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
        # a tripped on-device finite bit fails the generation (the bit is
        # read with each chunk's tokens) unless the check is off
        self.health_check = health_check
        self.mesh = mesh
        placed = place_params(config, params, pack_q4, device, mesh,
                              tp_fused_decode)
        self.params, self._fwd, self.device = (placed.params, placed.forward,
                                               placed.device)
        self._kv_shards = placed.kv_shards
        self._tp_fused = placed.route == "tp" and tp_fused_decode
        # the sharded route of unpacked weights runs no kernel, as the JAX
        # engine's allow_pallas is off on its GSPMD route
        self.allow_kernels = pack_q4 and placed.route != "sharded"
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
        self.generator = torch.Generator(device=self.device)
        # prefill and the decode chunks as CUDA graphs on the card, on every
        # route without a mesh (a mesh's collectives are gloo's)
        self.graphs = ChunkGraphs(self.device, self.generator,
                                  capture=self.mesh is None)
        self._cache: Optional[KVCache] = None
        self._state: Optional[SimpleNamespace] = None
        self._prefill_bufs: dict = {}   # padded -> the prefill's inputs
        self._score_bufs: dict = {}     # a captured scoring key's tensors

    # ------------------------------------------------------------ plumbing

    def _window(self, needed: int) -> int:
        """KV-attention window: the live length bucketed up (floor 128)."""
        return min(_bucket(needed, floor=128), self.max_seq)

    def warmup(self, prompt_len: int = 8, n_tokens: int = 4,
               sampled: bool = True, top_k: int = 40) -> None:
        """Run the paths of a first request before it comes: three
        generations from a ``prompt_len``-token prompt (the first two
        sampled when ``sampled``, the last greedy). On the card this builds
        the kernels' libraries and pays the first launches and the
        allocator's first requests; on the graph route (no mesh) the third
        prefill of that prompt's key is captured and replayed, and the
        decode chunks of the first KV window (128) are captured: 64, 32,
        ..., 1 steps, greedy and, when ``sampled``, sampled with
        ``top_k``, each run until its graph has replayed once."""
        gen = GenerationParams(n_predict=n_tokens, seed=0, stop_at_eos=False,
                               temp=0.8 if sampled else 0.0, top_k=top_k)
        prompt = list(range(2, 2 + prompt_len))
        for _ in range(ChunkGraphs.EAGER_RUNS):
            self.generate(prompt, gen)
        self.generate(prompt, dataclasses.replace(gen, temp=0.0))
        if not self.graphs.capture:
            return
        st, window = self._decode_state(), self._window(prompt_len + 1)
        for use_greedy in (True, False) if sampled else (True,):
            for n in binary_chunks(2 * self.SCAN_LEN - 1, self.SCAN_LEN):
                if prompt_len + n > window:
                    continue
                for _ in range(ChunkGraphs.EAGER_RUNS + 1):
                    st.pos.fill_(prompt_len)
                    self._run_steps(self._gen_cache(), st, n, window,
                                    use_greedy, top_k)

    def _rows(self, batch: int) -> tuple:
        """This replica's rows [lo, hi) of a batch (all of them without a
        mesh, or where the data axis does not divide the batch)."""
        return (self.mesh.batch_rows(batch) if self.mesh is not None
                else (0, batch))

    def new_cache(self, batch: int = 1, max_len: Optional[int] = None) -> KVCache:
        """A zeroed cache of this rank's rows of ``batch`` (:meth:`_rows`)
        and its features' shard."""
        lo, hi = self._rows(batch)
        return init_cache(self.config, batch=hi - lo,
                          max_len=max_len or self.max_seq,
                          dtype=self.cache_dtype, device=self.device,
                          tp=self._kv_shards)

    def _gen_cache(self) -> KVCache:
        """The engine's own B=1 cache, reused by every generation: its
        graphs hold its addresses. Prefill writes rows ``[0, padded)``,
        and every read stops below the position."""
        if self._cache is None:
            self._cache = self.new_cache(batch=1)
        return self._cache

    def _decode_state(self) -> SimpleNamespace:
        """The decode chunks' state on the device, at fixed addresses: the
        token, the position, the EOS flag, the health bit, the EOS id,
        temp and top_p, and the token ring of a chunk's steps."""
        if self._state is None:
            dev = self.device
            i32 = dict(dtype=torch.int32, device=dev)
            f32 = dict(dtype=torch.float32, device=dev)
            self._state = SimpleNamespace(
                tok=torch.zeros(1, **i32), pos=torch.zeros(1, **i32),
                done=torch.zeros(1, dtype=torch.bool, device=dev),
                health=torch.ones(1, dtype=torch.bool, device=dev),
                eos=torch.zeros(1, **i32), temp=torch.ones(1, 1, **f32),
                top_p=torch.ones(1, 1, **f32),
                ring=torch.zeros(self.SCAN_LEN, **i32))
        return self._state

    def _prefill_buffers(self, padded: int) -> SimpleNamespace:
        """The prefill body's static tensors for prompts padded to
        ``padded``: its input block (the prompt ``ids`` (1, padded), then
        the last real position ``last`` (1,)), filled by one copy a
        prefill, and its logits (1, V)."""
        buf = self._prefill_bufs.get(padded)
        if buf is None:
            ints = torch.zeros(padded + 1, dtype=torch.int64,
                               device=self.device)
            buf = SimpleNamespace(
                ints=ints, ids=ints[:padded].view(1, padded),
                last=ints[padded:],
                logits=torch.zeros(1, self.config.n_vocab,
                                   dtype=torch.float32, device=self.device))
            self._prefill_bufs[padded] = buf
        return buf

    def prefill(self, cache: KVCache, token_ids):
        """Run the prompt through the model -> (logits (1, V), cache, n).
        The prompt and its last position go to the device in one copy; the
        forward is one body over static tensors, run through the engine's
        graph runner under the key (cache dtype, padded length, KV window):
        on the card a CUDA graph's replay once the key has run eagerly,
        where ``cache`` is the engine's own (:meth:`_gen_cache`; any other
        cache runs the body directly)."""
        ids = np.asarray(token_ids, dtype=np.int64).reshape(1, -1)
        n = ids.shape[1]
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq {self.max_seq}")
        padded = min(_bucket(n), self.max_seq)
        window = self._window(padded)
        buf = self._prefill_buffers(padded)
        host = np.zeros(padded + 1, dtype=np.int64)
        host[:n] = ids[0]
        host[padded] = n - 1
        buf.ints.copy_(_host(host, self.device), non_blocking=True)

        def body():
            logits, _ = self._fwd(
                self.params, buf.ids, cache, 0, self.config,
                compute_dtype=self.compute_dtype, causal=self.causal,
                allow_kernels=self.allow_kernels, logits_mode="last",
                kv_window=window, last_index=buf.last)
            buf.logits.copy_(logits)

        self.graphs.run(("prefill", self.cache_dtype, padded, window), body,
                        capture=cache is self._cache)
        return buf.logits.clone(), cache, n

    def decode_step(self, cache: KVCache, token, past,
                    window: Optional[int] = None):
        """One-token decode -> (logits (1, V), cache). ``past``: the host's
        int or a (1,) integer tensor on the device; ``window`` (>= past+1)
        is the KV window, by default the bucket of past + 1 (a host int
        ``past`` only)."""
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

    def _step(self, cache, tok, past, window: int, use_greedy: bool,
              top_k: int, st):
        """One decode step at the device position ``past`` -> (next token
        (1,) int32, finite bit); samples with ``st``'s temp and top_p."""
        if use_greedy and self._fused_greedy:
            nxt, mv, _ = forward_fused_decode_greedy(
                self.params, tok, cache, past, self.config, kv_window=window)
            return nxt, torch.isfinite(mv).all()
        logits, _ = self.decode_step(cache, tok, past, window)
        ok = torch.isfinite(logits).all()
        if use_greedy:
            return greedy(logits), ok
        return sample_top_k_top_p(logits, self.generator, top_k=top_k,
                                  top_p=st.top_p, temp=st.temp), ok

    def _run_steps(self, cache, st, n: int, window: int, use_greedy: bool,
                   top_k: int) -> None:
        """``n`` decode steps from ``st`` (token, position) into
        ``st.ring[:n]``, the EOS flag and the health bit, in place: one
        run of their body through the runner (a graph's replay once the
        key has run eagerly; the module docstring)."""
        def body():
            tok = st.tok
            for i in range(n):
                nxt, ok = self._step(cache, tok.reshape(1, 1).long(), st.pos,
                                     window, use_greedy, top_k, st)
                st.ring[i:i + 1].copy_(nxt)
                # bitwise ops, as the sampler's mask: a cold process
                # pays the first launch of every kernel it has not run
                st.health &= ok
                st.done |= nxt == st.eos
                st.pos.add_(1)
                tok = nxt
            st.tok.copy_(tok)

        key = ("b1", self.cache_dtype, use_greedy,
               None if use_greedy else top_k, window, n)
        self.graphs.run(key, body, sampled=not use_greedy)

    # ------------------------------------------------------------ generation

    def generate(self, prompt_ids: List[int],
                 gen: GenerationParams | None = None,
                 stream_cb: Optional[Callable[[int], None]] = None
                 ) -> GenerationResult:
        """Prefill + chunked decode. Streaming reads every token."""
        from .health import ModelHealthError

        gen = gen or GenerationParams()
        seed = gen.seed if gen.seed >= 0 else int(time.time())
        self.generator.manual_seed(seed)
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
        cache = self._gen_cache()
        logits, cache, past = self.prefill(cache, ids)
        sync()
        t_prefill = time.perf_counter() - t0

        td0 = time.perf_counter()
        st = self._decode_state()
        st.health.copy_(torch.isfinite(logits).all().reshape(1))
        st.temp.fill_(gen.temp)
        st.top_p.fill_(gen.top_p)
        st.eos.fill_(gen.eos_token_id if gen.stop_at_eos else -1)
        if use_greedy:
            tok = greedy(logits)
        else:
            tok = sample_top_k_top_p(logits, self.generator, top_k=gen.top_k,
                                     top_p=st.top_p, temp=st.temp)
        st.tok.copy_(tok)
        st.pos.fill_(past)
        st.done.copy_(tok == st.eos)

        # tokens land in a device buffer that the host reads once per chunk
        out_buf = torch.zeros(n_predict, dtype=torch.int32, device=self.device)
        out_buf[0:1] = tok
        queued, emitted, stopped, steps, finite = 1, 0, False, 0, True

        def drain():
            nonlocal emitted, stopped, finite
            vals = torch.cat([out_buf, st.health.to(torch.int32)]).cpu()
            finite = int(vals[-1]) != 0
            if self.health_check and not finite:
                # the reused cache keeps no non-finite row for a later read
                clear_cache(cache)
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
            if stream_cb is None and bool(st.done):   # the chunk's one read
                break
            budget = min(chunk, n_predict - queued)
            # one KV window per chunk, as the JAX engine compiles one per scan
            window = self._window(past + queued + (budget if stream_cb else chunk))
            for n in binary_chunks(budget, self.SCAN_LEN):
                self._run_steps(cache, st, n, window, use_greedy, gen.top_k)
                out_buf[queued:queued + n] = st.ring[:n]
                queued += n
                steps += n
            if stream_cb is not None:
                drain()
        if stream_cb is None:
            drain()
        if not finite:
            clear_cache(cache)
        sync()
        t_decode = time.perf_counter() - td
        return GenerationResult(
            ids=ids, prompt_len=len(prompt_ids),
            timings={"prefill_s": t_prefill, "sample_s": td - td0,
                     "decode_s": t_decode, "n_new": len(ids) - len(prompt_ids),
                     "ms_per_token": t_decode / max(steps, 1) * 1e3})

    # -------------------------------------------------------------- scoring

    def _score(self, token_ids) -> torch.Tensor:
        """The logits (B, N, V) of :meth:`logits` in the scoring body's
        static tensor (the next call of the same shape overwrites it); on
        a data axis that divides B gathered over the replicas."""
        ids = np.asarray(token_ids, dtype=np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, N = ids.shape
        lo, hi = self._rows(B)
        key = ("score", self.cache_dtype, self.causal, B, N)
        # the body's tensors: the ids block, filled by one copy a call, and
        # the (rows, N, V) f32 logits; kept only once a graph holds them
        buf = self._score_bufs.get(key)
        if buf is None:
            buf = SimpleNamespace(
                ids=torch.empty(hi - lo, N, dtype=torch.int64,
                                device=self.device),
                logits=torch.empty(hi - lo, N, self.config.n_vocab,
                                   dtype=torch.float32, device=self.device))
        buf.ids.copy_(_host(np.ascontiguousarray(ids[lo:hi]), self.device),
                      non_blocking=True)

        def body():
            cache = self.new_cache(batch=B, max_len=N)
            logits, _ = self._fwd(self.params, buf.ids, cache, 0, self.config,
                                  compute_dtype=self.compute_dtype,
                                  causal=self.causal,
                                  allow_kernels=self.allow_kernels,
                                  logits_mode="all")
            buf.logits.copy_(logits)

        self.graphs.run(key, body)
        if key in self.graphs.graphs:
            self._score_bufs[key] = buf
        if hi - lo < B:
            return self.mesh.gather_data(buf.logits)
        return buf.logits

    def logits(self, token_ids) -> torch.Tensor:
        """Full-sequence logits (B, N, V) f32 on the engine's device, from
        one forward over a fresh cache; a 1-D ``token_ids`` is one row. The
        ids reach the device in one copy and the forward, its fresh cache
        allocated inside it, is one body over static tensors, run through
        the engine's graph runner under the key (cache dtype, causal, B,
        N): on the card without a mesh a CUDA graph's replay once the key
        has run eagerly (the JAX engine's one jitted step); the logits are
        copied out of the body's tensor. On a data axis that divides B
        each replica runs its own rows and the logits are gathered over the
        replicas once."""
        return self._score(token_ids).clone()

    def score(self, token_ids, batch: bool = False) -> np.ndarray:
        """:meth:`logits` as numpy (B, N, V), for perplexity and parity
        tests. ``batch`` is the JAX engine's flag, which changes nothing
        there either: the rows come from the array's shape."""
        return self._score(token_ids).cpu().numpy()
