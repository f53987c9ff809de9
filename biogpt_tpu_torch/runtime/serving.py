"""Continuous-batching serving engine (``biogpt_tpu/runtime/serving.py``).

A fixed pool of B cache slots decodes in lockstep with per-slot positions;
finished slots are refilled from the request queue without stopping the
batch. All per-slot state -- positions, sampled tokens, sampling
parameters, the first tokens of fresh refills -- lives on the device; the
host drains one token block per chunk and schedules refills.

As in the JAX package:
  - the lockstep step runs the fused decode step (2 <= B <= 32, bf16 or
    int8 KV) and then, when every bound request is greedy and no live
    intake can add a sampled one, the fused LN + lm_head + argmax tail
    (with the KV commit folded in on a bf16 cache); else, on a bf16 cache,
    the fused LN + lm_head + group-maxima + KV-commit tail and the
    per-request sampler (``sampling.sample_per_request``), and on an int8
    cache the commit, the final LN, the lm_head GEMV and the sampler.
    Without the fused step (f32 compute, unpacked weights) it runs the
    per-op forward.
  - refills that arrive together prefill as one batched forward per
    prompt-length group, sample each request's first token and merge into
    their slots. Where the fused step runs on the card, a group whose shape
    passes ``supports_prefill`` runs the whole-prompt kernel
    (``forward_prefill_fused``); the rest run the per-op forward with
    ``allow_kernels=False``, as the JAX package does. On the CPU the
    refills run the per-op forward unless ``_prefill_fused`` is set, as the
    JAX package keeps its refill kernel off in interpret mode.
  - ``kv_quant=True`` keeps the slots' KV in int8 with per-row scales
    (``runtime.cache.QuantKVCache``): the step runs in its int8 mode, the
    refills quantize their rows, and the merge moves levels and scales.
  - ``kv_groups`` keeps only its scheduling role: ``assign_slots`` packs
    requests of similar final length into the same slot group. The CUDA
    step reads each slot's own live rows, so there is no grouped read.
  - ``paged_kv=True`` runs the paged step (each slot walks its own live KV
    blocks), bf16 or int8, at every B from 1: the greedy tail as above, the
    sampled step through ``forward_fused_decode`` with its commit (the
    sampled tail fusion is off), and no slot groups.
  - ``staged_kv=True`` (a bf16 cache, B > 1, not paged; else it runs
    unstaged, as in the JAX package) collects each chunk's new KV rows in a
    (L, B, chunk, D) staging pair that the staged step attends to, samples
    from its logits, and commits the staging once per chunk at each slot's
    chunk-start position, the start clamped as ``dynamic_update_slice``
    clamps (``cache.write_block``).

The JAX ``step_scan`` (one dispatch per chunk) is a Python loop of
``chunk`` steps here: the steps enqueue on the current CUDA stream without
a host read, and each chunk ends with one copy of its (chunk, B) token ring
into pinned host memory behind a CUDA event. Drain threads wait on that
event only, never on the device. The caches are updated in place.

On a mesh (``mesh``; one process per rank, each holding its shard, every
rank calling ``serve`` with the same requests -- ``runtime.dist_serving``
keeps them so) the single-device fused step, its greedy and sampled tails,
paged and staged KV and the refill kernel are off, and the weights take
the engine's routes (``engine.place_params``): with ``pack_q4`` and a
model that splits over the model axis, TP-packed and sharded, every
forward the tensor-parallel one (``parallel/tp.py``): refills per op
(sequence-parallel where the bucket divides the model axis), the lockstep
step per op or, with ``tp_fused_decode``, through the TP decode step's
kernel halves, with a bf16 cache by default; otherwise the unpacked
weights' shards and the per-op forward without a kernel
(``parallel/sharding.py``).

The data axis: where it divides B, a replica holds and steps only its own
B / data slots (``Mesh.batch_rows``): their KV, positions, tokens and
sampling parameters. Every rank keeps the whole host state. A replica
prefills only the members of each refill group whose slots it owns
(joining nothing if it owns none); after the wave one data-axis gather of
the replicas' first tokens, a (B,) vector, puts every first token on
every rank. A chunk's steps exchange nothing over the data axis (a slot's
next input token is its replica's own); at its end one gather of the
(chunk, B / data) token rings and the health bits builds the drain vector
(first tokens, the (chunk, B) ring, the bits ANDed). The sampler draws
every row's random numbers for the whole batch and keeps its own rows, so
a replica draws what the single-device engine draws for those slots.
Where the data axis does not divide B every replica runs the whole batch.
``decision_sync`` replicates one rank's slot-freeing decisions (see
``serve``). A pool of B=1 runs the per-op step unless it is paged: the
lockstep fused step takes per-slot device positions from B=2 on, the
paged one at every B.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import BioGptConfig, GenerationParams
from ..models.biogpt import (forward_fused_decode,
                             forward_fused_decode_greedy,
                             forward_fused_decode_sampled,
                             forward_fused_decode_staged,
                             forward_prefill_fused)
from ..ops.decode_kernels import supports_layers
from ..ops.prefill_kernels import supports_prefill
from ..ops.qmatmul_kernels import supports, supports_wide
from ..quant.layouts import QuantizedTensor
from .cache import KVCache, init_cache, merge_rows, write_block
from .engine import _bucket, place_params
from .health import DrainStallError, ModelHealthError
from .metrics import ServingMetrics
from .sampling import greedy, sample_per_request, skip_rows


@dataclass
class Request:
    prompt_ids: List[int]
    n_predict: int = 64
    request_id: int = 0
    # per-request sampling (None -> inherit the serve() defaults)
    temp: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None


@dataclass
class RequestResult:
    request_id: int
    ids: List[int] = field(default_factory=list)    # prompt + generated
    prompt_len: int = 0

    @property
    def new_ids(self) -> List[int]:
        return self.ids[self.prompt_len:]


def _to_device(values, dtype, device: torch.device) -> torch.Tensor:
    """Host values as a tensor on ``device``; on the card through pinned
    memory without waiting for the stream (a pageable copy would wait for
    every chunk already queued)."""
    t = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _Fetch:
    """A chunk's drain vector on its way to the host: on the card, copied
    into pinned memory behind an event recorded on the launching stream."""

    def __init__(self, vec: torch.Tensor):
        self.event = None
        if vec.is_cuda:
            self.host = torch.empty(vec.shape, dtype=vec.dtype,
                                    pin_memory=True)
            self.host.copy_(vec, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vec.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()   # this chunk's copy only
        return self.host.numpy()


@dataclass
class _Slots:
    """Per-slot device state of this replica's own slots (all B without a
    data axis that divides B): last tokens, positions, the first tokens of
    fresh refills, sampling parameters; and every slot's first token."""
    toks: torch.Tensor       # (B_local,) int32
    lengths: torch.Tensor    # (B_local,) int32
    first_buf: torch.Tensor  # (B_local,) int32
    temps: torch.Tensor      # (B_local,) f32
    top_ps: torch.Tensor     # (B_local,) f32
    top_ks: torch.Tensor     # (B_local,) int32
    # (B,) int32: every slot's first token, the replicas' first_bufs
    # gathered; first_buf itself where the replica owns every slot
    firsts: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.firsts is None:
            self.firsts = self.first_buf


class BatchedEngine:
    """Lockstep batched decode over B slots with continuous refill."""

    MAX_TOP_K = 64   # candidates of the per-request sampler
    # padded prompt tokens one more refill prefill group must save
    REFILL_SPLIT_COST = 512

    def __init__(
        self,
        config: BioGptConfig,
        params,
        max_batch: int = 8,
        compute_dtype=torch.bfloat16,
        cache_dtype=None,
        max_seq: Optional[int] = None,
        chunk: int = 16,
        pack_q4: bool = True,
        pipeline: int = 2,
        mesh=None,
        kv_quant: bool = False,
        paged_kv: Optional[bool] = None,
        staged_kv: bool = False,
        health_check: bool = True,
        watchdog_s: Optional[float] = None,
        tp_fused_decode: bool = False,
        kv_groups: Optional[int] = None,
        device="cuda",
    ):
        self.config = config
        self.B = max_batch
        self.compute_dtype = compute_dtype
        self.max_seq = max_seq or config.n_positions
        self.chunk = chunk
        # health_check gates whether a tripped on-device finite bit fails
        # the serve; watchdog_s (None = off) bounds how long launched
        # chunks may go undrained before DrainStallError
        self.health_check = health_check
        self.watchdog_s = watchdog_s
        self.metrics = ServingMetrics()
        # undrained chunks the host may run ahead of the drain threads
        self.pipeline = max(1, pipeline)
        self.mesh = mesh
        placed = place_params(config, params, pack_q4, device, mesh,
                              tp_fused_decode)
        params, self._fwd, self.device = (placed.params, placed.forward,
                                          placed.device)
        self._kv_shards = placed.kv_shards
        self._tp_fused = placed.route == "tp" and tp_fused_decode
        # this replica's own slots [_lo, _lo + B_local): B / data where the
        # data axis divides B, else every slot
        self._lo, hi = (mesh.batch_rows(self.B) if mesh is not None
                        else (0, self.B))
        self.B_local = hi - self._lo
        # a sampled step's draws: the whole batch's, this replica's rows kept
        self._step_rows = ((self.B, slice(self._lo, hi))
                           if self.B_local < self.B else None)
        if kv_quant:
            if cache_dtype not in (None, torch.int8):
                raise ValueError("kv_quant forces an int8 cache")
            cache_dtype = torch.int8
        self._fused_decode = (
            mesh is None and pack_q4 and compute_dtype != torch.float32
            and cache_dtype in (None, torch.bfloat16, torch.int8)
            and (self.B >= 2 or bool(paged_kv))
            and supports_layers(params.get("layers", {}), torch.bfloat16,
                                batch=self.B, n_new=1))
        # per-slot paged KV reads in the fused step (opt-in, as in JAX)
        self._paged_kv = bool(paged_kv) and self._fused_decode
        # slot groups of assign_slots' length affinity (default: 16 / 8
        # when the batch divides); paged KV turns them off, as in JAX
        if kv_groups is None:
            kv_groups = (16 if self.B % 16 == 0
                         else 8 if self.B % 8 == 0 else 1)
        self._kv_groups = (kv_groups if kv_groups > 1 and self._fused_decode
                           and not self._paged_kv
                           and self.B % kv_groups == 0 else None)
        # chunk-local KV staging (opt-in; _run_chunk applies it to a bf16
        # cache at B > 1, unpaged)
        self._staged_kv = bool(staged_kv) and self._fused_decode
        if cache_dtype is None:
            cache_dtype = (torch.bfloat16
                           if self._fused_decode or self._tp_fused
                           else torch.float16)
        self.cache_dtype = cache_dtype
        self.params = params
        # the per-op step's matmul kernels, where the JAX engine allows its
        # Pallas kernels: on the accelerator, and not on the route of
        # unpacked weights (JAX's GSPMD route)
        self.allow_kernels = (pack_q4 and self.device.type == "cuda"
                              and placed.route != "sharded")
        lm = self.params.get("lm_head")
        self._fused_greedy = (
            self._fused_decode and isinstance(lm, QuantizedTensor)
            and lm.packed and (supports(lm, self.B) or supports_wide(lm, self.B)))
        # the sampled tail fusion commits bf16 rows: an int8 cache samples
        # from the per-step logits instead, and so does the paged step
        self._fused_sampled = (self._fused_greedy and not self._paged_kv
                               and self.cache_dtype == torch.bfloat16)
        # refills through the whole-prompt kernel where the fused step runs
        # on the card (the JAX package runs its refill kernel where Pallas
        # runs, not in interpret mode); tests set it on the CPU
        self._prefill_fused = self._fused_decode and self.device.type == "cuda"

    def new_cache(self) -> KVCache:
        """This rank's cache: its replica's slots, its features' shard."""
        return init_cache(self.config, batch=self.B_local,
                          max_len=self.max_seq, dtype=self.cache_dtype,
                          device=self.device, tp=self._kv_shards)

    # ------------------------------------------------------------- prefill

    def _gen_vectors(self, reqs, gen: GenerationParams):
        dev = self.device
        temps = _to_device([gen.temp if r.temp is None else r.temp
                            for r in reqs], torch.float32, dev)
        top_ps = _to_device([gen.top_p if r.top_p is None else r.top_p
                             for r in reqs], torch.float32, dev)
        top_ks = _to_device([gen.top_k if r.top_k is None else r.top_k
                             for r in reqs], torch.int32, dev)
        return temps, top_ps, top_ks

    def _prefill_group(self, pairs, cache: KVCache, generator,
                       gen: GenerationParams, st: _Slots):
        """Prefill + commit several (slot, request) pairs: one forward of
        the prompts padded to the group's bucket (rows bucketed to a power
        of two <= B) -- the whole-prompt kernel where ``_prefill_fused`` is
        on and the shape passes ``supports_prefill``, else the per-op
        forward --, each request's first token sampled with its own
        parameters, the rows merged over the slots' cache prefix and the
        slot vectors updated -> (cache, prompt lengths). On a data axis a
        replica runs only the pairs of its own slots (none: it only keeps
        its sampler in step) and draws its rows of the group's draw."""
        lens = [len(req.prompt_ids) for _, req in pairs]
        padded = min(_bucket(max(lens)), self.max_seq)
        nr = min(_bucket(len(pairs), floor=1), self.B)
        own = [r for r, (slot, _) in enumerate(pairs)
               if self._lo <= slot < self._lo + self.B_local]
        dev = self.device
        cfg = self.config
        if not own:
            skip_rows(generator, nr, min(self.MAX_TOP_K, cfg.n_vocab), dev)
            return cache, lens
        n = len(own)
        nr_own = min(_bucket(n, floor=1), self.B_local)
        ids = np.zeros((nr_own, padded), dtype=np.int64)
        last = np.zeros((nr_own,), dtype=np.int64)
        for i, r in enumerate(own):
            ids[i, :lens[r]] = pairs[r][1].prompt_ids
            last[i] = lens[r] - 1
        temps, top_ps, top_ks = self._gen_vectors(
            [pairs[r][1] for r in own], gen)
        ids_d = _to_device(ids, torch.int64, dev)
        last_d = _to_device(last, torch.int64, dev)
        if self._prefill_fused and supports_prefill(
                self.params["layers"], nr_own, padded, n_head=cfg.n_head,
                n_positions=cfg.n_positions):
            logits, small = forward_prefill_fused(
                self.params, ids_d, cfg, last_d,
                compute_dtype=self.compute_dtype, cache_dtype=self.cache_dtype)
        else:
            small = init_cache(cfg, batch=nr_own, max_len=padded,
                               dtype=self.cache_dtype, device=dev,
                               tp=self._kv_shards)
            logits, small = self._fwd(
                self.params, ids_d, small, 0, cfg,
                compute_dtype=self.compute_dtype, allow_kernels=False,
                logits_mode="last", last_index=last_d)
        # padding rows sample nothing; the draw is the whole group's, of
        # which a replica that owns every slot keeps the first n rows
        firsts = sample_per_request(
            logits[:n], generator, top_ks, top_ps, temps,
            max_top_k=self.MAX_TOP_K,
            rows=(nr, slice(0, n) if self.B_local == self.B
                  else _to_device(own, torch.int64, dev)))
        slots = _to_device([pairs[r][0] - self._lo for r in own],
                           torch.int64, dev)
        merge_rows(cache, small, slots, torch.arange(n, device=dev))
        st.toks[slots] = firsts
        st.first_buf[slots] = firsts
        st.lengths[slots] = _to_device([lens[r] for r in own], torch.int32,
                                       dev)
        st.temps[slots] = temps
        st.top_ps[slots] = top_ps
        st.top_ks[slots] = top_ks
        return cache, lens

    def _split_refill_groups(self, pairs):
        """Partition one refill wave into length-bucket prefill groups.

        Cost model (both terms in padded prompt tokens): a group of n rows
        padded to bucket P costs ``bucket_rows(n) * P``; every extra group
        costs ``REFILL_SPLIT_COST`` more. Rows sort by
        descending bucket and groups cut only at bucket boundaries, so the
        exact optimum over <= 3 groups is a small brute force; a uniform
        wave is one group."""
        dec = sorted(pairs, key=lambda p: len(p[1].prompt_ids),
                     reverse=True)
        buckets = [min(_bucket(len(req.prompt_ids)), self.max_seq)
                   for _, req in dec]
        cuts = [i for i in range(1, len(dec)) if buckets[i] != buckets[i - 1]]

        def group_cost(i, j):   # rows dec[i:j] as one group
            return min(_bucket(j - i, floor=1), self.B) * buckets[i]

        best = (group_cost(0, len(dec)), [])
        for k in (1, 2):
            for cs in combinations(cuts, k):
                edges = [0, *cs, len(dec)]
                cost = (sum(group_cost(edges[e], edges[e + 1])
                            for e in range(len(edges) - 1))
                        + k * self.REFILL_SPLIT_COST)
                if cost < best[0]:
                    best = (cost, list(cs))
        edges = [0, *best[1], len(dec)]
        return [dec[edges[e]:edges[e + 1]] for e in range(len(edges) - 1)]

    # --------------------------------------------------------------- decode

    def _step(self, st: _Slots, cache: KVCache, live, window: int,
              all_greedy: bool, generator):
        """One lockstep step -> (next tokens (B,) int32, finite bit of the
        live slots, cache)."""
        toks = st.toks[:, None]
        cfg = self.config
        if all_greedy and self._fused_greedy:
            nxt, mv, cache = forward_fused_decode_greedy(
                self.params, toks, cache, st.lengths, cfg, kv_window=window,
                per_slot_kv=self._paged_kv)
            return nxt, (torch.isfinite(mv) | ~live).all(), cache
        if not all_greedy and self._fused_sampled:
            logits, gmax, cache = forward_fused_decode_sampled(
                self.params, toks, cache, st.lengths, cfg, kv_window=window)
            ok = (torch.isfinite(gmax) | ~live[:, None]).all()
            nxt = sample_per_request(logits, generator, st.top_ks, st.top_ps,
                                     st.temps, max_top_k=self.MAX_TOP_K,
                                     gmax=gmax)
            return nxt, ok, cache
        if self._fused_decode:
            logits, cache = forward_fused_decode(
                self.params, toks, cache, st.lengths, cfg,
                compute_dtype=self.compute_dtype, kv_window=window,
                per_slot_kv=self._paged_kv)
        else:
            logits, cache = self._fwd(
                self.params, toks, cache, st.lengths, cfg,
                compute_dtype=self.compute_dtype,
                allow_kernels=self.allow_kernels, logits_mode="last",
                kv_window=window)
        return (*self._emit(logits, st, live, all_greedy, generator), cache)

    def _emit(self, logits, st: _Slots, live, all_greedy: bool, generator):
        """The per-step epilogue on full logits (the JAX ``sample_emit``):
        the live slots' finite bit and greedy or per-request sampled ids ->
        (next tokens (B,), finite bit)."""
        ok = (torch.isfinite(logits) | ~live[:, None]).all()
        if all_greedy:
            return greedy(logits), ok
        return sample_per_request(logits, generator, st.top_ks, st.top_ps,
                                  st.temps, max_top_k=self.MAX_TOP_K,
                                  rows=self._step_rows), ok

    def _run_chunk(self, st: _Slots, cache: KVCache, live, window: int,
                   all_greedy: bool, generator):
        """``chunk`` lockstep steps enqueued without a host read -> (cache,
        the drain vector: first tokens (B,), the (chunk, B) token ring and
        the chunk's finite bit). On a data axis the steps run this
        replica's slots, and the replicas' rings and bits meet in one
        gather at the end."""
        # slots with no bound request decode garbage; their positions reset
        # to 0 so they never widen a window (a past-0 slot attends only its
        # current token, commits its rows at [0, chunk) of its own slot,
        # and a later refill overwrites [0, prompt) before any read)
        st.lengths = torch.where(live, st.lengths,
                                 torch.zeros_like(st.lengths))
        ring = torch.zeros(self.chunk, self.B_local, dtype=torch.int32,
                           device=self.device)
        health = torch.ones((), dtype=torch.bool, device=self.device)
        # chunk-local KV staging: a bf16 cache at B > 1, unpaged
        staged = (self._staged_kv and self.B > 1 and not self._paged_kv
                  and self.cache_dtype == torch.bfloat16)
        if staged:
            L, _, _, D = cache.k.shape
            k_stage = torch.zeros(L, self.B, self.chunk, D,
                                  dtype=cache.k.dtype, device=self.device)
            v_stage = torch.zeros_like(k_stage)
            lengths0 = st.lengths             # the chunk-start positions
        for i in range(self.chunk):
            if staged:
                logits, k_rows, v_rows = forward_fused_decode_staged(
                    self.params, st.toks[:, None], cache, k_stage, v_stage,
                    st.lengths, i, self.config,
                    compute_dtype=self.compute_dtype, kv_window=window)
                k_stage[:, :, i] = k_rows
                v_stage[:, :, i] = v_rows
                nxt, ok = self._emit(logits, st, live, all_greedy, generator)
            else:
                nxt, ok, cache = self._step(st, cache, live, window,
                                            all_greedy, generator)
            ring[i] = nxt
            health = health & ok
            st.toks = nxt.to(torch.int32)
            st.lengths = st.lengths + 1
        if staged:   # one block write per slot at its chunk-start position
            write_block(cache.k, k_stage, lengths0)
            write_block(cache.v, v_stage, lengths0)
        tail = torch.cat([ring.reshape(-1), health.to(torch.int32)[None]])
        if self.B_local < self.B:
            d = self.mesh.data
            g = self.mesh.gather_data(tail).reshape(d, -1)
            ring = g[:, :-1].reshape(d, self.chunk, self.B_local)
            tail = torch.cat([ring.transpose(0, 1).reshape(-1),
                              g[:, -1].amin()[None]])
        return cache, torch.cat([st.firsts, tail])

    # --------------------------------------------------------------- serve

    def serve(
        self,
        requests: List[Request],
        gen: GenerationParams | None = None,
        more=None,
        on_complete=None,
        on_token=None,
        is_aborted=None,
        decision_sync=None,
    ) -> Dict[int, RequestResult]:
        """Run all requests to completion with continuous slot refill.

        ``gen`` provides the default sampling parameters and the EOS rule;
        each request may override temp/top_k/top_p; lengths are
        per-request. ``more``: a zero-arg callable polled once per
        scheduling iteration for newly arrived requests (live intake);
        serve() returns once it yields nothing and all accepted work has
        drained. ``on_complete(request_id, RequestResult)`` fires when a
        request's final token has drained (under live intake its result is
        then evicted from the returned dict); ``on_token(request_id,
        token_id)`` per generated token as its drain lands;
        ``is_aborted(request_id)`` (one-way) stops a request and frees its
        slot at the next scheduling check.

        A slot frees as soon as enough tokens are SCHEDULED for its request
        (the tail still in flight drains to it through the bindings
        snapshotted at launch), when the cache cannot fit another chunk
        (the request is truncated), or when the drained tokens show it done
        (EOS, abort). Drain threads emit chunks strictly in launch order;
        ``pipeline`` bounds how far the host runs ahead of them.

        ``decision_sync``: ``f(mask: list[bool]) -> list[bool]`` applied to
        each iteration's slot-freeness mask. Ranks of a mesh that run this
        loop together (``runtime.dist_serving``) pass it to replicate one
        rank's view: freeing on EOS reads drained tokens, whose arrival is
        each process's own, and every rank must launch the same work.
        Everything that decides control flow or device inputs derives from
        the synced mask."""
        gen = gen or GenerationParams(temp=0.0)
        seed = gen.seed if gen.seed >= 0 else int(time.time())
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        t_serve = time.perf_counter()
        tokens_before = self.metrics.snapshot()["tokens_emitted"]

        def is_greedy(r: Request) -> bool:
            return (gen.temp if r.temp is None else r.temp) <= 0

        # all greedy and no live intake: the argmax tail for every chunk.
        # Live intake always runs the per-request sampler (it handles greedy
        # rows): a sampled request may join any later chunk.
        all_greedy = more is None and all(is_greedy(r) for r in requests)

        queue = list(requests)
        results: Dict[int, RequestResult] = {}
        reqs_by_id: Dict[int, Request] = {}
        # capacity-truncated requests: request_id -> the number of new
        # tokens that will ever drain for it
        capped: Dict[int, int] = {}
        cache = self.new_cache()
        # host request state is shared with the drain threads; the lock
        # covers every mutation and multi-step read of results/reqs_by_id
        state_lock = threading.Lock()
        accept_t: Dict[int, float] = {}   # rid -> accept time (monotonic)

        def emit_token(rid: int, tid: int) -> None:
            """Deliver one token (under state_lock); time to first token
            and end to end are measured at drain time."""
            res = results[rid]
            res.ids.append(tid)
            if on_token is not None:
                on_token(rid, tid)
            t0 = accept_t.get(rid)
            if t0 is None:
                return
            now = time.monotonic()
            if len(res.ids) - res.prompt_len == 1:
                self.metrics.observe_latency("ttft", now - t0)
            req = reqs_by_id.get(rid)
            if req is not None and req_done(req):
                accept_t.pop(rid, None)
                self.metrics.observe_latency("e2e", now - t0)

        def notify() -> None:
            """Fire on_complete for requests whose final token has drained;
            completed requests leave ``reqs_by_id`` (and, under live
            intake, the results). Callbacks fire outside the lock."""
            if on_complete is None:
                return
            with state_lock:
                done_ids = [rid for rid, req in reqs_by_id.items()
                            if req_done(req)]
                done = []
                for rid in done_ids:
                    del reqs_by_id[rid]
                    done.append((rid, results[rid]))
                    if more is not None:
                        results.pop(rid)
                        capped.pop(rid, None)
            self.metrics.inc("requests_completed", len(done))
            for rid, res in done:
                on_complete(rid, res)

        # host-side slot table
        slot_req: List[Optional[Request]] = [None] * self.B
        lengths_host = [0] * self.B   # device position mirror
        sched_new = [0] * self.B      # tokens SCHEDULED for the slot's request
        fresh_slots: List[int] = []   # refilled since the last chunk launch

        # drain threads: each waits on its chunk's copy event; chunks emit
        # strictly in launch order through a reorder buffer
        drain_q: "_queue.Queue" = _queue.Queue(maxsize=2 * self.pipeline)
        drain_errors: List[BaseException] = []
        emit_cv = threading.Condition()
        done_map: Dict[int, tuple] = {}   # seq -> (vals, bound, fbound)
        next_emit = [0]                   # next seq to emit (under emit_cv)
        launched = [0]                    # chunks handed to the drains
        last_land = [time.monotonic()]    # watchdog: last drain landing

        def emit_chunk(seq, vals, bound, fbound) -> None:
            """Emit one drained chunk against the bindings snapshotted at
            its launch; the chunk's finite bit fails the serve before any
            of its tokens are delivered."""
            if self.health_check and int(vals[-1]) == 0:
                self.metrics.inc("health_failures")
                raise ModelHealthError(
                    f"non-finite logits in decode chunk {seq} (live slots: "
                    f"{[b for b in range(self.B) if bound[b] is not None]})")
            firsts = vals[:self.B]
            block = vals[self.B:self.B + self.chunk * self.B].reshape(
                self.chunk, self.B)
            emitted = 0
            with state_lock:
                for b in range(self.B):
                    if fbound[b] is not None and not req_done(fbound[b]):
                        emit_token(fbound[b].request_id, int(firsts[b]))
                        emitted += 1
                for step_row in block:
                    for b in range(self.B):
                        req = bound[b]
                        if req is not None and not req_done(req):
                            emit_token(req.request_id, int(step_row[b]))
                            emitted += 1
            self.metrics.inc("tokens_emitted", emitted)

        def drain_worker() -> None:
            while True:
                item = drain_q.get()
                try:
                    if item is None:
                        return
                    seq, fetch, bound, fbound = item
                    vals = fetch.numpy()
                    self.metrics.inc("drains_landed")
                    last_land[0] = time.monotonic()
                    with emit_cv:
                        done_map[seq] = (vals, bound, fbound)
                        while next_emit[0] in done_map:
                            s = next_emit[0]
                            emit_chunk(s, *done_map.pop(s))
                            next_emit[0] += 1
                        emit_cv.notify_all()
                    notify()
                except BaseException as e:  # surfaced by the scheduler loop
                    drain_errors.append(e)
                    with emit_cv:
                        emit_cv.notify_all()
                finally:
                    drain_q.task_done()

        drain_threads = [
            threading.Thread(target=drain_worker, name=f"biogpt-drain-{i}",
                             daemon=True)
            for i in range(self.pipeline)]
        for t in drain_threads:
            t.start()

        def flush_drains() -> None:
            """Wait until every launched chunk has drained and emitted;
            re-raise drain errors. With ``watchdog_s``, drains that stop
            landing for that long raise DrainStallError."""
            deadline_base = time.monotonic()
            with emit_cv:
                while next_emit[0] < launched[0] and not drain_errors:
                    emit_cv.wait(timeout=0.1)
                    if self.watchdog_s is not None:
                        quiet = time.monotonic() - max(last_land[0],
                                                       deadline_base)
                        if quiet > self.watchdog_s:
                            raise DrainStallError(
                                f"no decode chunk drained for {quiet:.1f}s "
                                f"(watchdog {self.watchdog_s}s): "
                                f"{next_emit[0]}/{launched[0]} chunks "
                                f"emitted")
            if drain_errors:
                raise drain_errors[0]

        dev = self.device
        Bl = self.B_local
        first_buf = torch.zeros(Bl, dtype=torch.int32, device=dev)
        st = _Slots(
            toks=torch.zeros(Bl, dtype=torch.int32, device=dev),
            lengths=torch.zeros(Bl, dtype=torch.int32, device=dev),
            first_buf=first_buf,
            temps=torch.zeros(Bl, dtype=torch.float32, device=dev),
            top_ps=torch.ones(Bl, dtype=torch.float32, device=dev),
            top_ks=torch.ones(Bl, dtype=torch.int32, device=dev),
            firsts=(None if Bl == self.B else
                    torch.zeros(self.B, dtype=torch.int32, device=dev)))

        def req_done(req: Optional[Request]) -> bool:
            """n_predict reached, EOS emitted, or aborted (monotonic)."""
            if req is None:
                return True
            if is_aborted is not None and is_aborted(req.request_id):
                return True
            res = results.get(req.request_id)
            if res is None:   # completed and evicted (live-intake mode)
                return True
            n_new = len(res.ids) - res.prompt_len
            cap = capped.get(req.request_id)
            if cap is not None and n_new >= cap:
                return True   # capacity-truncated: all its tokens drained
            if n_new >= req.n_predict:
                return True
            return (gen.stop_at_eos and n_new > 0
                    and res.ids[-1] == gen.eos_token_id)

        def slot_free(slot: int) -> bool:
            """Slot can take a new request: enough tokens scheduled, no
            room for another chunk (``lengths_host`` mirrors the device
            position), or done by drained tokens (EOS, abort)."""
            req = slot_req[slot]
            if req is None:
                return True
            if sched_new[slot] >= req.n_predict:
                return True
            if lengths_host[slot] + self.chunk > self.max_seq:
                return True
            return req_done(req)

        def assign_slots(free_slots: List[int], reqs: List[Request]):
            """Map accepted requests onto free slots, length-affine at slot
            group granularity (best-fit decreasing): each request's final
            length goes to the group whose running max grows least, the
            tightest among ties. Without groups: first free slot order."""
            G = self._kv_groups
            if not G or not reqs:
                return list(zip(free_slots, reqs))
            GB = self.B // G
            cur_max = [0] * G
            for b in range(self.B):
                if slot_req[b] is not None:   # freed slots were cleared
                    g = b // GB
                    cur_max[g] = max(cur_max[g], lengths_host[b])
            free_by_g: Dict[int, List[int]] = {}
            for s in sorted(free_slots):
                free_by_g.setdefault(s // GB, []).append(s)
            order = sorted(
                reqs, key=lambda r: -(len(r.prompt_ids) + r.n_predict))
            pairs = []
            for req in order:
                rlen = min(len(req.prompt_ids) + req.n_predict,
                           self.max_seq)
                best_g, best_key = None, None
                for g, slots in free_by_g.items():
                    if not slots:
                        continue
                    inc = max(cur_max[g], rlen) - cur_max[g]
                    key = (inc, cur_max[g])
                    if best_key is None or key < best_key:
                        best_g, best_key = g, key
                slot = free_by_g[best_g].pop(0)
                cur_max[best_g] = max(cur_max[best_g], rlen)
                pairs.append((slot, req))
            return pairs

        def refill(free_slots: List[int]):
            """Fill free slots from the queue, one prefill per group."""
            nonlocal cache
            accepted: List[Request] = []
            n_reg = 0
            with state_lock:   # notify() iterates/evicts these dicts
                while queue:
                    req = queue.pop(0)
                    n_reg += 1
                    results[req.request_id] = RequestResult(
                        request_id=req.request_id, ids=list(req.prompt_ids),
                        prompt_len=len(req.prompt_ids))
                    reqs_by_id[req.request_id] = req
                    accept_t[req.request_id] = time.monotonic()
                    if (is_aborted is not None
                            and is_aborted(req.request_id)):
                        # aborted while queued: registered (so notify()
                        # completes it with an empty result), never slotted
                        continue
                    if len(accepted) == len(free_slots):
                        queue.insert(0, req)
                        del reqs_by_id[req.request_id]
                        del results[req.request_id]
                        accept_t.pop(req.request_id, None)
                        n_reg -= 1
                        break
                    accepted.append(req)
            pairs = assign_slots(free_slots, accepted)
            self.metrics.inc("requests_accepted", n_reg)
            refilled = []
            for gp in self._split_refill_groups(pairs) if pairs else []:
                self.metrics.inc("refill_programs", 1)
                cache, lens = self._prefill_group(gp, cache, generator, gen,
                                                  st)
                for r, (slot, req) in enumerate(gp):
                    slot_req[slot] = req
                    lengths_host[slot] = lens[r]
                    sched_new[slot] = 1   # the prefill-sampled first token
                    fresh_slots.append(slot)
                    refilled.append(slot)
            if pairs and self.B_local < self.B:
                # the wave's one data-axis exchange: every first token
                st.firsts = self.mesh.gather_data(st.first_buf)
            return refilled

        try:
            drained_once = False
            while True:
                if drain_errors:
                    raise drain_errors[0]
                if more is not None:
                    queue.extend(more())
                # a slot at the KV-capacity rule schedules no further
                # chunks: cap its request at the already-scheduled count
                with state_lock:
                    for b in range(self.B):
                        req = slot_req[b]
                        if (req is not None
                                and lengths_host[b] + self.chunk > self.max_seq
                                and sched_new[b] < req.n_predict):
                            capped.setdefault(req.request_id, sched_new[b])
                # ONE slot-freeness decision per scheduling iteration;
                # everything below derives from this mask
                free_mask = [slot_free(b) for b in range(self.B)]
                if decision_sync is not None:
                    free_mask = decision_sync(free_mask)
                free = [b for b in range(self.B) if queue and free_mask[b]]
                for b in free:
                    slot_req[b] = None
                refilled = refill(free)
                busy = [(not free_mask[b]) or b in refilled
                        for b in range(self.B)]

                if not any(busy):
                    if not drained_once:
                        # all scheduled: land the in-flight chunks (EOS may
                        # show in them), then re-check once
                        flush_drains()
                        drained_once = True
                        continue
                    drained_once = False
                    if fresh_slots:
                        # a prompt filled the cache to within one chunk: no
                        # chunk runs, but its first token is still owed
                        vals = st.firsts.cpu().numpy()
                        with state_lock:
                            for b in fresh_slots:
                                if not req_done(slot_req[b]):
                                    emit_token(slot_req[b].request_id,
                                               int(vals[b]))
                        fresh_slots.clear()
                        notify()
                        continue
                    break
                drained_once = False

                # the KV window covers the BOUND slots only (floor 128)
                bound_lens = [lengths_host[b] for b in range(self.B)
                              if busy[b]]
                window = min(_bucket(max(bound_lens) + self.chunk,
                                     floor=128), self.max_seq)
                # launch-time binding snapshot; also the live mask
                bound = [slot_req[b] if busy[b] else None
                         for b in range(self.B)]
                live = _to_device([r is not None for r in
                                   bound[self._lo:self._lo + Bl]],
                                  torch.bool, dev)
                cache, fetch = self._run_chunk(st, cache, live, window,
                                               all_greedy, generator)
                fetch = _Fetch(fetch)
                for b in range(self.B):
                    if bound[b] is not None:
                        sched_new[b] += self.chunk
                # firsts bind separately: a fresh slot whose prompt fills
                # the cache to within one chunk is still owed its first
                fbound = [slot_req[b] if b in fresh_slots else None
                          for b in range(self.B)]
                fresh_slots.clear()
                drain_q.put((launched[0], fetch, bound, fbound))
                launched[0] += 1
                self.metrics.inc("chunks_launched")
                for b in range(self.B):
                    lengths_host[b] += self.chunk
        finally:
            # always stop the drain threads (a long-lived scheduler would
            # otherwise leak blocked threads per failure)
            for _ in drain_threads:
                drain_q.put(None)
            for t in drain_threads:
                t.join()
        if drain_errors:
            raise drain_errors[0]
        notify()
        if on_complete is None:
            # no callback: notify() never ran its completion scan
            self.metrics.inc("requests_completed", len(results))
        self.metrics.serve_finished(
            time.perf_counter() - t_serve,
            self.metrics.snapshot()["tokens_emitted"] - tokens_before)
        return results


class ServingScheduler:
    """Long-lived continuous-batching front over one :class:`BatchedEngine`.

    ``submit()`` from any thread returns a ``concurrent.futures.Future``; a
    worker thread keeps a ``serve()`` loop fed through its live-intake
    hook, so requests submitted while a batch decodes join it at the next
    free slot, and each future resolves as soon as its request's final
    token drains.
    """

    def __init__(self, engine: BatchedEngine,
                 gen: GenerationParams | None = None,
                 poll_s: float = 0.05):
        self.engine = engine
        self.gen = gen or GenerationParams(temp=0.0)
        self._queue: "_queue.Queue" = _queue.Queue()
        self._aborted: set = set()   # one-way; GIL-atomic add/contains
        self._next_id = 0
        # guards _stop vs submit, so no future is enqueued after the
        # worker has exited on an empty queue
        self._lock = threading.Lock()
        self._poll_s = poll_s
        self._stop = False
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="biogpt-serving", daemon=True)
        self._thread.start()

    def submit(self, prompt_ids: List[int], n_predict: int = 64,
               temp: Optional[float] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None, on_token=None):
        """Enqueue one generation; returns a Future[RequestResult].
        ``on_token``: optional ``f(token_id)`` per generated token (called
        from a drain thread, in bursts as drains land)."""
        from concurrent.futures import Future

        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            rid = self._next_id
            self._next_id += 1
            req = Request(prompt_ids=list(prompt_ids), n_predict=n_predict,
                          request_id=rid, temp=temp, top_k=top_k, top_p=top_p)
            self._queue.put((req, fut, on_token))
        fut.request_id = rid   # for abort() by callers holding the future
        self._wake.set()
        return fut

    def abort(self, request_id: int) -> None:
        """Stop generating for a submitted request (one-way; idempotent):
        its slot frees at the next scheduling check and its Future
        resolves with whatever tokens had drained."""
        if request_id not in self._aborted:
            self._aborted.add(request_id)
            self.engine.metrics.inc("requests_aborted")
        self._wake.set()

    def stats(self) -> dict:
        """The engine's ServingMetrics counters plus queue depth and
        in-flight requests (``GET /stats``)."""
        out = self.engine.metrics.snapshot()
        out["queued"] = self._queue.qsize()
        out["in_flight"] = max(
            0, out["requests_accepted"] - out["requests_completed"])
        out["batch_slots"] = self.engine.B
        out["closed"] = self._stop
        return out

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work; wait for in-flight requests to finish."""
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=timeout)
        # fail (rather than hang) anything still queued when the worker died
        for _, fut, _ in self._take_pending():
            fut.set_exception(RuntimeError("scheduler closed"))

    # ------------------------------------------------------------- worker

    def _take_pending(self):
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except _queue.Empty:
                return out

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self._poll_s)
            self._wake.clear()
            batch = self._take_pending()
            if not batch:
                if self._stop:
                    return
                continue
            futures = {req.request_id: fut for req, fut, _ in batch}
            streams = {req.request_id: cb for req, _, cb in batch
                       if cb is not None}

            def more():
                extra = self._take_pending()
                for req, fut, cb in extra:
                    futures[req.request_id] = fut
                    if cb is not None:
                        streams[req.request_id] = cb
                return [req for req, _, _ in extra]

            def on_complete(rid, result):
                streams.pop(rid, None)
                # completed ids never recur, so the abort set forgets them
                self._aborted.discard(rid)
                fut = futures.pop(rid, None)
                if fut is not None:
                    fut.set_result(result)

            def on_token(rid, tid):
                cb = streams.get(rid)
                if cb is not None:
                    cb(tid)

            try:
                results = self.engine.serve(
                    [req for req, _, _ in batch], self.gen,
                    more=more, on_complete=on_complete, on_token=on_token,
                    is_aborted=self._aborted.__contains__)
                for rid, fut in list(futures.items()):
                    # every request must have been notified; resolve or
                    # fail so no waiter can hang
                    if rid in results:
                        fut.set_result(results[rid])
                    else:
                        fut.set_exception(RuntimeError(
                            f"request {rid} not completed by serve()"))
                    futures.pop(rid)
            except Exception as e:   # propagate to waiters, keep serving
                for fut in futures.values():
                    fut.set_exception(e)
