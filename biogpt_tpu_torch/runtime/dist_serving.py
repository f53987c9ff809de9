"""The multi-process serving front: every rank of a mesh serves, rank 0 is
the one front door (``biogpt_tpu/runtime/dist_serving.py``).

A tensor-parallel ``BatchedEngine`` runs on every rank, and every rank has
to make the same scheduling decisions on the same requests, while requests
arrive at one place (an HTTP port on rank 0). So:

- rank 0's ``submit()`` returns a ``concurrent.futures.Future`` exactly as
  ``ServingScheduler.submit`` does (the HTTP server binds to it as it is);
- every rank runs the same serve loop; once per scheduling tick rank 0's
  pending requests reach every rank in ONE ``broadcast`` of a fixed-shape
  int32 buffer (requests, the stop flag and aborts encode into it), and
  the engine's loop, deterministic given its intake, keeps the ranks in
  lockstep -- the same launches and collectives, in the same order;
- slot-freeing decisions that read drained tokens (EOS) ride one more
  broadcast (``serve(decision_sync=)``), since each process drains on its
  own clock;
- the tokens are the same on every rank (the logits are gathered whole,
  and on a data axis each chunk's tokens are gathered over the replicas);
  rank 0 resolves futures and streams tokens, the others discard them.

Both broadcasts run over the whole job (the default group): on a (data,
model) mesh every rank of every replica runs the same scheduler on the
same requests, and the engine splits the slots among the replicas.

Failure handling is fail-fast: an error on any rank ends the job.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import GenerationParams
from ..parallel.distributed import broadcast
from .serving import BatchedEngine, Request

# per-request header fields in the broadcast buffer: request_id,
# prompt_len, n_predict, top_k (-1 = inherit), temp and top_p (f32 bits,
# -1 = inherit)
_F = 6
_NONE = -1


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _bits_f32(b: int) -> float:
    return float(np.int32(b).view(np.float32))


def _encode(reqs: List[Request], stop: bool, aborts: List[int],
            max_reqs: int, max_prompt: int) -> np.ndarray:
    """[n_reqs, stop, n_aborts] header + abort ids + request rows, flat."""
    buf = np.full((max_reqs, _F + max_prompt), _NONE, np.int32)
    for r, req in enumerate(reqs):
        ids = req.prompt_ids
        buf[r, 0] = req.request_id
        buf[r, 1] = len(ids)
        buf[r, 2] = req.n_predict
        buf[r, 3] = _NONE if req.top_k is None else req.top_k
        buf[r, 4] = _NONE if req.temp is None else _f32_bits(req.temp)
        buf[r, 5] = _NONE if req.top_p is None else _f32_bits(req.top_p)
        buf[r, _F:_F + len(ids)] = ids
    head = np.array([len(reqs), int(stop), len(aborts)], np.int32)
    ab = np.full((max_reqs,), _NONE, np.int32)
    ab[:len(aborts)] = aborts
    return np.concatenate([head, ab, buf.ravel()])


def _decode(flat: np.ndarray, max_reqs: int, max_prompt: int):
    n, stop, n_ab = int(flat[0]), bool(flat[1]), int(flat[2])
    aborts = [int(x) for x in flat[3:3 + max_reqs][:n_ab]]
    buf = flat[3 + max_reqs:].reshape(max_reqs, _F + max_prompt)
    reqs = []
    for r in range(n):
        plen = int(buf[r, 1])
        reqs.append(Request(
            prompt_ids=[int(t) for t in buf[r, _F:_F + plen]],
            n_predict=int(buf[r, 2]),
            request_id=int(buf[r, 0]),
            top_k=None if buf[r, 3] == _NONE else int(buf[r, 3]),
            temp=None if buf[r, 4] == _NONE else _bits_f32(buf[r, 4]),
            top_p=None if buf[r, 5] == _NONE else _bits_f32(buf[r, 5]),
        ))
    return reqs, stop, aborts


class DistributedScheduler:
    """Long-lived serving loop of every rank over one :class:`BatchedEngine`.

    Every rank constructs this with the SAME engine configuration; the
    other ranks call :meth:`run` and block in it, rank 0 runs it on its own
    thread and takes :meth:`submit` / :meth:`abort` / :meth:`close` -- the
    surface of ``ServingScheduler``, so ``server.BioGptServer`` works on top
    as it is.

    ``max_reqs_per_tick`` x ``max_prompt`` fix the broadcast buffer's
    shape; ``poll_s`` paces the idle tick and doubles up to ``idle_max_s``
    while no requests flow (each idle tick is a collective). Every rank
    derives that schedule from the same ticks, so the collectives stay
    matched.
    """

    def __init__(self, engine: BatchedEngine,
                 gen: GenerationParams | None = None,
                 max_reqs_per_tick: int = 8,
                 max_prompt: Optional[int] = None,
                 poll_s: float = 0.05,
                 idle_max_s: float = 0.5):
        self.engine = engine
        gen = gen or GenerationParams(temp=0.0)
        # every rank samples with rank 0's seed (a seed < 0 would take each
        # process' clock); the caller's params are copied, never mutated
        seed = gen.seed if gen.seed >= 0 else int(time.time())
        self.gen = dataclasses.replace(gen, seed=int(self._bcast(
            np.array([seed], np.int32))[0]))
        self.max_reqs = max_reqs_per_tick
        self.max_prompt = max_prompt or engine.max_seq
        self.poll_s = poll_s
        self.idle_max_s = max(idle_max_s, poll_s)
        self._idle_s = poll_s   # the current idle sleep
        self.is_primary = dist.get_rank() == 0

        self._lock = threading.Lock()
        self._pending: List = []           # (Request, Future, on_token), rank 0
        self._pending_aborts: List[int] = []   # rank 0, drained into ticks
        self._abort_set: set = set()       # every rank, fed FROM the ticks
        self._futures = {}
        self._streams = {}
        self._next_id = 0
        self._stop = False
        self._saw_stop = False
        self._thread: Optional[threading.Thread] = None
        if self.is_primary:
            self._thread = threading.Thread(
                target=self.run, name="biogpt-dist-serving", daemon=True)
            self._thread.start()

    def _bcast(self, arr: np.ndarray) -> np.ndarray:
        """Rank 0's int32 ``arr`` on every rank (the collective runs on the
        engine's device)."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
        return broadcast(t.to(self.engine.device)).cpu().numpy()

    # ------------------------------------------------------------- intake

    def submit(self, prompt_ids: List[int], n_predict: int = 64,
               temp: Optional[float] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None, on_token=None):
        """Rank 0 only: enqueue one generation -> Future[RequestResult].
        Floods beyond the tick buffer wait for the next tick."""
        if not self.is_primary:
            raise RuntimeError("submit() is rank 0's (the front door)")
        if len(prompt_ids) > self.max_prompt:
            raise ValueError(f"prompt ({len(prompt_ids)} tokens) exceeds "
                             f"max_prompt ({self.max_prompt})")
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            rid = self._next_id
            self._next_id += 1
            req = Request(prompt_ids=list(prompt_ids), n_predict=n_predict,
                          request_id=rid, temp=temp, top_k=top_k, top_p=top_p)
            self._pending.append((req, fut, on_token))
        fut.request_id = rid
        return fut

    def abort(self, request_id: int) -> None:
        """Rank 0: stop generating for a request. The abort rides the next
        tick, so every rank frees the slot at the same scheduling point; the
        Future resolves with whatever drained."""
        if not self.is_primary:
            raise RuntimeError("abort() is rank 0's (the front door)")
        with self._lock:
            if (request_id not in self._abort_set
                    and request_id not in self._pending_aborts):
                self._pending_aborts.append(request_id)
                self.engine.metrics.inc("requests_aborted")

    def _tick(self) -> tuple:
        """ONE broadcast: rank 0's pending requests (up to the buffer), its
        aborts and the stop flag, on every rank. Every rank calls it at the
        same points of the loop."""
        taken, aborts, stop = [], [], False
        if self.is_primary:
            with self._lock:
                take = self._pending[:self.max_reqs]
                del self._pending[:len(take)]
                aborts = self._pending_aborts[:self.max_reqs]
                del self._pending_aborts[:len(aborts)]
                stop = self._stop and not take and not self._pending
                for req, fut, cb in take:
                    self._futures[req.request_id] = fut
                    if cb is not None:
                        self._streams[req.request_id] = cb
                taken = [req for req, _, _ in take]
        flat = self._bcast(_encode(taken, stop, aborts, self.max_reqs,
                                   self.max_prompt))
        reqs, stop, aborts = _decode(flat, self.max_reqs, self.max_prompt)
        self._abort_set.update(aborts)   # every rank, identically
        return reqs, stop

    # -------------------------------------------------------------- serve

    def run(self) -> None:
        """The serve loop every rank runs (the others call it and block;
        rank 0 runs it on its own thread)."""
        def on_complete(rid, result):
            if not self.is_primary:
                return
            with self._lock:
                self._streams.pop(rid, None)
                fut = self._futures.pop(rid, None)
            if fut is not None and not fut.done():
                try:
                    fut.set_result(result)
                except InvalidStateError:   # failed by close() meanwhile
                    pass

        def on_token(rid, tid):
            if not self.is_primary:
                return
            cb = self._streams.get(rid)
            if cb is not None:
                cb(tid)

        def more():
            more_reqs, more_stop = self._tick()
            if more_stop:   # close() while serving: drain, then exit
                self._saw_stop = True
            return more_reqs

        def decision_sync(mask):
            # rank 0's view of which slots are free
            return [bool(v) for v in self._bcast(np.asarray(mask, np.int32))]

        while True:
            reqs, stop = self._tick()
            if stop:
                return
            if not reqs:
                # idle backoff, the same schedule on every rank
                time.sleep(self._idle_s)
                self._idle_s = min(self._idle_s * 2, self.idle_max_s)
                continue
            self._idle_s = self.poll_s
            self._saw_stop = False
            try:
                self.engine.serve(reqs, self.gen, more=more,
                                  on_complete=on_complete, on_token=on_token,
                                  is_aborted=self._abort_set.__contains__,
                                  decision_sync=decision_sync)
            except Exception as e:
                if self.is_primary:
                    with self._lock:
                        futs = list(self._futures.values())
                        self._futures.clear()
                    for fut in futs:
                        fut.set_exception(e)
                raise   # fail fast: every rank ends together
            if self._saw_stop:
                return

    def stats(self) -> dict:
        """The engine's counters plus the front door's queue depth and
        in-flight count (rank 0's view; ``GET /stats``)."""
        out = self.engine.metrics.snapshot()
        with self._lock:
            out["queued"] = len(self._pending)
            out["in_flight"] = len(self._futures)
            out["closed"] = self._stop
        out["batch_slots"] = self.engine.B
        out["processes"] = dist.get_world_size()
        return out

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Rank 0: stop taking work, drain, and stop every rank's loop (the
        stop flag rides the tick)."""
        if not self.is_primary:
            raise RuntimeError("close() is rank 0's")
        with self._lock:
            self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        with self._lock:
            leftovers = list(self._futures.values())
            self._futures.clear()
        for fut in leftovers:
            if not fut.done():
                try:
                    fut.set_exception(RuntimeError("scheduler closed"))
                except InvalidStateError:   # completed meanwhile
                    pass
