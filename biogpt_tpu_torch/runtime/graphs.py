"""Decode chunks, refills and prefills as CUDA graphs: the port's
one-dispatch programs.

The JAX engines run a chunk of decode steps as one jitted ``lax.scan``
(``Engine.decode_scan``, ``BatchedEngine.step_scan``), a serving refill
group as one jitted ``refill_commit`` of every shape, and ``Engine``'s
prefill and scoring as one jitted step each: the token, the position, the RNG, the EOS flag and the health
bit stay on the device, and the host binds a call's arguments once a
program, not once an op. On the card the counterpart is a CUDA graph of
the program's kernel launches, captured once and replayed:
:class:`ChunkGraphs`.

A body is a function of no arguments that reads and writes tensors at
fixed addresses in place: the engine's KV cache and its static state
(tokens, positions, the live mask, sampling parameters, the token ring,
the EOS flag, the health bit; a refill's or a prefill's input block, which
the host fills with one copy before the run). The runner keys each graph
by what the body's launches depend on besides those tensors (a decode
chunk: route, cache dtype, greedy or sampled, top_k, KV window, steps; a
refill: route, cache dtype, rows, padded length; a prefill: cache dtype,
padded length, KV window; a scoring: cache dtype, causal, rows, length).
The first ``EAGER_RUNS``
runs of a key call the body directly, as real work: they build the
kernels' libraries, their first-use attributes and cached workspaces
(``ops.qmatmul_kernels.tail_workspace``) outside any capture. A capture
costs about an eager run's host time, the graph's instantiation and a
replay, and each later replay saves a run's host time, so a key that
runs once or twice (a generation's tail of 32, ..., 1 steps; a cold
process's single generation) never pays one. The next run of the key
captures the body into a graph whose memory comes from one pool shared
by all of the runner's graphs, and replays it; every later run replays
it. A capture launches nothing, so it moves no state tensor and no
generator. A body's outputs stay in its state tensors, so one graph's
intermediates may reuse what another's freed, where they fit its
segments: the pool grows with the largest key's capture, not with the
sum of every key's, and smaller keys captured before a larger one add
the segments of theirs that it cannot reuse (``pool_bytes``). Sampled
bodies draw from the runner's generator, registered with each graph that
draws from it: a replay advances it as the eager body would, and
reseeding it between runs takes effect.

``cuda_lib.LAUNCHES`` counts on the host, where a replay launches
nothing: the runner records each graph's count delta at its capture (a
capture itself launches nothing, so the counts are put back) and adds it
at every replay.

On the CPU, and where capture is off (``capture=False``: an engine on a
mesh, whose collectives are gloo's; or a run's own ``capture=False``: a
key that is never captured), :meth:`ChunkGraphs.run` calls the body
directly. On the card a key's run after its eager ones captures or
raises: nothing falls back to the eager body.
"""

from __future__ import annotations

import time

import torch

from ..ops import cuda_lib


def binary_chunks(n: int, largest: int = 64) -> list:
    """``n`` steps as the step counts of the graphs that run them: as many
    ``largest`` (a power of two) as fit, then the binary digits of the
    rest, largest first (100 -> [64, 32, 4])."""
    if n < 0 or largest < 1 or largest & (largest - 1):
        raise ValueError(f"binary_chunks: n {n}, largest {largest}")
    out, p = [], largest
    while n > 0:
        while p > n:
            p //= 2
        out.append(p)
        n -= p
    return out


class ChunkGraphs:
    """Runner of chunk bodies: a key's first ``EAGER_RUNS`` runs call the
    body, the next captures it, and every run after replays it (module
    docstring). ``generator``: the engine's generator that sampled bodies
    draw from. ``capture``: whether bodies on the card become graphs
    (always off on the CPU; a verifier turns it off to run an engine's
    chunks eagerly)."""

    EAGER_RUNS = 2   # a key's direct runs before its capture

    def __init__(self, device, generator: torch.Generator | None = None,
                 capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.graphs: dict = {}   # key -> (CUDAGraph, launch count deltas)
        self.runs: dict = {}     # key -> the body's direct runs
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.replayed: dict = {}   # key -> its graph's replays

    def run(self, key, body, sampled: bool = False,
            capture: bool = True) -> None:
        """Run ``body`` once: directly where capture is off (the runner's,
        or ``capture=False``: a key that never becomes a graph) or ``key``
        has run fewer than ``EAGER_RUNS`` times, else as the replay of its
        graph, captured first if it has none. ``sampled``: the body draws
        from the generator."""
        live = self.capture and capture
        entry = self.graphs.get(key) if live else None
        if entry is None:
            n = self.runs.get(key, 0)
            if not live or n < self.EAGER_RUNS:
                self.runs[key] = n + 1
                body()
                return
            entry = self.graphs[key] = self._capture(body, sampled)
        graph, counted = entry
        graph.replay()
        self.replays += 1
        self.replayed[key] = self.replayed.get(key, 0) + 1
        for k, n in counted.items():
            cuda_lib.LAUNCHES[k] += n

    def _capture(self, body, sampled: bool):
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        before = dict(cuda_lib.LAUNCHES)
        try:
            # thread-local: the serving engine's drain threads wait on
            # their copies' events while its scheduler captures
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            counted = {k: n - before.get(k, 0)
                       for k, n in cuda_lib.LAUNCHES.items()
                       if n != before.get(k, 0)}
            cuda_lib.LAUNCHES.update(before)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, counted

    def launches(self, key) -> dict:
        """The wrappers' launch counts one replay of ``key`` adds."""
        return dict(self.graphs[key][1])

    def pool_bytes(self) -> int:
        """Bytes of the allocator's segments in the graphs' shared pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def stats(self) -> dict:
        """Graphs, captures, capture seconds, replays and the pool's bytes;
        the graphs and replays also by the kind of key (its first item:
        "refill", "prefill", "score", or a decode chunk's route)."""
        kinds: dict = {}
        for key in self.graphs:
            k = kinds.setdefault(str(key[0]), {"graphs": 0, "replays": 0})
            k["graphs"] += 1
            k["replays"] += self.replayed.get(key, 0)
        return {"graphs": len(self.graphs), "captures": self.captures,
                "capture_s": self.capture_s, "replays": self.replays,
                "pool_bytes": self.pool_bytes(), "by_kind": kinds}
