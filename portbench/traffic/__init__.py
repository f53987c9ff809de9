"""The general request generator, and the traffic kinds that drive the
program with its requests (one module a kind: ``closed_batch``,
``stream``, ``open_poisson``). A kind has ``build(run)`` (the engine,
from ``run.params``) -> a session, ``warm(run, s)`` (set-up on the cell's
own shapes), ``window(run, s, dtrace)`` -> :class:`Window`, ``tail(run,
s, dtrace)`` (more of the traffic while the device trace runs, traced
runs only), ``engine(s)`` and ``close(s)``.

A cell's workload file (``portbench/workloads/<cell>.json``) names its
kind (``"kind"``) and holds the mix as data under ``"requests"``:

    {"prompt_len": [[share, lo, hi], ...],     # classes, lengths uniform
     "n_predict": {"uniform": [lo, hi]} | {"choices": [...]} | {"value": n},
     "greedy_share": s,                        # the rest is sampled with
     "sampled": {"temp": [lo, hi] | t, "top_k": k, "top_p": p}}

Every seed gets the same set of sizes (``draw_pool``, drawn once from the
fixed ``SIZES_SEED``: prompt lengths, new-token counts,
greedy or sampled, temperatures), with prompt ids of its own
(``stream_rng``); each class and the greedy share are exact counts
(largest remainder). The closed kinds run the sizes in an order of the
seed's own; the open loop keeps the pool's order and its arrival gaps
for every seed (``arrival_gaps``), since the order of a few long
prompts among the arrivals moves a latency tail more than anything the
program does. So two seeds do the same work, on other tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

FIRST_ID = 4   # prompt ids avoid the specials <unk> <s> </s> <pad>
SIZES_SEED = 0   # every seed's sizes and arrival gaps are drawn from this


@dataclass
class Req:
    """One request and what the run saw of it (host ``perf_counter`` s)."""
    prompt: List[int]
    n_predict: int
    greedy: bool
    temp: float = 0.0
    top_k: int = 1
    top_p: float = 1.0
    sample_seed: int = 0
    t_due: float = 0.0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    new_ids: Optional[List[int]] = None
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return (self.error is None and self.new_ids is not None
                and len(self.new_ids) == self.n_predict)


@dataclass
class Window:
    """What one measured window ran: its requests (those due in it), the
    entry calls it made, its host clock marks and the program's counters
    at its edges; the kind may add its own readings to ``extra``."""
    t0: float = 0.0
    t1: float = 0.0                 # the window's close (host perf_counter)
    requests: List[Req] = field(default_factory=list)
    tail: List[Req] = field(default_factory=list)   # served after the close
    calls: List[tuple] = field(default_factory=list)   # (start, end) s
    counters0: dict = field(default_factory=dict)
    counters1: dict = field(default_factory=dict)
    graphs0: dict = field(default_factory=dict)
    graphs1: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)


def stream_rng(seed: int, *stream) -> np.random.Generator:
    """An independent generator for one use of a run's seed (any whole
    number, negative or wider than 64 bits included)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def _exact_counts(shares, n: int) -> List[int]:
    """``n`` split by ``shares`` into whole counts (largest remainder)."""
    raw = [s * n / sum(shares) for s in shares]
    counts = [int(np.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


def _draw_n(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    if "value" in spec:
        return np.full(n, int(spec["value"]), dtype=np.int64)
    if "choices" in spec:
        return rng.choice(np.asarray(spec["choices"], dtype=np.int64), n)
    lo, hi = spec["uniform"]
    return rng.integers(lo, hi + 1, n)


def draw_pool(spec: dict, n: int, part: int = 0) -> List[dict]:
    """``n`` request sizes of the mix ``spec``, drawn from ``SIZES_SEED``
    (``part`` tells a window's sizes, 0, from others the same run needs):
    each a dict of prompt_len, n_predict, greedy, temp, top_k, top_p."""
    rng = stream_rng(SIZES_SEED + part, 0)
    classes = spec["prompt_len"]
    lens = []
    for (_, lo, hi), k in zip(classes, _exact_counts([c[0] for c in classes],
                                                    n)):
        lens.extend(rng.integers(lo, hi + 1, k).tolist())
    lens = rng.permutation(lens).tolist()
    n_new = _draw_n(spec["n_predict"], rng, n).tolist()
    n_greedy = _exact_counts([spec.get("greedy_share", 1.0),
                              1.0 - spec.get("greedy_share", 1.0)], n)[0]
    greedy = rng.permutation([True] * n_greedy + [False] * (n - n_greedy))
    sampled = spec.get("sampled", {})
    temp = sampled.get("temp", 1.0)
    temps = (rng.uniform(temp[0], temp[1], n) if isinstance(temp, list)
             else np.full(n, float(temp)))
    return [{"prompt_len": int(lens[i]), "n_predict": int(n_new[i]),
             "greedy": bool(greedy[i]),
             "temp": 0.0 if greedy[i] else float(temps[i]),
             "top_k": 1 if greedy[i] else int(sampled.get("top_k", 40)),
             "top_p": 1.0 if greedy[i] else float(sampled.get("top_p", 1.0))}
            for i in range(n)]


def spread_greedy(order: List[int], pool: List[dict]) -> List[int]:
    """``order`` with its greedy requests moved to evenly spaced places
    (the others keep their order): any run of n / n_greedy requests then
    holds a greedy one to check, whatever the window's length."""
    greedy = [i for i in order if pool[i]["greedy"]]
    rest = iter([i for i in order if not pool[i]["greedy"]])
    at = {len(order) * j // len(greedy): i for j, i in enumerate(greedy)}
    return [at[k] if k in at else next(rest) for k in range(len(order))]


def make_requests(pool: List[dict], rng: np.random.Generator,
                  n_vocab: int, spread: bool = False,
                  permute: bool = True) -> List[Req]:
    """The pool in the order ``rng`` gives (with ``spread``, its greedy
    requests evenly spaced: :func:`spread_greedy`; without ``permute``, in
    the pool's own order), each with prompt ids and a sampling seed drawn
    from ``rng``."""
    order = (rng.permutation(len(pool)).tolist() if permute
             else list(range(len(pool))))
    if spread:
        order = spread_greedy(order, pool)
    out = []
    for i in order:
        p = pool[i]
        out.append(Req(
            prompt=rng.integers(FIRST_ID, n_vocab, p["prompt_len"]).tolist(),
            n_predict=p["n_predict"], greedy=p["greedy"], temp=p["temp"],
            top_k=p["top_k"], top_p=p["top_p"],
            sample_seed=int(rng.integers(0, 1 << 62))))
    return out


def arrival_gaps(rate: float, n: int, span: float,
                 part: int = 0) -> np.ndarray:
    """``n`` gaps of a Poisson process at ``rate`` a second, drawn from
    ``SIZES_SEED`` (``part`` as in :func:`draw_pool`) and scaled to sum to
    ``span`` seconds (given n arrivals in the span, the gaps of a Poisson
    process)."""
    gaps = stream_rng(SIZES_SEED + part, 1).exponential(1.0 / rate, n)
    return gaps * (span / gaps.sum())


def pow2_buckets(lo: int, hi: int, floor: int = 8) -> List[int]:
    """One prompt length in [lo, hi] for each power-of-two length bucket
    (floor ``floor``) that the range reaches: the bucket's own length, or
    ``hi`` where the range ends inside it."""
    out, b = [], floor
    while True:
        if b >= lo:
            out.append(min(b, hi))
        if b >= hi:
            return out
        b *= 2
