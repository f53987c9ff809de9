"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the window's finished requests, drawn from the run's seed, is run through
the reference (float32, TF32 off) over its prompt and its served tokens,
once each: ``sample_requests`` greedy ones and, where the mix samples,
``sample_sampled`` sampled ones, the longest of each kind always among
them. At each served token the reference's logits there judge it:

- a greedy token by its gap, the reference's best logit minus its logit
  of the served token: 0 where the two agree, and at most the reference's
  own margin between them where rounding picked the other of a near tie.
  The widest gap is held to ``gap_limit``.
- a sampled token by the distribution ``q`` that its request asked for,
  worked out from the reference's logits (over the temperature, the top-k,
  the top-p nucleus, renormalised):
  - its top-k gap, the reference's k-th best logit less its logit of the
    token, 0 inside the top-k (a sampler that ignores the top-k reads the
    logit distance; a near tie at the edge reads rounding). The widest is
    held to ``topk_gap_limit``.
  - its mid-rank ``u``: ``q``'s mass ranked before the token plus half the
    token's own (1 where ``q`` gives it nothing). Drawn from ``q``, ``u``
    has the mean 1/2 exactly and a variance that ``q`` gives, so over the
    sample z = sum(u - 1/2) / sqrt(sum var) stays at the size of one
    standard normal draw, while tokens drawn from another distribution
    (argmax, the top-p or the temperature ignored) move it in proportion
    to the root of their number. ``|z|`` is held to ``pit_z_limit``.

A request that the window never finished, or that came back short, is a
fault of its own, and a run compares at least ``min_tokens`` greedy and
``min_sampled_tokens`` sampled tokens.

The control (:func:`control_source`) is the reference put in the
program's place in fp8: at each position of the same prompts and tokens,
the token it puts first for a greedy request and its own draw from its
``q`` for a sampled one, judged by the same numbers and verdict. The
faults (:data:`FAULTS`) are samplers that leave out part of a request's
sampling, applied to the reference's own logits.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .traffic import Req, stream_rng


def sample(reqs: List[Req], seed: int, k: int, greedy: bool = True,
           stream: int = 99) -> List[Req]:
    """Up to ``k`` of the finished greedy (or sampled) requests, drawn from
    ``seed``, the longest (prompt and new tokens) always among them."""
    pool = [r for r in reqs if r.greedy == greedy and r.done]
    if not pool or k <= 0:
        return []
    longest = max(range(len(pool)),
                  key=lambda i: len(pool[i].prompt) + len(pool[i].new_ids))
    rest = [i for i in range(len(pool)) if i != longest]
    pick = stream_rng(seed, stream).permutation(rest)[:k - 1].tolist()
    return [pool[i] for i in [longest] + pick]


def filtered(z, top_k: int, top_p: float, temp: float):
    """The distribution a sampled request asks for at each of ``z``'s rows
    (n, V) of logits: (q (n, K), ids (n, K)), ``q`` in descending order,
    K = min(top_k, V); the top-p nucleus keeps each token whose mass ranked
    before it is under ``top_p``."""
    import torch

    vals, ids = torch.topk(z, min(top_k, z.shape[-1]), dim=-1)
    q = torch.softmax(vals / max(temp, 1e-8), dim=-1)
    if top_p < 1.0:
        q = torch.where(torch.cumsum(q, -1) - q < top_p, q,
                        torch.zeros_like(q))
        q = q / q.sum(-1, keepdim=True)
    return q, ids


def sampled_terms(z, tok, r: Req):
    """Over one request's positions: the widest top-k gap, sum(u - 1/2)
    and sum(var u) of the tokens ``tok`` (n,) under the request's ``q``."""
    import torch

    q, ids = filtered(z, r.top_k, r.top_p, r.temp)
    kth = z.gather(1, ids[:, -1:])[:, 0]
    zs = z.gather(1, tok[:, None])[:, 0]
    gap = float(torch.clamp_min(kth - zs, 0.0).max())
    mid = torch.cumsum(q, -1) - q / 2
    var = (q * mid * mid).sum(-1) - 0.25
    hit = (ids == tok[:, None]) & (q > 0)
    u = torch.where(hit.any(-1), (mid * hit).sum(-1),
                    torch.ones_like(mid[:, 0]))
    return gap, float((u - 0.5).sum()), float(var.sum())


# source(r, z, ids) -> the tokens (n,) to judge at the n positions of a
# request whose served ids are ``ids``; ``z`` the reference's logits there
Source = Callable


def served(r: Req, z, ids):
    import torch

    return torch.as_tensor(r.new_ids, device=z.device)


def _draw(q, ids, gen):
    import torch

    pick = torch.multinomial(q, 1, generator=gen)
    return ids.gather(1, pick)[:, 0]


def _generator(device, seed: int, stream: int):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(stream_rng(seed, stream).integers(1 << 62)))
    return g


def control_source(ref, seed: int) -> Source:
    """The reference in fp8 in the program's place: its greedy pick, or
    its draw from its own ``q``, at each position of the served ids."""
    gens = {}

    def source(r: Req, z, ids):
        low = ref.logits(ids[:-1], fp8=True)[len(r.prompt) - 1:]
        if r.greedy:
            return low.argmax(dim=-1)
        g = gens.setdefault(z.device, _generator(z.device, seed, 97))
        return _draw(*filtered(low, r.top_k, r.top_p, r.temp), g)
    return source


def _fault(no_top_k=False, no_top_p=False, temp=None, argmax=False):
    def make(seed: int) -> Source:
        gens = {}

        def source(r: Req, z, ids):
            if r.greedy:
                return served(r, z, ids)
            if argmax:
                return z.argmax(dim=-1)
            g = gens.setdefault(z.device, _generator(z.device, seed, 96))
            return _draw(*filtered(
                z, z.shape[-1] if no_top_k else r.top_k,
                1.0 if no_top_p else r.top_p, temp or r.temp), g)
        return source
    return make


# samplers that leave out part of a sampled request's sampling
FAULTS: Dict[str, Callable[[int], Source]] = {
    "argmax": _fault(argmax=True),
    "top_k_ignored": _fault(no_top_k=True),
    "top_p_ignored": _fault(no_top_p=True),
    "temp_1": _fault(temp=1.0),
}


def compare(ref, reqs: List[Req],
            sources: Optional[Dict[str, Source]] = None) -> Dict[str, dict]:
    """The numbers of ``reqs`` under ``ref`` for each source of tokens
    (default: the served ones, ``"program"``): the widest greedy gap
    (``max_gap``), the greedy tokens compared, and for the sampled requests
    the widest top-k gap, ``pit_z`` and the sampled tokens compared."""
    import torch

    sources = sources or {"program": served}
    acc = {k: dict(max_gap=0.0, tokens=0, topk=0.0, du=0.0, var=0.0, ns=0)
           for k in sources}
    for r in reqs:
        ids = r.prompt + r.new_ids
        with torch.no_grad():
            z = ref.logits(ids[:-1])[len(r.prompt) - 1:]
            for name, source in sources.items():
                tok = source(r, z, ids)
                a = acc[name]
                if r.greedy:
                    gap = z.max(dim=-1).values - z.gather(1, tok[:, None])[:, 0]
                    a["max_gap"] = max(a["max_gap"], float(gap.max()))
                    a["tokens"] += len(r.new_ids)
                else:
                    gap, du, var = sampled_terms(z, tok, r)
                    a["topk"] = max(a["topk"], gap)
                    a["du"] += du
                    a["var"] += var
                    a["ns"] += len(r.new_ids)
    return {name: {"max_gap": a["max_gap"], "tokens": a["tokens"],
                   "sampled_topk_gap": a["topk"],
                   "sampled_pit_z": (abs(a["du"]) / np.sqrt(a["var"])
                                     if a["var"] > 0 else 0.0),
                   "sampled_tokens": a["ns"], "requests": len(reqs)}
            for name, a in acc.items()}


def picked(reqs: List[Req], seed: int, c: dict) -> List[Req]:
    """The requests a run compares (the cell's ``check`` block ``c``)."""
    return (sample(reqs, seed, c["sample_requests"], greedy=True)
            + sample(reqs, seed, c.get("sample_sampled", 0), greedy=False,
                     stream=98))


def verdict(window_reqs: List[Req], nums: dict, c: dict) -> dict:
    """The comparisons of a run, each a number beside its limit (from the
    cell's ``check`` block ``c``), and whether every one holds."""
    missing = sum(1 for r in window_reqs if not r.done)
    checks = {
        "max_logit_gap": [nums["max_gap"], "<=", c["gap_limit"]],
        "tokens_compared": [nums["tokens"], ">=", c["min_tokens"]],
        "requests_unfinished": [missing, "<=", 0],
    }
    if c.get("sample_sampled"):
        checks.update({
            "sampled_topk_gap": [nums["sampled_topk_gap"], "<=",
                                 c["topk_gap_limit"]],
            "sampled_pit_z": [nums["sampled_pit_z"], "<=", c["pit_z_limit"]],
            "sampled_tokens_compared": [nums["sampled_tokens"], ">=",
                                        c["min_sampled_tokens"]],
        })
    ok = all(np.isfinite(v) and (v <= lim if op == "<=" else v >= lim)
             for v, op, lim in checks.values())
    return {"correct": bool(ok), "checks": checks}
