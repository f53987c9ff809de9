"""Replay the production-path golden on the card.

``tests/goldens/gpu347m_seed7_bf16.npz`` (written on the card by
``python -m biogpt_tpu_torch.tools.make_goldens --gpu-bf16``) holds the
Q4_0 and Q4_1 greedy continuations of the production decode path at the
full 347M configuration: packed planes, bf16 compute, the whole-model
decode step and its fused greedy tail. The CPU runs only the kernels'
plain versions, which sum in other orders, so this checker is the
full-size regression lock for the card's kernels: run it after a change
to a kernel or to the engine's graphs.

Each format's engine runs ``generate`` three times: twice eagerly, then
with its prefill key and its decode-chunk keys captured as CUDA graphs and
replayed (``runtime/graphs.py``). Every run must give the golden's ids.
It prints the card the golden was written on beside this one, and, as
information only, how many new ids agree with ``own347m_seed7_quant.npz``
(f32, per op) and ``tpu347m_seed7_bf16.npz`` (the TPU's production
path): neither is an oracle for this path. Exit 0: every run equal; 1: a
run differs; 2: no card or no golden.

Usage (on the card): python -m biogpt_tpu_torch.tools.check_goldens_gpu
    [golden.npz]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .make_goldens import (N_NEW_Q, PROMPT, QTYPES, _goldens_dir,
                           _quant_engine, _state_dict, card_stamp)

GOLDEN = "gpu347m_seed7_bf16.npz"
# other paths' continuations of the same weights: compared, never held
OTHERS = ("own347m_seed7_quant.npz", "tpu347m_seed7_bf16.npz")
RUNS = 3   # eager, eager, captured and replayed (ChunkGraphs.EAGER_RUNS + 1)


def check_engine(eng, want: list) -> dict:
    """``RUNS`` greedy generations of ``PROMPT`` on ``eng`` (a fresh
    engine's graph runner: its keys run eagerly twice, then are captured
    and replayed) -> each run's new ids, whether each equals ``want``'s,
    and whether the last run replayed its prefill and every chunk key
    without running a body eagerly."""
    from ..config import GenerationParams

    gen = GenerationParams(n_predict=N_NEW_Q, temp=0.0, stop_at_eos=False)
    runner, runs = eng.graphs, []
    for _ in range(RUNS):
        eager0, replays0 = sum(runner.runs.values()), dict(runner.replayed)
        runs.append(eng.generate(PROMPT, gen).ids)
    replayed = sorted(str(k[0]) for k, n in runner.replayed.items()
                      if n > replays0.get(k, 0))
    return {"new_ids": [r[len(PROMPT):] for r in runs],
            "equal": [r == want for r in runs],
            "last_run_replayed": (sum(runner.runs.values()) == eager0
                                  and "prefill" in replayed
                                  and "b1" in replayed),
            "replayed_kinds": replayed}


def agreement(new_ids: list, path: str, qname: str):
    """How many of ``new_ids`` equal, position by position, the new ids of
    ``qname`` in the golden at ``path`` (None where it has none)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as g:
        key = f"{qname}_greedy_ids"
        if key not in g.files:
            return None
        other = g[key].tolist()[len(PROMPT):]
    return sum(a == b for a, b in zip(new_ids, other))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(_goldens_dir(), GOLDEN)
    if not os.path.exists(path):
        print(f"error: no golden at {path}: write it on the card with "
              "`python -m biogpt_tpu_torch.tools.make_goldens --gpu-bf16`",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: this checker runs on the card (the CPU runs only "
              "the kernels' plain versions)", file=sys.stderr)
        return 2
    with np.load(path) as g:
        golden = {k: g[k] for k in g.files}
    assert golden["prompt"].tolist() == PROMPT, "golden/recipe prompt drift"
    print(f"golden written on: {golden['device']}; this card: "
          f"{card_stamp()}")
    rc = 0
    sd = _state_dict()
    for qname in QTYPES:
        eng = _quant_engine(qname, torch.bfloat16, pack=True, state_dict=sd)
        if not eng._fused_decode:
            raise RuntimeError("the whole-model decode step must run")
        want = golden[f"{qname}_greedy_ids"].tolist()
        got = check_engine(eng, want)
        ok = all(got["equal"]) and got["last_run_replayed"]
        rc |= 0 if ok else 1
        print(f"{qname}: {'OK' if ok else 'MISMATCH'} runs equal "
              f"{got['equal']}, last run replayed {got['replayed_kinds']} "
              f"({got['last_run_replayed']}); want {want[len(PROMPT):]}")
        for i, ids in enumerate(got["new_ids"]):
            print(f"  run {i}: {ids}")
        info = {o: agreement(got["new_ids"][-1], os.path.join(
            os.path.dirname(path), o), qname) for o in OTHERS}
        print(f"  new ids agreeing (information only, of {N_NEW_Q}): "
              + ", ".join(f"{o} {n}" for o, n in info.items()))
        del eng
    return rc


if __name__ == "__main__":
    sys.exit(main())
