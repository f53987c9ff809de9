"""The general request generator: the same seed gives the same requests,
every seed the same sizes in another order, and the sizes follow the
mix's stated distributions."""

import numpy as np
import pytest

from portbench.traffic import (arrival_gaps, draw_pool, make_requests,
                               pow2_buckets, stream_rng)

MIX = {"prompt_len": [[0.6, 5, 25], [0.25, 100, 124], [0.15, 300, 380]],
       "n_predict": {"choices": [16, 32, 48, 64, 96]},
       "greedy_share": 0.25,
       "sampled": {"temp": [0.7, 1.0], "top_k": 40, "top_p": 0.9}}


def sizes(reqs):
    return sorted((len(r.prompt), r.n_predict, r.greedy, r.temp) for r in reqs)


def test_same_seed_same_requests():
    pool = draw_pool(MIX, 200, 0)
    a = make_requests(pool, stream_rng(2**40 + 7, 1), 42384)
    b = make_requests(draw_pool(MIX, 200, 0), stream_rng(2**40 + 7, 1), 42384)
    assert [(r.prompt, r.n_predict, r.temp, r.sample_seed) for r in a] == \
        [(r.prompt, r.n_predict, r.temp, r.sample_seed) for r in b]


@pytest.mark.parametrize("seeds", [(1, 2), (0, 2**33 + 5), (-3, 17)])
def test_seeds_share_sizes_in_another_order(seeds):
    pool = draw_pool(MIX, 300, 0)
    a, b = (make_requests(pool, stream_rng(s, 1), 42384) for s in seeds)
    assert sizes(a) == sizes(b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_mix_follows_its_distributions():
    n = 4000
    pool = draw_pool(MIX, n, 3)
    lens = np.array([p["prompt_len"] for p in pool])
    counts = [((lens >= lo) & (lens <= hi)).sum() for _, lo, hi in
              MIX["prompt_len"]]
    assert counts == [2400, 1000, 600]           # exact shares
    assert sum(p["greedy"] for p in pool) == 1000
    short = lens[lens <= 25]
    assert abs(short.mean() - 15.0) < 0.5        # uniform 5..25
    assert set(np.unique(short)) == set(range(5, 26))
    new = np.array([p["n_predict"] for p in pool])
    assert set(new) == {16, 32, 48, 64, 96}
    assert all(abs((new == v).mean() - 0.2) < 0.03 for v in set(new))
    temps = np.array([p["temp"] for p in pool if not p["greedy"]])
    assert temps.min() >= 0.7 and temps.max() <= 1.0
    assert abs(temps.mean() - 0.85) < 0.01
    assert all(p["temp"] == 0.0 and p["top_k"] == 1 for p in pool
               if p["greedy"])
    assert all(p["top_k"] == 40 and p["top_p"] == 0.9 for p in pool
               if not p["greedy"])


def test_uniform_and_fixed_lengths():
    pool = draw_pool({"prompt_len": [[1.0, 4, 32]],
                      "n_predict": {"uniform": [128, 384]}}, 5000, 0)
    new = np.array([p["n_predict"] for p in pool])
    assert new.min() == 128 and new.max() == 384
    assert abs(new.mean() - 256.0) < 3.0
    assert all(p["greedy"] for p in pool)
    fixed = draw_pool({"prompt_len": [[1.0, 8, 32]],
                       "n_predict": {"value": 200}, "greedy_share": 0.125,
                       "sampled": {"temp": 0.9, "top_k": 40, "top_p": 0.9}},
                      64, 0)
    assert {p["n_predict"] for p in fixed} == {200}
    assert sum(p["greedy"] for p in fixed) == 8
    assert {p["temp"] for p in fixed if not p["greedy"]} == {0.9}


def test_greedy_requests_spread_evenly():
    pool = draw_pool({"prompt_len": [[1.0, 8, 32]], "n_predict": {"value": 9},
                      "greedy_share": 0.125,
                      "sampled": {"temp": 0.9, "top_k": 40, "top_p": 0.9}},
                     64, 0)
    a, b = (make_requests(pool, stream_rng(s, 1), 500, spread=True)
            for s in (5, 6))
    assert [i for i, r in enumerate(a) if r.greedy] == list(range(0, 64, 8))
    assert sizes(a) == sizes(b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_prompt_ids_avoid_specials():
    reqs = make_requests(draw_pool(MIX, 100, 0), stream_rng(5, 1), 300)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 4 and ids.max() < 300


def test_arrivals_fill_the_span_as_a_poisson_process():
    a = arrival_gaps(100.0, 5000, 50.0, 0)
    assert a.sum() == pytest.approx(50.0)
    assert abs(a.mean() - 0.01) < 1e-12
    assert abs(a.std() / a.mean() - 1.0) < 0.05    # exponential gaps
    assert list(a) == list(arrival_gaps(100.0, 5000, 50.0, 0))
    assert list(a) != list(arrival_gaps(100.0, 5000, 50.0, 1))


def test_kept_order_gives_every_seed_the_same_schedule():
    pool = draw_pool(MIX, 300, 0)
    a, b = (make_requests(pool, stream_rng(s, 1), 42384, permute=False)
            for s in (1, 2))
    assert [(len(r.prompt), r.n_predict, r.greedy, r.temp) for r in a] == \
        [(len(r.prompt), r.n_predict, r.greedy, r.temp) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in b]


@pytest.mark.parametrize("lo,hi,want", [(4, 32, [8, 16, 32]),
                                         (5, 25, [8, 16, 25]),
                                         (100, 124, [124]),
                                         (300, 380, [380]),
                                         (8, 9, [8, 9])])
def test_pow2_buckets(lo, hi, want):
    assert pow2_buckets(lo, hi) == want
