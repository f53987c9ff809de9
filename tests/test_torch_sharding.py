"""The port's data axis and its route of unpacked weights (the JAX
package's GSPMD route) against the JAX package, on the CPU.

- the shards of ``parallel.sharding.shard_params`` for every rank of a
  (1, 4) and a (2, 2) mesh, dense and Q4_0, against the addressable shards
  of JAX ``shard_params(params, make_mesh(d, m))`` on the virtual CPU
  devices: equal wherever JAX shards every plane of a weight, and the
  port's rule (a weight whole where a plane does not divide) elsewhere;
- a slot's results on the packed TP route at a local batch of 16 against
  32 (a (2, 2) replica's against a (1, 2) mesh's), by ``chip_smoke.py``'s
  ``local_batch_probe`` on the plain versions: they differ only through
  the form of the refill's last-token lm_head product; a data-axis
  replica's share of a refill group (2 of 4 prompts padded to 8) takes
  the group's form in every product, on the packed TP route and on the
  route of unpacked weights, and its replicas' first tokens and cache
  rows are the JAX (2, 1) mesh engine's;
- four gloo ranks (processes started through the port's launcher,
  ``python -m biogpt_tpu_torch.parallel.distributed``, sharing one run for
  every multi-rank case): ``Engine.score`` on the sharded route at (1, 4)
  and (2, 2), the int8-KV ``generate`` with 2 heads over 4 ranks,
  ``generate`` at (4, 1) and (2, 2), ``BatchedEngine`` serves at (2, 2)
  per op and through the TP step's halves (bf16 and int8 KV) with their
  data-axis exchanges counted, the sampled paths of ``tests/
  _dist_worker.py``'s model mode, and a ``DistributedScheduler`` serve,
  against the JAX mesh engines.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.config import GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.parallel import make_mesh as jax_mesh
from biogpt_tpu.parallel import shard_params as jax_shard_params
from biogpt_tpu.quant import codecs
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatched
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.parallel import shard_params
from biogpt_tpu_torch.parallel.mesh import Mesh
from biogpt_tpu_torch.parallel.sharding import shard_layout
from biogpt_tpu_torch.quant.layouts import QuantizedTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q4_0 = codecs.GGML_TYPE_Q4_0
TINY = BioGptConfig.tiny()      # 4 heads, d_model 64, d_ff 128, vocab 256
# tests/test_kv_quant.py: 2 heads, which 4 ranks do not divide
KVQ = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=3,
                        n_vocab=256, n_positions=64)
# tests/_dist_worker.py's model mode
W128 = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=4, n_layer=2,
                         n_vocab=256, n_positions=64)
# tests/test_torch_tp.py's: local widths the TP step's halves take
TP = BioGptConfig.tiny(d_model=512, d_ff=512, n_head=8, n_layer=2,
                       n_vocab=300, n_positions=64)
SCORE_IDS = np.array([[2, 10, 25, 48, 7, 31, 5, 99],
                      [2, 14, 3, 77, 41, 9, 130, 6]])
SERVE_PROMPTS = ([2, 5, 9], [2, 11, 30, 41, 8], [2, 7])   # test_serving:298
TP_PROMPTS = ([2, 41, 7], [2, 19, 3, 8], [2, 5], [2, 60, 11, 4, 90],
              [2, 33], [2, 8, 8, 21])


def _torch_cfg(cfg):
    return TorchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(TorchConfig)})


def _params(cfg, seed, qtype=None):
    return params_from_state_dict(make_state_dict(cfg, seed=seed), cfg,
                                  qtype=qtype)


# ------------------------------------------------------ shards, in process

def _planes(leaf):
    if isinstance(leaf, QuantizedTensor) or hasattr(leaf, "levels"):
        return [p for p in (leaf.levels, leaf.scales, leaf.mins)
                if p is not None]
    return [leaf]


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (k,))
    else:
        yield path


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("qtype", [None, Q4_0], ids=["f32", "q4_0"])
@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_shards_match_jax_addressable_shards(data, model, qtype):
    """Every rank's ``shard_params`` leaf against JAX's shard on the
    device at the same (data, model) position: the same bytes wherever JAX
    shards every plane of the leaf, else the whole leaf. At (1, 4) Q4_0,
    o's 2 scale rows do not divide 4, so JAX shards o's levels only and
    the port keeps o whole; every other weight is a shard."""
    pj = _params(TINY, 11, qtype)
    pt = params_from_numpy(pj, "cpu")
    mesh = jax_mesh(data, model)
    jsh = jax_shard_params(pj, mesh)
    n_shards = 0
    for di in range(data):
        for mi in range(model):
            dev = mesh.devices[di, mi]
            own = shard_params(pt, Mesh(data, model, mi, None,
                                        torch.device("cpu"), di))
            for path in _paths(pt):
                locals_ = [np.asarray(next(s.data for s in w.addressable_shards
                                           if s.device == dev))
                           for w in _planes(_at(jsh, path))]
                got, whole = _planes(_at(own, path)), _planes(_at(pt, path))
                if all(a.shape != tuple(w.shape)
                       for a, w in zip(locals_, whole)):
                    n_shards += 1
                    for g, a in zip(got, locals_):
                        assert np.array_equal(g.numpy(), a), path
                else:
                    for g, w in zip(got, whole):
                        assert torch.equal(g, w), path
    # on every rank: q, k, v and fc1 (weights and biases), fc2, the
    # lm_head, and o unless its scales do not divide
    whole_o = model == 4 and qtype is not None
    assert n_shards == data * model * (11 - whole_o)
    layout = shard_layout(pt, _torch_cfg(TINY),
                          Mesh(data, model, 0, None, torch.device("cpu")))
    assert ("o" not in layout.sharded) == whole_o
    assert layout.sharded | {"o"} == {"q", "k", "v", "o", "fc1", "fc2",
                                      "lm_head"}
    assert layout.heads


def test_layout_rule_on_heads_and_packing():
    """2 heads over 4 ranks: q, k, v are shards (their columns divide) but
    attention runs on every head; packed planes, whose rows interleave,
    are refused."""
    from biogpt_tpu_torch.quant.layouts import pack_nibble_planes

    mesh = Mesh(1, 4, 0, None, torch.device("cpu"))
    pt = params_from_numpy(_params(KVQ, 5), "cpu")
    layout = shard_layout(pt, _torch_cfg(KVQ), mesh)
    assert {"q", "k", "v", "fc1", "fc2", "lm_head", "o"} == layout.sharded
    assert not layout.heads
    pq = params_from_numpy(_params(W128, 11, Q4_0), "cpu")
    pq["layers"]["o"] = dict(pq["layers"]["o"],
                             w=pack_nibble_planes(pq["layers"]["o"]["w"]))
    with pytest.raises(ValueError, match="packed planes"):
        shard_layout(pq, _torch_cfg(W128), mesh)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_shard_cache_matches_jax(data, model, quant):
    """``shard_cache`` of a whole (L, 4, S, D) cache on every rank: JAX
    ``shard_cache``'s addressable shard (B over "data", D over "model",
    an int8 cache's scale planes whole over "model"); with attention on
    every head (``Layout.heads`` False) the features stay whole."""
    from biogpt_tpu.parallel import shard_cache as jax_shard_cache
    from biogpt_tpu.runtime.cache import KVCache as JaxKV
    from biogpt_tpu.runtime.cache import QuantKVCache as JaxQKV
    from biogpt_tpu_torch.parallel import shard_cache
    from biogpt_tpu_torch.parallel.sharding import Layout
    from biogpt_tpu_torch.runtime.cache import KVCache, QuantKVCache

    rng = np.random.RandomState(data * 10 + model)
    L, B, S, D = 2, 4, 8, 64
    if quant:
        planes = [rng.randint(-127, 128, (L, B, S, D)).astype(np.int8)
                  for _ in range(2)]
        planes += [rng.rand(L, B, 1, S).astype(np.float32) for _ in range(2)]
        jc, tc = JaxQKV(*planes), QuantKVCache(*map(torch.from_numpy, planes))
    else:
        planes = [rng.randn(L, B, S, D).astype(np.float32) for _ in range(2)]
        jc, tc = JaxKV(*planes), KVCache(*map(torch.from_numpy, planes))
    mesh = jax_mesh(data, model)
    jsh = jax_shard_cache(jc, mesh)
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    for di in range(data):
        for mi in range(model):
            own = Mesh(data, model, mi, None, torch.device("cpu"), di)
            dev = mesh.devices[di, mi]
            got = shard_cache(tc, own, Layout(frozenset(), heads=True))
            whole_d = shard_cache(tc, own, Layout(frozenset(), heads=False))
            for n in names:
                want = next(s.data for s in getattr(jsh, n).addressable_shards
                            if s.device == dev)
                assert np.array_equal(getattr(got, n).numpy(),
                                      np.asarray(want)), n
                assert getattr(whole_d, n).shape[-1] == planes[
                    names.index(n)].shape[-1]
                assert getattr(whole_d, n).shape[1] == B // data


def test_sharded_route_calls_no_kernel(monkeypatch):
    """The forward of the route of unpacked weights runs no kernel even
    when its caller allows them (JAX's ``allow_pallas`` is off on its
    GSPMD route): with every kernel entry of ``ops.qmatmul`` made to
    raise, a Q8_0 model (whose unpacked planes the M <= 8 kernel's gate
    takes) scores through it on a (1, 1) mesh as the single device does."""
    from biogpt_tpu_torch.ops import qmatmul as ops_qmatmul
    from biogpt_tpu_torch.parallel.sharding import make_sharded_forward
    from biogpt_tpu_torch.runtime.cache import init_cache

    def refuse(*a, **k):
        raise AssertionError("a kernel entry was called")
    for name in ("qmatmul", "qmatmul_wide"):
        monkeypatch.setattr(ops_qmatmul, name, refuse)
    cfg = _torch_cfg(TINY)
    pt = params_from_numpy(_params(TINY, 11, codecs.GGML_TYPE_Q8_0), "cpu")
    mesh = Mesh(1, 1, 0, None, torch.device("cpu"))
    fwd = make_sharded_forward(mesh, shard_layout(pt, cfg, mesh))
    ids = torch.from_numpy(SCORE_IDS[:, :4])
    got, _ = fwd(shard_params(pt, mesh), ids, init_cache(cfg, batch=2,
                                                          max_len=4), 0, cfg,
                 allow_kernels=True, logits_mode="all")
    from biogpt_tpu_torch.models.biogpt import forward
    want, _ = forward(pt, ids, init_cache(cfg, batch=2, max_len=4), 0, cfg,
                      allow_kernels=False, logits_mode="all")
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_slot_results_depend_on_local_batch_at_refill_lm_head(monkeypatch,
                                                              kv):
    """Whether a slot's results on the packed TP route depend on its
    replica's local batch (16 slots a replica of a (2, 2) mesh, 32 on a
    (1, 2) one), on the plain versions, through ``chip_smoke.py``'s
    ``local_batch_probe`` (the card runs it in phase 11a): a refill of 32
    prompts and of their first 16 through the TP forward, then 2 TP steps
    (the step's halves) from the same cache rows. The refill's last-token
    lm_head is a product of ``local batch`` rows, block-accumulated below
    ``_DEQUANT_M_ROWS`` (32) and dequantize-then-dot at it, so the first
    tokens' logits differ in their rounding; the refill's cache rows and
    the steps' logits are bit-equal, and the probe's op-by-op comparison
    names the lm_head as the first op that differs. As a data-axis
    replica's 16 rows of the 32-row group (``logits_rows=32``, as the
    serve's refill runs them) the lm_head takes the group's form and every
    op is bit-equal; so it is with that threshold at 16: here the
    lm_head's form is the only dependence."""
    import importlib
    import sys

    from biogpt_tpu_torch.ops import qmatmul as ops_qmatmul
    from biogpt_tpu_torch.parallel import tp as tp_mod
    from biogpt_tpu_torch.runtime.serving import BatchedEngine

    sys.path.insert(0, REPO)
    chip_smoke = importlib.import_module("chip_smoke")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = _torch_cfg(TP)
    eng = BatchedEngine(cfg, params_from_numpy(_params(TP, 3, Q4_0), "cpu"),
                        max_batch=32, max_seq=64, chunk=16, device="cpu",
                        mesh=Mesh(1, 1, 0, None, torch.device("cpu")),
                        tp_fused_decode=True, kv_quant=kv == "int8")
    fused = []
    body = tp_mod._fused_decode_body
    monkeypatch.setattr(tp_mod, "_fused_decode_body",
                        lambda *a, **k: fused.append(1) or body(*a, **k))
    got = chip_smoke.local_batch_probe(eng, np.random.default_rng(6))
    assert len(fused) == 4
    # dequantize-then-dot rounds the dequantized weight to bf16 once
    refill = got.pop("refill_logits")
    assert not refill["equal"] and refill["max_abs_diff"] < 1e-2
    held = [k for k in got if k.startswith(("refill_cache", "step"))]
    assert len(held) == 4 + 2 * (kv == "int8")
    assert all(got[k]["equal"] for k in held), got
    assert got["layers_k_v_bit_equal"] == [True] * cfg.n_layer
    # the probe names the op: the lm_head, one product in two forms
    ops = got["ops"]
    assert ops["first_differing"]["op"] == "matmul / einsum", ops
    assert ops["first_differing"]["layer"] == cfg.n_layer
    assert ops["bit_equal_ops"] == ops["first_differing"]["call"]
    # as a replica's share of the 32-row group (the serve's refill passes
    # the group's rows) the lm_head takes the group's form: all bit-equal
    got = chip_smoke.local_batch_probe(eng, np.random.default_rng(6),
                                       replica=True)
    assert all(got[k]["equal"] for k in got
               if k.startswith(("refill", "step"))), got
    assert got["ops"]["first_differing"] is None
    monkeypatch.setattr(ops_qmatmul, "_DEQUANT_M_ROWS", 16)
    got = chip_smoke.local_batch_probe(eng, np.random.default_rng(6))
    assert all(got[k]["equal"] for k in got
               if k.startswith(("refill", "step"))), got
    assert got["ops"]["first_differing"] is None
    assert got["ops"]["bit_equal_ops"] == got["ops"]["ops"]


def _replica(cfg, params, route, data_index):
    """One replica's ``BatchedEngine`` of a (2, 1) mesh (f32, 4 slots), in
    process: its model axis has one rank, so no collective runs."""
    from biogpt_tpu_torch.runtime.serving import BatchedEngine

    return BatchedEngine(cfg, params, max_batch=4, max_seq=16, chunk=4,
                         compute_dtype=torch.float32,
                         cache_dtype=torch.float32, pack_q4=route == "tp",
                         device="cpu",
                         mesh=Mesh(2, 1, 0, None, torch.device("cpu"),
                                   data_index))


@pytest.mark.parametrize("route", ["tp", "sharded"])
def test_replica_refill_takes_the_groups_form_in_every_product(monkeypatch,
                                                               route):
    """A refill group of 4 prompts padded to 8 tokens has 32 rows x tokens
    (``_DEQUANT_M_ROWS``: every product dequantize-then-dot); a replica of
    a (2, 1) mesh owns 2 of them, 16 rows x tokens, which on their own take
    the block-accumulated form. On the packed TP route and on the route of
    unpacked weights (f32), through ``chip_smoke.py``'s
    ``local_batch_probe`` (the card runs it in phase 11a): the replica's
    2 rows as its share of the group (``group_rows``, as ``_refill_body``
    runs them) against the whole group's refill, every op bit-equal (a
    form chosen by the local rows differs from layer 0's qkv product on).
    Then each replica's ``_prefill_group`` of four greedy requests into
    slots 0-3 against the JAX ``BatchedEngine(mesh=make_mesh(2, 1))``'s
    refill: first tokens equal, the refilled cache rows within the
    file's rtol/atol 2e-5."""
    import importlib
    import sys

    from biogpt_tpu_torch.config import GenerationParams
    from biogpt_tpu_torch.runtime.serving import Request

    sys.path.insert(0, REPO)
    chip_smoke = importlib.import_module("chip_smoke")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cfg = _torch_cfg(W128)
    pj = _params(W128, 11, Q4_0)
    pt = params_from_numpy(pj, "cpu")
    eng = _replica(cfg, pt, route, 0)
    assert eng.B_local == 2
    got = chip_smoke.local_batch_probe(eng, np.random.default_rng(8),
                                       steps=0, replica=True, rows=4,
                                       padded=8)
    assert got["ops"]["first_differing"] is None, got["ops"]
    assert got["ops"]["bit_equal_ops"] == got["ops"]["ops"] > 0
    assert all(got[k]["equal"] for k in got if k.startswith("refill")), got
    assert got["layers_k_v_bit_equal"] == [True] * cfg.n_layer

    prompts = ([2, 41, 7], [2, 19, 3, 8, 5, 60], [2, 5], [2, 60, 11, 4])
    firsts, rows = [], []
    for d in (0, 1):
        eng = _replica(cfg, pt, route, d)
        st, cache = eng._slots(), eng._pool_cache()
        eng._prefill_group(
            [(s, Request(prompt_ids=list(p), n_predict=4, request_id=s))
             for s, p in enumerate(prompts)], cache, eng.generator,
            GenerationParams(temp=0.0, stop_at_eos=False), st)
        firsts += st.first_buf.tolist()
        rows += [cache.k[:, :, :8].numpy(), cache.v[:, :, :8].numpy()]
    je = JaxBatched(W128, pj, max_batch=4, max_seq=16, chunk=4,
                    compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                    pack_q4=route == "tp", mesh=jax_mesh(2, 1))
    i32 = dict(dtype=jnp.int32)
    slot_state = (jnp.zeros((4, 1), **i32), jnp.zeros((4,), **i32),
                  jnp.zeros((4,), **i32), jnp.zeros((4,), jnp.float32),
                  jnp.ones((4,), jnp.float32), jnp.ones((4,), **i32))
    cache_j, vec_j, _, _ = je._prefill_group(
        [(s, JaxRequest(prompt_ids=list(p), n_predict=4, request_id=s))
         for s, p in enumerate(prompts)], je.new_cache(),
        jax.random.PRNGKey(0), JaxGen(temp=0.0, stop_at_eos=False),
        slot_state)
    assert firsts == np.asarray(vec_j[2]).tolist()
    k_j, v_j = (np.asarray(t)[:, :, :8] for t in (cache_j.k, cache_j.v))
    for d in (0, 1):
        np.testing.assert_allclose(rows[2 * d], k_j[:, 2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(rows[2 * d + 1], v_j[:, 2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- four gloo ranks

_RANKS = r'''
"""One gloo rank of tests/test_torch_sharding.py's multi-rank cases (run
under python -m biogpt_tpu_torch.parallel.distributed)."""
import sys

import torch

from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.ops import decode_tp_kernels
from biogpt_tpu_torch.parallel import make_mesh
from biogpt_tpu_torch.parallel.mesh import Mesh
from biogpt_tpu_torch.runtime.dist_serving import DistributedScheduler
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

torch.set_num_threads(1)
inp = torch.load(sys.argv[1], weights_only=False)
meshes = {(1, 4): make_mesh(1, 4, device="cpu"),
          (2, 2): make_mesh(2, 2, device="cpu"),
          (4, 1): make_mesh(4, 1, device="cpu")}
m22 = meshes[(2, 2)]
out = {"place": {k: (m.data_index, m.index) for k, m in meshes.items()}}
f32, cpu = torch.float32, "cpu"
greedy = GenerationParams(temp=0.0, stop_at_eos=False)

# data-axis exchanges, told apart by where they run, and the TP step's
# FFN halves (their plain versions here)
counts = {"chunk": 0, "wave": 0, "waves": 0, "halves": 0, "in_chunk": False}
real_gather = Mesh.gather_data
real_chunk = BatchedEngine._run_chunk
real_split = BatchedEngine._split_refill_groups
real_ffn = decode_tp_kernels.tp_ffn_half_plain


def ffn(*a, **k):
    counts["halves"] += 1
    return real_ffn(*a, **k)


def gather(self, x, dim=0):
    counts["chunk" if counts["in_chunk"] else "wave"] += 1
    return real_gather(self, x, dim)


def run_chunk(self, *a, **k):
    counts["in_chunk"] = True
    try:
        return real_chunk(self, *a, **k)
    finally:
        counts["in_chunk"] = False


def split(self, pairs):
    counts["waves"] += 1
    return real_split(self, pairs)


Mesh.gather_data = gather
BatchedEngine._run_chunk = run_chunk
BatchedEngine._split_refill_groups = split
decode_tp_kernels.tp_ffn_half_plain = ffn


def serve(eng, prompts, n_predict, gen=greedy):
    for k in ("chunk", "wave", "waves", "halves"):
        counts[k] = 0
    res = eng.serve([Request(prompt_ids=list(p), n_predict=n_predict,
                             request_id=i) for i, p in enumerate(prompts)],
                    gen)
    return {"ids": {i: r.ids for i, r in res.items()},
            "chunks": eng.metrics.snapshot()["chunks_launched"],
            "counts": dict(counts), "cache": tuple(eng.new_cache().k.shape),
            "B_local": eng.B_local}


# the sharded route: score at (1, 4) and (2, 2), dense and Q4_0 unpacked
for mk in ((1, 4), (2, 2)):
    for kind in ("f32", "q4_0"):
        eng = Engine(inp["tiny"], inp[f"tiny_{kind}"], compute_dtype=f32,
                     pack_q4=False, mesh=meshes[mk], device=cpu)
        assert not eng.allow_kernels and not eng._tp_fused
        out[("score", mk, kind)] = eng.score(inp["score_ids"])

# int8 KV on the sharded route, 2 heads over 4 ranks
eng = Engine(inp["kvq"], inp["kvq_f32"], compute_dtype=f32, kv_quant=True,
             mesh=meshes[(1, 4)], device=cpu)
gen8 = GenerationParams(n_predict=8, temp=0.0, stop_at_eos=False)
out["kvq"] = (eng.generate([2, 10, 25, 48], gen8).ids,
              tuple(eng.new_cache().k.shape), eng._kv_shards)

# generate at (4, 1) and (2, 2) (the packed TP route, B=1 on every replica)
gen6 = GenerationParams(n_predict=6, temp=0.0, stop_at_eos=False)
for mk in ((4, 1), (2, 2)):
    eng = Engine(inp["w128"], inp["w128_q4_0"], compute_dtype=f32,
                 mesh=meshes[mk], device=cpu)
    out[("generate", mk)] = eng.generate([2, 5, 9, 14], gen6).ids

# tests/_dist_worker.py's model mode: greedy generate and serve against a
# single-device unpacked engine; sampled ids on every rank
ref = Engine(inp["w128"], inp["w128_q4_0"], compute_dtype=f32, pack_q4=False,
             device=cpu)
out["dw_ref"] = ref.generate([2, 5, 9, 14], gen6).ids
eng = Engine(inp["w128"], inp["w128_q4_0"], compute_dtype=f32, mesh=m22,
             device=cpu)
out["dw_generate"] = eng.generate([2, 5, 9, 14], gen6).ids
sampled = GenerationParams(temp=0.8, seed=7, n_predict=6, stop_at_eos=False)
out["dw_sampled"] = eng.generate([2, 5, 9], sampled).ids
dw = [([2, 5, 9], 6), ([2, 14, 7, 3], 5), ([2, 8], 6)]
be_ref = BatchedEngine(inp["w128"], inp["w128_q4_0"], max_batch=2, chunk=4,
                       compute_dtype=f32, pack_q4=False, device=cpu)
be = BatchedEngine(inp["w128"], inp["w128_q4_0"], max_batch=2, chunk=4,
                   compute_dtype=f32, mesh=m22, device=cpu)
for name, e in (("dw_serve_ref", be_ref), ("dw_serve", be)):
    res = e.serve([Request(prompt_ids=p, n_predict=n, request_id=i)
                   for i, (p, n) in enumerate(dw)], gen6)
    out[name] = {i: r.new_ids for i, r in res.items()}
out["dw_serve_sampled"] = serve(
    be, inp["tp_prompts"], 5,
    GenerationParams(temp=0.8, seed=3, stop_at_eos=False))

# BatchedEngine at (2, 2): per op (test_serving.py:298), then the TP halves
be = BatchedEngine(inp["srv"], inp["srv_f32"], max_batch=4, chunk=4,
                   compute_dtype=f32, mesh=m22, device=cpu)
out["serve_per_op"] = serve(be, inp["serve_prompts"], 6)
for kv_quant in (False, True):
    be = BatchedEngine(inp["tp"], inp["tp_q4_0"], max_batch=4, chunk=2,
                       max_seq=32, mesh=m22, tp_fused_decode=True,
                       kv_quant=kv_quant, device=cpu)
    assert be._tp_fused and be.B_local == 2
    out[("serve_tp", kv_quant)] = serve(be, inp["tp_prompts"], 4)

# the front door on (2, 2): rank 0 submits, every rank serves
be = BatchedEngine(inp["tp"], inp["tp_q4_0"], max_batch=4, chunk=2,
                   max_seq=32, mesh=m22, tp_fused_decode=True, device=cpu)
served = {}
real_serve = be.serve


def recording_serve(requests, gen, on_complete=None, **kw):
    def done(rid, res):
        served[rid] = res.ids
        on_complete(rid, res)
    return real_serve(requests, gen, on_complete=done, **kw)


be.serve = recording_serve
sched = DistributedScheduler(be, greedy, poll_s=0.01, idle_max_s=0.05)
if m22.data_index == 0 and m22.index == 0:
    futs = [sched.submit(p, n_predict=4) for p in inp["tp_prompts"]]
    out["futures"] = {f.request_id: f.result(timeout=300).ids for f in futs}
    sched.close()
else:
    sched.run()
out["dserve"] = served
torch.save(out, f"{sys.argv[2]}.{torch.distributed.get_rank()}")
print("RANK_DONE", torch.distributed.get_rank(), flush=True)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every rank's results of every multi-rank case, from one run of four
    processes started through the port's launcher with gloo."""
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    cpu = "cpu"
    inp = {"tiny": _torch_cfg(TINY), "kvq": _torch_cfg(KVQ),
           "w128": _torch_cfg(W128), "srv": _torch_cfg(TINY),
           "tp": _torch_cfg(TP),
           "tiny_f32": params_from_numpy(_params(TINY, 11), cpu),
           "tiny_q4_0": params_from_numpy(_params(TINY, 11, Q4_0), cpu),
           "kvq_f32": params_from_numpy(_params(KVQ, 5), cpu),
           "w128_q4_0": params_from_numpy(_params(W128, 11, Q4_0), cpu),
           "srv_f32": params_from_numpy(_params(TINY, 21), cpu),
           "tp_q4_0": params_from_numpy(_params(TP, 13, Q4_0), cpu),
           "score_ids": SCORE_IDS,
           "serve_prompts": [list(p) for p in SERVE_PROMPTS],
           "tp_prompts": [list(p) for p in TP_PROMPTS]}
    torch.save(inp, tmp / "in.pt")
    (tmp / "ranks.py").write_text(_RANKS)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biogpt_tpu_torch.parallel.distributed",
         "--coordinator", f"localhost:{port}", "--num-processes", "4",
         "--process-id", str(r), "--backend", "gloo", "--",
         str(tmp / "ranks.py"), str(tmp / "in.pt"), str(tmp / "out.pt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in log, log[-4000:]
    return [torch.load(f"{tmp / 'out.pt'}.{r}", weights_only=False)
            for r in range(4)]


def test_ranks_lie_on_the_mesh_as_jax_lays_devices(four_ranks):
    """Rank r sits at (r // model, r % model) on every mesh."""
    for r, out in enumerate(four_ranks):
        for (d, m), place in out["place"].items():
            assert place == (r // m, r % m)


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_sharded_score_matches_jax(four_ranks, data, model, kind):
    """``Engine(mesh, pack_q4=False).score`` of two 8-token rows, f32, on
    every rank against JAX ``Engine(mesh=make_mesh(d, m))``'s GSPMD score
    (``tests/test_sharding.py:41-59``) at rtol/atol 2e-5; at (2, 2) each
    replica scored its own row and the rows were gathered."""
    pj = _params(TINY, 11, Q4_0 if kind == "q4_0" else None)
    want = JaxEngine(TINY, pj, compute_dtype=jnp.float32, pack_q4=False,
                     mesh=jax_mesh(data, model)).score(SCORE_IDS)
    for out in four_ranks:
        got = out[("score", (data, model), kind)]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sharded_int8_generate_two_heads_over_four(four_ranks):
    """int8 KV on the sharded route with 2 heads over 4 ranks (attention on
    every head, a whole-feature cache): the JAX GSPMD engine's ids
    (``tests/test_kv_quant.py:236-247``) on every rank."""
    gen = JaxGen(n_predict=8, temp=0.0, stop_at_eos=False)
    pj = _params(KVQ, 5)
    want = JaxEngine(KVQ, pj, compute_dtype=jnp.float32, kv_quant=True,
                     mesh=jax_mesh(1, 4)).generate([2, 10, 25, 48], gen).ids
    for out in four_ranks:
        ids, cache_shape, kv_shards = out["kvq"]
        assert ids == want
        assert kv_shards == 1 and cache_shape[-1] == KVQ.d_model


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)])
def test_generate_on_data_axis_matches_jax(four_ranks, data, model):
    """``Engine(mesh).generate`` at B=1 (whole on every replica) on the
    packed TP route: the JAX mesh engine's ids on every rank."""
    gen = JaxGen(n_predict=6, temp=0.0, stop_at_eos=False)
    want = JaxEngine(W128, _params(W128, 11, Q4_0), compute_dtype=jnp.float32,
                     mesh=jax_mesh(data, model)).generate([2, 5, 9, 14],
                                                          gen).ids
    for out in four_ranks:
        assert out[("generate", (data, model))] == want


def test_dist_worker_model_mode(four_ranks):
    """``tests/_dist_worker.py``'s model mode on four ranks at (2, 2):
    greedy generate and serve equal the single-device unpacked engine's;
    sampled generate and serve draw the same ids on every rank."""
    for out in four_ranks:
        assert out["dw_generate"] == out["dw_ref"]
        assert out["dw_serve"] == out["dw_serve_ref"]
    first = four_ranks[0]
    for out in four_ranks[1:]:
        assert out["dw_sampled"] == first["dw_sampled"]
        assert out["dw_serve_sampled"]["ids"] == first["dw_serve_sampled"][
            "ids"]
    assert all(len(ids) == len(p) + 5 for ids, p in zip(
        first["dw_serve_sampled"]["ids"].values(), TP_PROMPTS))


def _jax_serve(cfg, params, prompts, n_predict, **kw):
    eng = JaxBatched(cfg, params, mesh=jax_mesh(2, 2), **kw)
    res = eng.serve([JaxRequest(prompt_ids=list(p), n_predict=n_predict,
                                request_id=i) for i, p in enumerate(prompts)],
                    JaxGen(temp=0.0, stop_at_eos=False))
    return {i: r.ids for i, r in res.items()}


def _exchanges(rec):
    """The data-axis exchanges of a serve: one per chunk, one per wave."""
    c = rec["counts"]
    assert c["chunk"] == rec["chunks"] > 0
    assert c["wave"] == c["waves"] > 0


def test_data_axis_serve_per_op_matches_jax(four_ranks):
    """``BatchedEngine(mesh=(2, 2))`` per op (the packed route on dense
    weights): each replica holds 2 of the 4 slots and half the features,
    exchanges once a chunk and once a refill wave (never a step), and
    every rank serves the JAX mesh engine's ids
    (``tests/test_serving.py:298``)."""
    want = _jax_serve(TINY, _params(TINY, 21), SERVE_PROMPTS, 6,
                      max_batch=4, compute_dtype=jnp.float32, chunk=4)
    for out in four_ranks:
        rec = out["serve_per_op"]
        assert rec["ids"] == want
        assert rec["B_local"] == 2
        assert rec["cache"] == (TINY.n_layer, 2, TINY.n_positions,
                                TINY.d_model // 2)
        _exchanges(rec)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_data_axis_tp_fused_serve_matches_jax(four_ranks, kv_quant):
    """``BatchedEngine(mesh=(2, 2), tp_fused_decode=True)``, bf16 and int8
    KV, six requests through four slots: every step on the halves at the
    local batch of 2, a (L, 2, 32, 256) cache on each rank, one exchange a
    chunk and one a wave, and the JAX ``BatchedEngine(mesh=make_mesh(2,
    2))`` ids on every rank."""
    want = _jax_serve(TP, _params(TP, 13, Q4_0), TP_PROMPTS, 4, max_batch=4,
                      chunk=2, compute_dtype=jnp.bfloat16, max_seq=32,
                      kv_quant=kv_quant)
    for out in four_ranks:
        rec = out[("serve_tp", kv_quant)]
        assert rec["ids"] == want
        assert rec["cache"] == (TP.n_layer, 2, 32, TP.d_model // 2)
        assert rec["counts"]["halves"] == rec["chunks"] * 2 * TP.n_layer
        _exchanges(rec)


def test_distributed_scheduler_on_two_by_two(four_ranks):
    """Rank 0 submits through the ``DistributedScheduler``; all four ranks
    of the (2, 2) mesh serve the same ids, rank 0's futures resolve to
    them, and they are the JAX (2, 2) mesh serve's."""
    want = _jax_serve(TP, _params(TP, 13, Q4_0), TP_PROMPTS, 4, max_batch=4,
                      chunk=2, compute_dtype=jnp.bfloat16, max_seq=32)
    assert four_ranks[0]["futures"] == want
    for out in four_ranks:
        assert out["dserve"] == want
