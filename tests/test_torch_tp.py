"""The port's tensor-parallel slice against the JAX package, on the CPU.

- chunked nibble packing and the TP weight packing and slicing: bit-equal
  to ``biogpt_tpu.quant.layouts.pack_nibble_planes(chunks=)`` and
  ``biogpt_tpu.parallel.tp.pack_params_tp`` / ``shard_params_tp``;
- the TP decode step's halves (their plain versions), every shard run in
  this process with the partials summed in shard order, against JAX
  ``make_tp_forward(mesh, fused_decode=True)`` with the Pallas kernels in
  interpret mode on the virtual CPU devices;
- two gloo ranks (processes started through the port's launcher,
  ``python -m biogpt_tpu_torch.parallel.distributed``, sharing one run for
  every multi-rank case): the per-op TP forward, sequence parallel against
  the all-reduce form, ``quantize_rows`` over the group, the TP
  ``BatchedEngine`` and ``Engine`` and the ``DistributedScheduler``,
  against the JAX package's mesh engines;
- the gates.

The model is the JAX tests' TP configuration (``tests/test_sharding.py``:
d_model 512, d_ff 512, 2 layers, vocab 300, 64 positions) with 8 heads,
so its head width is the CUDA kernels' 64. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.
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
from jax.sharding import PartitionSpec as P

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.config import GenerationParams as JaxGen
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.ops.pallas_decode_tp import supports_layers_tp as jax_gate
from biogpt_tpu.ops.qmatmul import set_pallas_mode
from biogpt_tpu.parallel import make_mesh as jax_mesh
from biogpt_tpu.parallel import tp as jtp
from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import pack_nibble_planes as jax_pack
from biogpt_tpu.quant.layouts import QuantizedTensor as JaxQT
from biogpt_tpu.quant.layouts import quantize_to_planes
from biogpt_tpu.quant.layouts import unpack_nibble_planes as jax_unpack
from biogpt_tpu.runtime.cache import KVCache as JaxKV
from biogpt_tpu.runtime.cache import QuantKVCache as JaxQKV
from biogpt_tpu.runtime.cache import init_cache as jax_init_cache
from biogpt_tpu.runtime.cache import quantize_rows as jax_quantize_rows
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.runtime.serving import BatchedEngine as JaxBatched
from biogpt_tpu.runtime.serving import Request as JaxRequest

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.models.biogpt import _decode_x0, _layer_norm
from biogpt_tpu_torch.ops import decode_tp_kernels, matmul
from biogpt_tpu_torch.ops.decode_tp_kernels import (decode_step_tp_shards,
                                                    supports_layers_tp)
from biogpt_tpu_torch.parallel import make_mesh
from biogpt_tpu_torch.parallel import tp as ttp
from biogpt_tpu_torch.parallel.mesh import Mesh
from biogpt_tpu_torch.quant.layouts import (QuantizedTensor,
                                            pack_nibble_planes,
                                            unpack_nibble_planes)
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = BioGptConfig.tiny(d_model=512, d_ff=512, n_head=8, n_layer=2,
                        n_vocab=300, n_positions=64)
TCFG = TorchConfig(**{f.name: getattr(CFG, f.name)
                      for f in dataclasses.fields(TorchConfig)})
Q4_0, Q4_1 = codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1
Q5_0, Q5_1, Q8_0 = (codecs.GGML_TYPE_Q5_0, codecs.GGML_TYPE_Q5_1,
                    codecs.GGML_TYPE_Q8_0)
PROMPTS = ([2, 41, 7], [2, 19, 3, 8], [2, 5])   # tests/test_sharding.py:352
GEN_PROMPT = [2, 10, 25, 48]
_STATICS = ("config", "compute_dtype", "causal", "logits_mode",
            "allow_pallas", "kv_window")


def _params(qtype):
    return params_from_state_dict(make_state_dict(CFG, seed=13), CFG,
                                  qtype=qtype)


def _rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_bytes(port, jax_tree, path=""):
    """Every leaf of the port's tree equals the JAX tree's, dtype and bytes."""
    if isinstance(jax_tree, dict):
        assert set(port) == set(jax_tree), path
        for k in jax_tree:
            _same_bytes(port[k], jax_tree[k], f"{path}/{k}")
    elif hasattr(jax_tree, "levels"):
        assert isinstance(port, QuantizedTensor), path
        assert (port.qtype, port.packed) == (jax_tree.qtype, jax_tree.packed)
        for f in ("levels", "scales", "mins"):
            a, b = getattr(port, f), getattr(jax_tree, f)
            assert (a is None) == (b is None), f"{path}.{f}"
            if a is not None:
                _same_bytes(a, b, f"{path}.{f}")
    else:
        a, b = _np(port), _np(jax_tree)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                          b.dtype)
        assert np.array_equal(a, b), path


# ------------------------------------------------------- packing, slicing

@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("qtype", [Q4_0, Q4_1, Q5_0, Q5_1])
def test_chunked_packing_matches_jax(qtype, chunks):
    """Layer-stacked (2, 512, 256) planes packed per d_in chunk: the bytes
    of the JAX packing, and both unpack back to the levels."""
    rng = np.random.RandomState(qtype * 10 + chunks)
    planes = [quantize_to_planes(rng.randn(256, 512).astype(np.float32),
                                 qtype) for _ in range(2)]
    qj = planes[0]._replace(levels=np.stack([p.levels for p in planes]),
                            scales=np.stack([p.scales for p in planes]),
                            mins=(np.stack([p.mins for p in planes])
                                  if planes[0].mins is not None else None))
    qt = params_from_numpy({"w": qj}, "cpu")["w"]
    pj, pt = jax_pack(qj, chunks=chunks), pack_nibble_planes(qt, chunks=chunks)
    assert pt.packed and pj.packed
    _same_bytes({"w": pt}, {"w": pj})
    back = unpack_nibble_planes(pt, chunks=chunks)
    assert torch.equal(back.levels, qt.levels)
    assert np.array_equal(np.asarray(jax_unpack(pj, chunks=chunks).levels),
                          qj.levels)
    if chunks > 1:   # a shard's rows are a packed plane by themselves
        rows = pt.levels.shape[-2] // chunks
        for c in range(chunks):
            own = dataclasses.replace(
                pt, levels=pt.levels[..., c * rows:(c + 1) * rows, :])
            assert torch.equal(
                unpack_nibble_planes(own).levels,
                qt.levels[..., c * 512 // chunks:(c + 1) * 512 // chunks, :])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("qtype", [Q4_0, Q4_1, Q5_0, Q5_1, Q8_0])
def test_tp_packing_and_shards_match_jax(qtype, tp):
    """``pack_params_tp`` (interleaved qkv, chunk-packed o and fc2, bf16
    planes, the lm_head padded to a multiple of tp * 128) bit for bit, and
    each rank's ``shard_params_tp`` slice equal to that rank's shard of the
    JAX ``shard_params_tp``."""
    pj = _params(qtype)
    jp = jtp.pack_params_tp(pj, tp)
    tpp = ttp.pack_params_tp(params_from_numpy(pj, "cpu"), tp)
    _same_bytes(tpp, jp)
    assert tpp["lm_head"].d_out % (tp * 128) == 0
    mesh = jax_mesh(1, tp)
    jsh = jtp.shard_params_tp(jp, mesh)
    for s in range(tp):
        dev = mesh.devices.flat[s]
        local = jax.tree.map(
            lambda a: next(sh.data for sh in a.addressable_shards
                           if sh.device == dev), jsh)
        own = ttp.shard_params_tp(tpp, Mesh(1, tp, s, None,
                                            torch.device("cpu")))
        _same_bytes(own, local)


def test_tp_gates_match_jax():
    """``supports_layers_tp`` and ``supports_tp`` against the JAX gates on
    passing and failing shapes."""
    for qtype in (Q4_0, Q8_0):
        jp = jtp.pack_params_tp(_params(qtype), 2)
        tl = ttp.pack_params_tp(params_from_numpy(_params(qtype), "cpu"), 2)
        for tp in (1, 2, 4, 8, 3):
            for batch in (0, 1, 7, 32, 33):
                assert (supports_layers_tp(tl["layers"], tp, batch)
                        == jax_gate(jp["layers"], tp, batch)), (tp, batch)
    unfused = params_from_numpy(_params(Q4_0), "cpu")["layers"]
    assert not supports_layers_tp(unfused, 2, 4)
    for cfg in (CFG, BioGptConfig.tiny(), BioGptConfig()):
        tcfg = TorchConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(TorchConfig)})
        for tp in (0, 1, 2, 3, 4, 8, 16, 64):
            assert ttp.supports_tp(tcfg, tp) == jtp.supports_tp(cfg, tp)


def test_tp_gate_refuses_a_local_d_in_past_4096():
    """The halves' tensor-core GEMV takes a local d_in of at most 4096
    (its split-K blocks form one thread block cluster of <= 16): local
    planes with fc2's d_in 8192 pass the TPU gate and are refused here; at
    4096 both take them."""
    def layers(F, jax_side):
        def planes(d_in, d_out):
            lv = np.zeros((1, d_in // 2, d_out), np.uint8)
            sc = np.zeros((1, d_in // 32, d_out), np.float16)
            if jax_side:
                return JaxQT(levels=lv, scales=sc, mins=None, qtype=Q4_0,
                             packed=True)
            return QuantizedTensor(levels=torch.from_numpy(lv),
                                   scales=torch.from_numpy(sc), mins=None,
                                   qtype=Q4_0, packed=True)
        D = 1024
        return {"qkv": {"w": planes(D, 3 * D)}, "o": {"w": planes(D, D)},
                "fc1": {"w": planes(D, F)}, "fc2": {"w": planes(F, D)}}
    for F in (4096, 8192):
        assert jax_gate(layers(F, True), 1, 8)
        assert supports_layers_tp(layers(F, False), 1, 8) == (F <= 4096)


def test_mesh_and_engine_gates_raise():
    """The data axis, ``pack_q4=False`` on a mesh and a card-less default
    device raise."""
    with pytest.raises(NotImplementedError, match="data axis"):
        make_mesh(data=2, model=1, device="cpu")
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    params = params_from_numpy(_params(Q4_0), "cpu")
    with pytest.raises(NotImplementedError, match="GSPMD"):
        Engine(TCFG, params, mesh=mesh, pack_q4=False)
    with pytest.raises(NotImplementedError, match="GSPMD"):
        BatchedEngine(TCFG, params, mesh=mesh, pack_q4=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(TCFG, params)


# --------------------------------------------------------- the TP halves

def _caches(L, B, S, D, int8, rng):
    if int8:
        lv = [rng.randint(-127, 128, size=(L, B, S, D)).astype(np.int8)
              for _ in range(2)]
        sc = [(rng.rand(L, B, 1, S) * 0.01 + 0.005).astype(np.float32)
              for _ in range(2)]
        return (*lv, *sc)
    return tuple((rng.randn(L, B, S, D) * 0.5).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("qtype,tp,int8", [
    (Q4_0, 2, False), (Q4_0, 4, False), (Q4_0, 2, True), (Q5_0, 2, False)])
def test_tp_halves_match_jax_fused_decode(qtype, tp, int8):
    """One TP decode step at B = 4 ragged positions (one of them past the
    window and the cache of 32, one at 0), window 32 (one KV block at tp 2, two at tp 4):
    every shard's halves here, their partials summed in shard order,
    against JAX's TP kernels in interpret mode on a (1, tp) mesh. Both
    run dequant-then-dot projections and the same blocks; they differ in
    f32 summation order (and the GELU's erf, within 1.5e-7), which can flip
    a bf16 rounding. Logits (through the f32 lm_head product that JAX's
    CPU path takes) within 1e-3 of their magnitude, the argmax equal; the
    new K/V rows within one bf16 ulp (2^-7) of their largest magnitude,
    bf16 directly, int8 as levels times scales (each scale within 1e-6 of
    JAX's: the same absmax of f32 rows summed in another order)."""
    pj = _params(qtype)
    mesh = jax_mesh(1, tp)
    jps = jtp.shard_params_tp(jtp.pack_params_tp(pj, tp), mesh)
    L, D, B, S = CFG.n_layer, CFG.d_model, 4, 32
    rng = np.random.RandomState(tp + 10 * int8)
    past = np.array([0, 5, 40, 31], np.int32)
    toks = rng.randint(3, 299, size=(B, 1)).astype(np.int32)
    cache = _caches(L, B, S, D, int8, rng)
    if int8:
        jcache = JaxQKV(*(jnp.asarray(a) for a in cache))
    else:
        jcache = JaxKV(*(jnp.asarray(a, jnp.bfloat16) for a in cache))
    set_pallas_mode(True)
    try:
        fwd = jax.jit(jtp.make_tp_forward(mesh, fused_decode=True),
                      static_argnames=_STATICS)
        lj, cj = fwd(jps, jnp.asarray(toks), jcache, jnp.asarray(past), CFG,
                     compute_dtype=jnp.bfloat16, logits_mode="last",
                     allow_pallas=False, kv_window=S)
    finally:
        set_pallas_mode("auto")

    tpp = ttp.pack_params_tp(params_from_numpy(pj, "cpu"), tp)
    Dl = D // tp
    shards = []
    for s in range(tp):
        own = ttp.shard_params_tp(tpp, Mesh(1, tp, s, None,
                                            torch.device("cpu")))
        cols = slice(s * Dl, (s + 1) * Dl)
        if int8:
            kc = {"k_cache": torch.from_numpy(cache[0][..., cols].copy()),
                  "v_cache": torch.from_numpy(cache[1][..., cols].copy()),
                  "k_scales": torch.from_numpy(cache[2]),
                  "v_scales": torch.from_numpy(cache[3])}
        else:
            kc = {n: torch.from_numpy(a[..., cols].copy()).to(torch.bfloat16)
                  for n, a in zip(("k_cache", "v_cache"), cache)}
        shards.append({"layers": own["layers"], "params": own, **kc})
    pt = torch.from_numpy(past)
    x0 = _decode_x0(shards[0]["params"], torch.from_numpy(toks).long(), pt,
                    TCFG)
    x, rows = decode_step_tp_shards(x0, shards, pt, n_head=CFG.n_head,
                                    window=S, ln_eps=CFG.ln_eps)
    logits = []
    for sh in shards:
        p = sh["params"]
        xn = _layer_norm(x, p["final_ln"]["w"], p["final_ln"]["b"], CFG.ln_eps)
        logits.append(matmul(xn, p["lm_head"], compute_dtype=torch.float32,
                             allow_kernels=False))
    lt = torch.cat(logits, -1)[:, :CFG.n_vocab].numpy()
    lj = np.asarray(lj, np.float32)
    _rel_close(lt, lj, 1e-3)
    assert (lt.argmax(-1) == lj.argmax(-1)).all()

    # JAX returns its rows committed at each slot's position: read them
    # there for the slots inside the cache (the TPU commit kernel puts a
    # row past the cache's end at its clamped 8-row tile's first row, the
    # port's commits at the last row; the step's rows are the same)
    slots = np.flatnonzero(past < S)
    pos = past[slots]
    rows = [[t[:, slots] for t in r] for r in rows]
    if int8:
        for k, (lv, sc) in enumerate(((cj.k, cj.ks), (cj.v, cj.vs))):
            want_sc = np.asarray(sc)[:, slots, 0, pos]
            got_sc = rows[0][2 + k].numpy()
            for r in rows[1:]:   # every shard writes the same full-row scale
                assert torch.equal(r[2 + k], rows[0][2 + k])
            np.testing.assert_allclose(got_sc, want_sc, rtol=1e-6, atol=0)
            got = torch.cat([r[k] for r in rows], -1).float().numpy()
            want = np.asarray(lv)[:, slots, pos].astype(np.float32)
            _rel_close(got * got_sc[..., None], want * want_sc[..., None],
                       2 ** -7)
    else:
        for k, c in enumerate((cj.k, cj.v)):
            got = torch.cat([r[k] for r in rows], -1).float().numpy()
            want = np.asarray(c, np.float32)[:, slots, pos]
            _rel_close(got, want, 2 ** -7)


# ------------------------------------------------------- two gloo ranks

_RANKS = r'''
"""One gloo rank of tests/test_torch_tp.py's multi-rank cases (run under
python -m biogpt_tpu_torch.parallel.distributed)."""
import sys

import torch
import torch.distributed as dist

from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.parallel import make_mesh
from biogpt_tpu_torch.parallel import tp as ttp
from biogpt_tpu_torch.runtime.cache import init_cache, quantize_rows
from biogpt_tpu_torch.runtime.dist_serving import DistributedScheduler
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.runtime.serving import BatchedEngine, Request

torch.set_num_threads(2)
inp = torch.load(sys.argv[1], weights_only=False)
cfg, params = inp["cfg"], inp["params"]
mesh = make_mesh(1, 2, device="cpu")
rank, out = mesh.index, {}

# the per-op TP forward: a prefill of 8 tokens (sequence parallel, and the
# all-reduce form), then one decode step on the prefilled cache
shard = ttp.shard_params_tp(ttp.pack_params_tp(params, 2), mesh)
for sp in (True, False):
    fwd = ttp.make_tp_forward(mesh, seq_parallel=sp)
    cache = init_cache(cfg, batch=2, max_len=32, dtype=torch.float16, tp=2)
    pre, cache = fwd(shard, inp["ids"], cache, 0, cfg,
                     compute_dtype=torch.float32, logits_mode="all",
                     allow_kernels=False)
    dec, cache = fwd(shard, inp["tok"], cache, 8, cfg,
                     compute_dtype=torch.float32, logits_mode="last",
                     allow_kernels=False)
    out[("forward", sp)] = (pre, dec, cache.k.clone())

# int8 row quantization over the model axis
x = inp["qx"]
cols = x.shape[-1] // 2
out["quantize"] = quantize_rows(x[..., rank * cols:(rank + 1) * cols],
                                mesh.group)

greedy = GenerationParams(temp=0.0, stop_at_eos=False)


def reqs():
    return [Request(prompt_ids=p, n_predict=4, request_id=i)
            for i, p in enumerate(inp["prompts"])]


for kv_quant in (False, True):
    eng = BatchedEngine(cfg, params, max_batch=2, chunk=2, max_seq=32,
                        mesh=mesh, tp_fused_decode=True, kv_quant=kv_quant,
                        device="cpu")
    assert eng._tp_fused and not eng._fused_decode
    assert eng.cache_dtype == (torch.int8 if kv_quant else torch.bfloat16)
    out[("serve", kv_quant)] = {i: r.ids
                                for i, r in eng.serve(reqs(), greedy).items()}
    gen = GenerationParams(n_predict=6, temp=0.0, stop_at_eos=False)
    out[("generate", kv_quant)] = Engine(
        cfg, params, mesh=mesh, tp_fused_decode=True, kv_quant=kv_quant,
        device="cpu").generate(inp["gen_prompt"], gen).ids

# the front door: rank 0 submits, every rank serves
eng = BatchedEngine(cfg, params, max_batch=2, chunk=2, max_seq=32, mesh=mesh,
                    tp_fused_decode=True, device="cpu")
served = {}
serve = eng.serve


def recording_serve(requests, gen, on_complete=None, **kw):
    def done(rid, res):
        served[rid] = res.ids
        on_complete(rid, res)
    return serve(requests, gen, on_complete=done, **kw)


eng.serve = recording_serve
sched = DistributedScheduler(eng, greedy, poll_s=0.01, idle_max_s=0.05)
if rank == 0:
    futs = [sched.submit(p, n_predict=4) for p in inp["prompts"]]
    out["futures"] = {f.request_id: f.result(timeout=300).ids for f in futs}
    sched.close()
else:
    sched.run()
out["dserve"] = served
torch.save(out, f"{sys.argv[2]}.{rank}")
print("RANK_DONE", rank, flush=True)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of every multi-rank case, from one run of two
    processes started through the port's launcher with gloo."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    rng = np.random.RandomState(7)
    inp = {"cfg": TCFG, "params": params_from_numpy(_params(Q4_0), "cpu"),
           "ids": torch.from_numpy(rng.randint(3, 299, size=(2, 8))),
           "tok": torch.tensor([[7], [12]]),
           "qx": torch.from_numpy((rng.randn(3, 5, 256) * np.exp(
               rng.randn(3, 5, 1))).astype(np.float32)),
           "prompts": [list(p) for p in PROMPTS], "gen_prompt": GEN_PROMPT}
    torch.save(inp, tmp / "in.pt")
    (tmp / "ranks.py").write_text(_RANKS)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biogpt_tpu_torch.parallel.distributed",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(r), "--backend", "gloo", "--",
         str(tmp / "ranks.py"), str(tmp / "in.pt"), str(tmp / "out.pt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
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
    return inp, [torch.load(f"{tmp / 'out.pt'}.{r}", weights_only=False)
                 for r in range(2)]


def _jax_forward(params, seq_parallel, ids, tok):
    mesh = jax_mesh(1, 2)
    jps = jtp.shard_params_tp(jtp.pack_params_tp(params, 2), mesh)
    fwd = jax.jit(jtp.make_tp_forward(mesh, seq_parallel=seq_parallel),
                  static_argnames=_STATICS)
    cache = jax_init_cache(CFG, batch=2, max_len=32, dtype=jnp.float16)
    pre, cache = fwd(jps, jnp.asarray(ids), cache, jnp.int32(0), CFG,
                     compute_dtype=jnp.float32, logits_mode="all",
                     allow_pallas=False)
    dec, cache = fwd(jps, jnp.asarray(tok), cache, jnp.int32(8), CFG,
                     compute_dtype=jnp.float32, logits_mode="last",
                     allow_pallas=False)
    return np.asarray(pre), np.asarray(dec), np.asarray(cache.k, np.float32)


@pytest.mark.parametrize("seq_parallel", [True, False])
def test_per_op_tp_forward_matches_jax(two_ranks, seq_parallel):
    """The per-op TP forward on two ranks (prefill of 8 tokens, then a
    decode step) against JAX ``make_tp_forward(mesh)`` on a (1, 2) mesh,
    f32 compute on both: logits within 1e-5 of their magnitude, each
    rank's f16 cache shard within one f16 ulp (2^-10) of the JAX cache's
    columns; both ranks hold the same logits."""
    inp, outs = two_ranks
    pre_j, dec_j, k_j = _jax_forward(_params(Q4_0), seq_parallel,
                                     inp["ids"].numpy(), inp["tok"].numpy())
    for r, out in enumerate(outs):
        pre, dec, k = out[("forward", seq_parallel)]
        _rel_close(pre.numpy(), pre_j, 1e-5)
        _rel_close(dec.numpy(), dec_j, 1e-5)
        cols = slice(r * 256, (r + 1) * 256)
        _rel_close(k.float().numpy()[:, :, :9], k_j[..., cols][:, :, :9],
                   2 ** -10)
    for a, b in zip(outs[0][("forward", seq_parallel)][:2],
                    outs[1][("forward", seq_parallel)][:2]):
        assert torch.equal(a, b)


def test_seq_parallel_matches_all_reduce_form(two_ranks):
    """Sequence-parallel prefill equals the all-reduce form within the
    1e-5 of the JAX test (tests/test_sharding.py:252): the same sums in
    another order."""
    _, outs = two_ranks
    for out in outs:
        for a, b in zip(out[("forward", True)], out[("forward", False)]):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_quantize_rows_over_group_matches_jax_pmax(two_ranks):
    """Each rank quantizes its half of the rows with the absmax all-reduced
    over the group: the levels and scales of JAX ``quantize_rows(x,
    tp_axis)`` under ``shard_map``, bit for bit."""
    inp, outs = two_ranks
    mesh = jax_mesh(1, 2)
    f = jax.shard_map(lambda a: jax_quantize_rows(a, "model"), mesh=mesh,
                      in_specs=(P(None, None, "model"),),
                      out_specs=(P(None, None, "model"), P(None, None)),
                      check_vma=False)
    q_j, s_j = f(jnp.asarray(inp["qx"].numpy()))
    q = torch.cat([out["quantize"][0] for out in outs], -1)
    assert np.array_equal(q.numpy(), np.asarray(q_j))
    for out in outs:
        assert np.array_equal(out["quantize"][1].numpy(), np.asarray(s_j))


def _jax_serve(kv_quant):
    reqs = [JaxRequest(prompt_ids=list(p), n_predict=4, request_id=i)
            for i, p in enumerate(PROMPTS)]
    eng = JaxBatched(CFG, _params(Q4_0), max_batch=2, chunk=2,
                     compute_dtype=jnp.bfloat16, max_seq=32,
                     mesh=jax_mesh(1, 2), kv_quant=kv_quant)
    res = eng.serve(reqs, JaxGen(temp=0.0, stop_at_eos=False))
    return {i: r.ids for i, r in res.items()}


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tp_fused_serve_matches_jax(two_ranks, kv_quant):
    """``BatchedEngine(mesh, tp_fused_decode=True)`` on two ranks, greedy,
    three requests through two slots (a refill wave): token-identical to
    the JAX ``BatchedEngine(mesh=make_mesh(1, 2))`` serve, on both ranks
    (the test of tests/test_sharding.py:352)."""
    _, outs = two_ranks
    want = _jax_serve(kv_quant)
    for out in outs:
        assert out[("serve", kv_quant)] == want


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tp_fused_engine_generate_matches_jax(two_ranks, kv_quant):
    """``Engine(mesh, tp_fused_decode=True).generate``, greedy, on two
    ranks: the JAX mesh engine's ids, on both ranks."""
    _, outs = two_ranks
    want = JaxEngine(CFG, _params(Q4_0), compute_dtype=jnp.bfloat16,
                     mesh=jax_mesh(1, 2), kv_quant=kv_quant).generate(
        GEN_PROMPT, JaxGen(n_predict=6, temp=0.0, stop_at_eos=False)).ids
    for out in outs:
        assert out[("generate", kv_quant)] == want


def test_distributed_scheduler_serves_on_every_rank(two_ranks):
    """Rank 0 submits through the ``DistributedScheduler`` front door; both
    ranks serve the same requests to the same ids, rank 0's futures resolve
    to them, and they are the JAX mesh serve's."""
    _, outs = two_ranks
    want = _jax_serve(False)
    assert outs[0]["futures"] == want
    assert outs[0]["dserve"] == want
    assert outs[1]["dserve"] == want


def test_one_by_one_mesh_serves_as_jax(monkeypatch):
    """A (1, 1) mesh needs no process group; its TP step serves, in
    process, the JAX (1, 1) mesh engine's ids, and every lockstep step
    runs the TP halves (the per-op path is never taken quietly)."""
    mesh = make_mesh(1, 1, device="cpu")
    eng = BatchedEngine(TCFG, params_from_numpy(_params(Q4_0), "cpu"),
                        max_batch=2, chunk=2, max_seq=32, mesh=mesh,
                        tp_fused_decode=True, device="cpu")
    assert eng._tp_fused and eng.cache_dtype == torch.bfloat16
    calls = []
    real = decode_tp_kernels.tp_ffn_half_plain
    monkeypatch.setattr(decode_tp_kernels, "tp_ffn_half_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    reqs = [Request(prompt_ids=list(p), n_predict=4, request_id=i)
            for i, p in enumerate(PROMPTS)]
    got = eng.serve(reqs, GenerationParams(temp=0.0, stop_at_eos=False))
    steps = eng.metrics.snapshot()["chunks_launched"] * eng.chunk
    assert len(calls) == steps * CFG.n_layer > 0
    jeng = JaxBatched(CFG, _params(Q4_0), max_batch=2, chunk=2,
                      compute_dtype=jnp.bfloat16, max_seq=32,
                      mesh=jax_mesh(1, 1))
    want = jeng.serve([JaxRequest(prompt_ids=list(p), n_predict=4,
                                  request_id=i)
                       for i, p in enumerate(PROMPTS)],
                      JaxGen(temp=0.0, stop_at_eos=False))
    assert {i: r.ids for i, r in got.items()} == {
        i: r.ids for i, r in want.items()}
