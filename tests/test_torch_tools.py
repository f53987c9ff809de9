"""The port's model-file pipeline against the JAX package, at tiny size.

The Q4_0/Q4_1 encoders and ``quantize_rows`` (bytes), ``quantize_to_planes``
/ ``from_planes``, ``params_from_state_dict`` (arrays and planes, f32 and
five formats), ``make_state_dict``, the tools ``convert_hf`` (files, from
``pytorch_model.bin`` and ``model.safetensors``) and ``quantize_cli``
(files) byte for byte, ``perplexity_of_ids``, and the ``Engine``'s
``causal``, ``warmup``, ``score(batch=)`` and ``logits_for_tokens``.
Everything runs on the CPU (the kernels' plain versions).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biogpt_tpu.config import BioGptConfig as JaxConfig
from biogpt_tpu.modelio.checkpoint import (
    params_from_state_dict as jax_params_from_state_dict)
from biogpt_tpu.modelio.synthetic import (
    make_state_dict as jax_make_state_dict,
    write_synthetic_hf_dir as jax_write_hf_dir,
    write_synthetic_model as jax_write_model)
from biogpt_tpu.models.biogpt import logits_for_tokens as jax_logits_for_tokens
from biogpt_tpu.quant import codecs as jax_codecs
from biogpt_tpu.quant.layouts import from_planes as jax_from_planes
from biogpt_tpu.runtime.engine import Engine as JaxEngine
from biogpt_tpu.tools.convert_hf import convert as jax_convert
from biogpt_tpu.tools.perplexity import perplexity_of_ids as jax_ppl
from biogpt_tpu.tools.quantize_cli import quantize_file as jax_quantize_file

from biogpt_tpu_torch.config import BioGptConfig, GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import (params_from_state_dict,
                                                 should_quantize)
from biogpt_tpu_torch.modelio.ggml_format import read_model_file
from biogpt_tpu_torch.modelio.synthetic import (make_state_dict,
                                                write_synthetic_hf_dir,
                                                write_synthetic_model)
from biogpt_tpu_torch.models.biogpt import logits_for_tokens
from biogpt_tpu_torch.quant import codecs
from biogpt_tpu_torch.quant.layouts import QuantizedTensor, from_planes, \
    quantize_to_planes
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.tools.convert_hf import convert, read_safetensors
from biogpt_tpu_torch.tools.perplexity import perplexity_of_ids
from biogpt_tpu_torch.tools.quantize_cli import QUANT_CHOICES, quantize_file

TINY = BioGptConfig.tiny()
JTINY = JaxConfig.tiny()
QTYPES = {name: codecs.GGML_TYPE_BY_NAME[name] for name in QUANT_CHOICES}


def _same_bytes(path_a, path_b) -> bool:
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------------------------------ codecs

def _tie_blocks() -> np.ndarray:
    """Blocks whose scaled values land exactly on the encoders' .5 (Q4_0:
    x/d + 8.5 an integer with d = +-1; Q4_1: (x-min)/d + 0.5 with d = 1),
    the absmax positive, negative and both (the first one wins), a zero
    and a constant block."""
    ramp = np.arange(32, dtype=np.float32)
    halves = (ramp % 16) - 7.5                        # -7.5 .. 7.5
    neg = halves.copy()
    neg[3] = -8.0                                     # d = +1
    pos = halves.copy()
    pos[5] = 8.0                                      # d = -1
    both = halves.copy()
    both[7], both[9] = 8.0, -8.0                      # +8 first: d = -1
    both2 = halves.copy()
    both2[7], both2[9] = -8.0, 8.0                    # -8 first: d = +1
    q41 = (ramp % 16) + 0.5                           # d = 1 after min 0
    q41[0], q41[1] = 0.0, 15.0
    return np.stack([neg, pos, both, both2, q41, np.zeros(32, np.float32),
                     np.full(32, 0.37, np.float32),
                     np.full(32, -2.0, np.float32)]).astype(np.float32)


@pytest.mark.parametrize("name", ["q4_0", "q4_1"])
def test_q4_encoders_bit_equal_on_ties_zero_constant(name):
    x = _tie_blocks()
    q = QTYPES[name]
    got = codecs.quantize_blocks(x, q)
    assert got.tobytes() == jax_codecs.quantize_blocks(x, q).tobytes()
    # and the decoded values are the JAX decoder's
    np.testing.assert_array_equal(codecs.dequantize_blocks(got, q),
                                  jax_codecs.dequantize_blocks(got, q))


@pytest.mark.parametrize("name", ["q4_0", "q4_1"])
@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 1e4])
def test_q4_encoders_bit_equal_random(name, scale):
    """Gaussian and uniform blocks at magnitudes from 1e-6 to 1e4, and
    blocks whose largest magnitude comes with both signs."""
    rng = np.random.default_rng(int(scale * 1e6) % 1000)
    x = np.concatenate([rng.standard_normal((64, 32)),
                        rng.uniform(-1, 1, (64, 32))]) * scale
    x[::7, 4], x[::7, 20] = scale * 3, -scale * 3
    x = x.astype(np.float32)
    q = QTYPES[name]
    assert (codecs.quantize_blocks(x, q).tobytes()
            == jax_codecs.quantize_blocks(x, q).tobytes())


@pytest.mark.parametrize("name", QUANT_CHOICES)
def test_quantize_rows_and_planes_equal_jax(name):
    rng = np.random.RandomState(3)
    w = (rng.randn(48, 96) * 0.05).astype(np.float32)
    q = QTYPES[name]
    raw = codecs.quantize_rows(w, q)
    assert raw == jax_codecs.quantize_rows(w, q)
    qt = quantize_to_planes(w, q)
    from biogpt_tpu.quant.layouts import quantize_to_planes as jax_qtp
    jqt = jax_qtp(w, q)
    np.testing.assert_array_equal(qt.levels.numpy(), jqt.levels)
    np.testing.assert_array_equal(qt.scales.numpy(), jqt.scales)
    np.testing.assert_array_equal(from_planes(qt).numpy(),
                                  jax_from_planes(jqt))


# --------------------------------------------------- state dict and params

def _assert_params_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_params_equal(got[k], want[k], f"{path}.{k}")
    elif hasattr(want, "levels"):
        assert isinstance(got, QuantizedTensor), path
        assert (got.qtype, got.packed) == (int(want.qtype), bool(want.packed))
        for f in ("levels", "scales", "mins"):
            w, g = getattr(want, f), getattr(got, f)
            if w is None:
                assert g is None, f"{path}.{f}"
                continue
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{path}.{f}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)


def test_make_state_dict_equals_jax():
    cfg = BioGptConfig.tiny(n_layer=2)
    got = make_state_dict(cfg, seed=5, scale=0.1)
    want = jax_make_state_dict(JaxConfig.tiny(n_layer=2), seed=5, scale=0.1,
                               cache=False)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", (None,) + QUANT_CHOICES)
def test_params_from_state_dict_equals_jax(name):
    sd = jax_make_state_dict(JTINY, seed=11, cache=False)
    q = QTYPES[name] if name else None
    want = jax_params_from_state_dict(sd, JTINY, q)
    # torch tensors in, as a state dict loaded with torch.load holds them
    got = params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                 TINY, q, device="cpu")
    _assert_params_equal(got, want)
    assert should_quantize("fc1.weight", (64, 32))
    assert not should_quantize("fc1.bias", (64,))
    assert not should_quantize("x.weight", (1, 32))


# --------------------------------------------------------------- the tools

@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The JAX writer's HF directory, the port writer's, and a
    safetensors-only copy of the JAX one."""
    base = tmp_path_factory.mktemp("hf")
    jax_dir, port_dir, st_dir = base / "jax", base / "port", base / "st"
    jax_write_hf_dir(jax_dir, seed=3)
    write_synthetic_hf_dir(port_dir, seed=3)
    st_dir.mkdir()
    for f in ("config.json", "vocab.json", "merges.txt"):
        shutil.copy(jax_dir / f, st_dir / f)
    return jax_dir, port_dir, st_dir


@pytest.mark.parametrize("use_f16", [False, True])
def test_convert_files_equal_jax(hf_dirs, tmp_path, use_f16):
    jax_dir, port_dir, _ = hf_dirs
    want = jax_convert(jax_dir, tmp_path / "jax", use_f16=use_f16,
                       verbose=False)
    got = convert(jax_dir, tmp_path / "port", use_f16=use_f16, verbose=False)
    assert _same_bytes(got, want)
    got2 = convert(port_dir, tmp_path / "port2", use_f16=use_f16,
                   verbose=False)
    assert _same_bytes(got2, want)


def test_convert_safetensors_equals_jax_and_bin(hf_dirs, tmp_path):
    """The port's own safetensors reader: the JAX tool's file (through the
    ``safetensors`` package) byte for byte, and the records of the
    ``pytorch_model.bin`` conversion (safetensors keeps no tensor order)."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    jax_dir, _, st_dir = hf_dirs
    sd = jax_make_state_dict(JTINY, seed=3, cache=False)
    path = st_dir / "model.safetensors"
    st_numpy.save_file(sd, str(path))
    read = read_safetensors(path)
    assert list(read) == list(st_numpy.load_file(str(path)))
    for k, v in read.items():
        np.testing.assert_array_equal(v, sd[k])
    got = convert(st_dir, tmp_path / "port", verbose=False)
    assert _same_bytes(got, jax_convert(st_dir, tmp_path / "jax",
                                        verbose=False))
    from_bin = convert(jax_dir, tmp_path / "bin", verbose=False)
    cfg_a, vocab_a, merges_a, recs_a = read_model_file(got)
    cfg_b, vocab_b, merges_b, recs_b = read_model_file(from_bin)
    assert (cfg_a, vocab_a, merges_a) == (cfg_b, vocab_b, merges_b)
    assert set(recs_a) == set(recs_b)
    for k, r in recs_a.items():
        assert (r.shape, r.ttype, r.data) == (
            recs_b[k].shape, recs_b[k].ttype, recs_b[k].data), k


def test_read_safetensors_bf16(tmp_path):
    import json
    import struct

    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype("<u2").tobytes()
    header = json.dumps({"__metadata__": {"format": "pt"},
                         "w": {"dtype": "BF16", "shape": [3],
                               "data_offsets": [0, len(raw)]}}).encode()
    path = tmp_path / "m.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + raw)
    np.testing.assert_array_equal(read_safetensors(path)["w"], vals)


@pytest.fixture(scope="module")
def f32_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("f32") / "model.bin"
    jax_write_model(path, seed=4)
    return path


def test_write_synthetic_model_equals_jax(f32_file, tmp_path):
    for use_f16 in (False, True):
        jax_path = tmp_path / f"jax{use_f16}.bin"
        jax_write_model(jax_path, seed=4, use_f16=use_f16)
        port_path = tmp_path / f"port{use_f16}.bin"
        assert write_synthetic_model(port_path, seed=4,
                                     use_f16=use_f16) == TINY
        assert _same_bytes(port_path, jax_path)


@pytest.mark.parametrize("name", QUANT_CHOICES)
def test_quantize_file_equals_jax(f32_file, tmp_path, monkeypatch, name):
    # the JAX tool's numpy codecs (its native library's bit-exact peers),
    # so this test builds no shared library
    from biogpt_tpu.quant import native
    monkeypatch.setattr(native, "quantize_blocks", jax_codecs.quantize_blocks)
    want = tmp_path / "jax.bin"
    jax_stats = jax_quantize_file(str(f32_file), str(want), name,
                                  verbose=False)
    got = tmp_path / "port.bin"
    stats = quantize_file(str(f32_file), str(got), name, verbose=False)
    assert _same_bytes(got, want)
    assert (stats["bytes_in"], stats["bytes_out"]) == (
        jax_stats["bytes_in"], jax_stats["bytes_out"])
    if name == "q4_0":   # a quantized file is refused as a source
        with pytest.raises(ValueError, match="only f32/f16"):
            quantize_file(str(got), str(tmp_path / "qq.bin"), "q8_0",
                          verbose=False)


# -------------------------------------------------------- perplexity, engine

@pytest.fixture(scope="module")
def state():
    return jax_make_state_dict(JTINY, seed=33, cache=False)


def _engines(sd, name, **kw):
    q = QTYPES[name] if name else None
    jax_eng = JaxEngine(JTINY, jax_params_from_state_dict(sd, JTINY, q),
                        compute_dtype=jnp.float32, **kw)
    eng = Engine(TINY, params_from_state_dict(sd, TINY, q, device="cpu"),
                 compute_dtype=torch.float32, device="cpu", **kw)
    return jax_eng, eng


@pytest.mark.parametrize("name,window,stride", [
    (None, 24, 10), ("q8_0", 60, None), ("q4_0", 40, 25)])
def test_perplexity_equals_jax(state, name, window, stride):
    jax_eng, eng = _engines(state, name)
    ids = [2] + np.random.RandomState(1).randint(
        4, TINY.n_vocab - 10, size=90).tolist()
    want = jax_ppl(jax_eng, ids, window=window, stride=stride)
    got = perplexity_of_ids(eng, ids, window=window, stride=stride)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
    assert len(got["window_nll"]) >= 2


def test_dppl_ordering(state):
    """Q8_0 is closer to f32 than Q4_0, and within 1% of it."""
    ids = [2] + np.random.RandomState(0).randint(
        4, TINY.n_vocab - 10, size=120).tolist()
    ppl = {}
    for name in (None, "q4_0", "q8_0"):
        q = QTYPES[name] if name else None
        eng = Engine(TINY, params_from_state_dict(state, TINY, q, device="cpu"),
                     compute_dtype=torch.float32, device="cpu")
        ppl[name] = perplexity_of_ids(eng, ids, window=60)["ppl"]
    d_q8 = abs(ppl["q8_0"] - ppl[None])
    d_q4 = abs(ppl["q4_0"] - ppl[None])
    assert d_q8 < d_q4, ppl
    assert d_q8 / ppl[None] < 0.01, ppl


def test_noncausal_score_equals_jax_and_turns_fused_decode_off(state):
    ids = np.array([[2, 10, 25, 48, 7, 31]], dtype=np.int32)
    jax_eng, eng = _engines(state, None, causal=False)
    np.testing.assert_allclose(eng.score(ids), jax_eng.score(ids),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(eng.score(ids, batch=True), eng.score(ids))
    causal = Engine(TINY, params_from_state_dict(state, TINY, device="cpu"),
                    compute_dtype=torch.float32, device="cpu")
    assert np.abs(causal.score(ids)[0, 0] - eng.score(ids)[0, 0]).max() > 1e-3
    # the fused decode step is causal only: a bf16 packed Q4_0 engine at a
    # width its kernels take runs it, the same engine with causal=False
    # does not, in both packages
    cfg = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2)
    jcfg = JaxConfig.tiny(d_model=128, d_ff=256, n_head=2)
    sd = jax_make_state_dict(jcfg, seed=2, cache=False)
    params = params_from_state_dict(sd, cfg, codecs.GGML_TYPE_Q4_0,
                                    device="cpu")
    jparams = jax_params_from_state_dict(sd, jcfg, jax_codecs.GGML_TYPE_Q4_0)
    for causal in (True, False):
        eng = Engine(cfg, params, causal=causal, device="cpu")
        jeng = JaxEngine(jcfg, jparams, causal=causal)
        assert eng._fused_decode == jeng._fused_decode == causal
        assert eng._fused_greedy == causal


def test_logits_for_tokens_equals_jax(state):
    ids = np.random.RandomState(2).randint(4, 200, size=(2, 7))
    want = jax_logits_for_tokens(jax_params_from_state_dict(state, JTINY),
                                 jnp.asarray(ids, jnp.int32), JTINY)
    got = logits_for_tokens(params_from_state_dict(state, TINY, device="cpu"),
                            torch.as_tensor(ids), TINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_warmup_leaves_generation_unchanged():
    # a width the fused decode step and the argmax tail take (their plain
    # versions here)
    cfg = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=1)
    params = params_from_state_dict(make_state_dict(cfg, seed=6), cfg,
                                    codecs.GGML_TYPE_Q4_0, device="cpu")
    gen = GenerationParams(n_predict=3, temp=0.0, stop_at_eos=False)
    sampled = dataclasses.replace(gen, temp=0.9, seed=3)
    prompt = [2, 10, 25, 48]
    cold = Engine(cfg, params, device="cpu")
    assert cold._fused_greedy
    want = (cold.generate(prompt, gen).ids, cold.generate(prompt, sampled).ids)
    warm = Engine(cfg, params, device="cpu")
    warm.warmup(prompt_len=4, n_tokens=2)
    assert (warm.generate(prompt, gen).ids,
            warm.generate(prompt, sampled).ids) == want


def test_tools_mains_run_on_the_cpu(f32_file, tmp_path, capsys):
    from biogpt_tpu_torch.tools import convert_hf, perplexity, quantize_cli

    hf = tmp_path / "hf"
    write_synthetic_hf_dir(hf, seed=2)
    assert convert_hf.main(["--dir-model", str(hf), "--out-dir",
                            str(tmp_path), "--device", "cpu"]) == 0
    q = tmp_path / "q.bin"
    assert quantize_cli.main([str(tmp_path / "ggml-model.bin"), str(q),
                              "--type", "q4_1", "--quiet", "--device",
                              "cpu"]) == 0
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the cells grow and the protein binds the receptor")
    capsys.readouterr()
    assert perplexity.main(["-m", str(q), "-f", str(corpus), "--window", "16",
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("tokens=") and "ppl=" in out
    assert os.path.getsize(q) < os.path.getsize(tmp_path / "ggml-model.bin")
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quantize_cli.main([str(tmp_path / "ggml-model.bin"), str(q),
                               "--type", "q4_1", "--quiet"])
