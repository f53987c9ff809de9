"""The port's loading path (ggml reader and writer, plane layout, nibble
packing, the weight carry-across, tokenizer) against the JAX package, and
the port's import rule."""

import os
import subprocess
import sys

import numpy as np
import pytest

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.modelio.checkpoint import load_params as jax_load_params
from biogpt_tpu.modelio.synthetic import make_char_vocab as jax_char_vocab
from biogpt_tpu.modelio.synthetic import write_synthetic_model
from biogpt_tpu.quant import codecs
from biogpt_tpu.quant.layouts import pack_nibble_planes as jax_pack
from biogpt_tpu.tokenizer import BioGptTokenizer as JaxTokenizer
from biogpt_tpu.tools.quantize_cli import main as quantize

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.modelio.checkpoint import load_params, params_from_numpy
from biogpt_tpu_torch.modelio.synthetic import (make_char_vocab,
                                                write_random_quantized_model)
from biogpt_tpu_torch.quant.layouts import (pack_nibble_planes,
                                            unpack_nibble_planes)
from biogpt_tpu_torch.tokenizer import BioGptTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = BioGptConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=2,
                        n_vocab=256, n_positions=32)
QNAMES = ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0"]


def _leaves(tree, path=""):
    """(path, numpy array) of every plane, QuantizedTensor fields included,
    for either package's params."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif hasattr(tree, "levels") and hasattr(tree, "qtype"):
        yield f"{path}.qtype", np.asarray(int(tree.qtype))
        yield f"{path}.packed", np.asarray(bool(tree.packed))
        for f in ("levels", "scales", "mins"):
            v = getattr(tree, f)
            if v is not None:
                yield f"{path}.{f}", _np(v)
    else:
        yield path, _np(tree)


def _np(a):
    if hasattr(a, "detach"):
        import torch
        if a.dtype == torch.bfloat16:
            return a.view(torch.uint16).numpy()
        return a.detach().numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_bytes(tree_j, tree_t):
    lj, lt = dict(_leaves(tree_j)), dict(_leaves(tree_t))
    assert lj.keys() == lt.keys()
    for k in lj:
        assert lj[k].dtype == lt[k].dtype and lj[k].shape == lt[k].shape, k
        np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)


@pytest.fixture(scope="module")
def quantized_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_modelio")
    src = d / "model.bin"
    write_synthetic_model(src, CFG, seed=5)
    out = {}
    for q in QNAMES:
        out[q] = d / f"model-{q}.bin"
        quantize([str(src), str(out[q]), "--type", q, "--quiet"])
    return out


@pytest.mark.parametrize("qname", QNAMES)
def test_planes_byte_equal_to_jax(quantized_files, qname):
    """Unpacked planes from the same file, then nibble-packed planes."""
    path = quantized_files[qname]
    cj, vocab_j, merges_j, pj = jax_load_params(path)
    ct, vocab_t, merges_t, pt = load_params(path, device="cpu")
    assert (ct.n_layer, ct.d_model, ct.ftype) == (cj.n_layer, cj.d_model,
                                                  cj.ftype)
    assert vocab_t == vocab_j and merges_t == merges_j
    _assert_same_bytes(pj, pt)
    qj, qt = pj["layers"]["fc2"]["w"], pt["layers"]["fc2"]["w"]
    packed_j, packed_t = jax_pack(qj), pack_nibble_planes(qt)
    _assert_same_bytes({"w": packed_j}, {"w": packed_t})
    _assert_same_bytes({"w": qj}, {"w": unpack_nibble_planes(packed_t)})


@pytest.mark.parametrize("qtype", [codecs.GGML_TYPE_Q4_0,
                                   codecs.GGML_TYPE_Q4_1,
                                   codecs.GGML_TYPE_Q5_0,
                                   codecs.GGML_TYPE_Q5_1,
                                   codecs.GGML_TYPE_Q8_0])
def test_port_written_file_loads_in_jax(tmp_path, qtype):
    """``write_random_quantized_model`` writes raw ggml block bytes that
    the JAX reader decodes to the same planes as the port's reader: random
    Q4 blocks, and for Q5_0, Q5_1 and Q8_0 the same seed's Q4_0 (Q4_1)
    model re-quantized, byte for byte as the JAX codec re-quantizes it."""
    from biogpt_tpu.quant.layouts import from_planes, quantize_to_planes

    cfg = TorchConfig.tiny(d_model=128, d_ff=256, n_head=2, n_layer=2,
                           n_vocab=256, n_positions=32)
    path = tmp_path / "rand.bin"
    write_random_quantized_model(path, cfg, qtype=qtype, seed=3)
    _, vj, _, pj = jax_load_params(path)
    _, vt, _, pt = load_params(path, device="cpu")
    assert vj == vt
    _assert_same_bytes(pj, pt)
    scales = np.asarray(pj["lm_head"].scales, np.float32)
    if qtype in (codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1):
        assert 0.0049 <= scales.min() and scales.max() <= 0.0201
        return
    drawn = (codecs.GGML_TYPE_Q4_1 if qtype == codecs.GGML_TYPE_Q5_1
             else codecs.GGML_TYPE_Q4_0)
    src = tmp_path / "drawn.bin"
    write_random_quantized_model(src, cfg, qtype=drawn, seed=3)
    _, _, _, ps = jax_load_params(src)
    # lm_head planes are (d_in, d_out); the codec quantizes (d_out, d_in)
    want = quantize_to_planes(from_planes(ps["lm_head"]).T, qtype)
    for a, b in ((pj["lm_head"].levels, want.levels),
                 (pj["lm_head"].scales, want.scales),
                 (pj["lm_head"].mins, want.mins)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_from_numpy_keeps_engine_packed_bytes(quantized_files):
    """The carry-across after the JAX engine's packing (bf16 scales,
    fused qkv, padded lm_head) keeps every byte."""
    from biogpt_tpu.runtime.engine import _pack_matmul_weights

    _, _, _, pj = jax_load_params(quantized_files["q4_1"])
    packed = _pack_matmul_weights(pj)
    _assert_same_bytes(packed, params_from_numpy(packed, device="cpu"))


def test_char_vocab_matches_jax():
    assert make_char_vocab(300) == jax_char_vocab(300)


TEXTS = ["COVID-19 is", "The meaning of life", "Aspirin inhibits COX-2.",
         "p53 (TP53) mutations in 50% of tumours",
         "Dr. Smith's lab, e.g. in vitro.", "α-synuclein aggregates",
         "IL-6/JAK/STAT3 signalling", "\"quoted\" and 'single' marks",
         "numbers: 3.14, 1,000 and 10^-6", "", "   spaces   ",
         "Bienvenue à l'hôpital"]


def test_tokenizer_matches_jax():
    vocab, merges = make_char_vocab(400)
    tj, tt = JaxTokenizer(vocab, merges), BioGptTokenizer(vocab, merges)
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == tj.encode(text), text
        assert tt.decode(ids) == tj.decode(ids), text


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module (the serving engine, the HTTP server and the
    refill prefill kernels among them) and chip_smoke.py's imports, in a
    fresh process."""
    code = """
import importlib, pkgutil, sys
import biogpt_tpu_torch
for m in pkgutil.walk_packages(biogpt_tpu_torch.__path__, "biogpt_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from biogpt_tpu_torch.cli import main
from biogpt_tpu_torch.runtime.serving import BatchedEngine, ServingScheduler
from biogpt_tpu_torch.server import BioGptServer, main as server_main
from biogpt_tpu_torch.ops.prefill_kernels import prefill_fused, supports_prefill
from biogpt_tpu_torch.models.biogpt import forward_prefill_fused
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "biogpt_tpu" or k.startswith("biogpt_tpu."))
print(bad)
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
