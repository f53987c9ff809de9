"""Synthetic model files for tests and offline drives.

No BioGPT checkpoint ships with the repository, so these helpers write a
random model with the exact HF tensor-name/shape contract and a small
working character-level BPE vocabulary, through the real file format.

``make_state_dict`` draws the JAX package's seeded gaussian state dict
(``np.random.RandomState``, the same draws in the same order, so the
arrays are equal); ``write_synthetic_model`` writes it as an f32 (or f16)
model file and ``write_synthetic_hf_dir`` as the HuggingFace checkpoint
directory the converter reads (``write_hf_dir``: ``config.json``,
``vocab.json``, ``merges.txt``, ``pytorch_model.bin``). Nothing is cached
on disk.

``write_random_quantized_model`` writes random ggml block BYTES straight
into a Q4_0 or Q4_1 file (random levels, f16 scales in [0.005, 0.02],
Q4_1 minima in [-0.2, -0.05]) — the same draw ranges as the JAX package's
``make_random_quantized_params`` — so a full-width 347M file takes seconds
instead of a float-codec pass over 347M values. A Q5_0/Q8_0 (Q5_1) file
holds the same seed's Q4_0 (Q4_1) model re-quantized by the reference
codec, as the quantize tool makes one model's files: every format then
carries weights of one magnitude (random Q8_0 level bytes under Q4 scales
would make every weight 16 times larger).
"""

from __future__ import annotations

import json
import string
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..config import (BioGptConfig, FTYPE_Q4_0, FTYPE_Q4_1, FTYPE_Q5_0,
                      FTYPE_Q5_1, FTYPE_Q8_0)
from ..quant import codecs
from . import ggml_format
from .ggml_format import TensorRecord, tensor_record_from_array

_FTYPE_FOR_QTYPE = {
    codecs.GGML_TYPE_Q4_0: FTYPE_Q4_0,
    codecs.GGML_TYPE_Q4_1: FTYPE_Q4_1,
    codecs.GGML_TYPE_Q5_0: FTYPE_Q5_0,
    codecs.GGML_TYPE_Q5_1: FTYPE_Q5_1,
    codecs.GGML_TYPE_Q8_0: FTYPE_Q8_0,
}


def make_char_vocab(n_vocab: int) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A character-level BPE vocab: specials, printable chars, char</w> forms,
    and a few common merges. Tokenizes any ASCII text without <unk>."""
    tokens: Dict[str, int] = {"<unk>": 0, "<s>": 1, "</s>": 2, "<pad>": 3}
    chars = string.ascii_letters + string.digits + string.punctuation
    for ch in chars:
        tokens.setdefault(ch, len(tokens))
    for ch in chars:
        tokens.setdefault(ch + "</w>", len(tokens))
    merges: List[Tuple[str, str]] = []
    for a, b in [("t", "h"), ("th", "e</w>"), ("i", "n"), ("a", "n"),
                 ("e", "r"), ("o", "n"), ("e", "n"), ("an", "d</w>")]:
        if len(tokens) >= n_vocab:
            break
        merges.append((a, b))
        tokens.setdefault(a + b, len(tokens))
    if len(tokens) > n_vocab:
        raise ValueError(f"n_vocab={n_vocab} too small (need {len(tokens)})")
    for i in range(len(tokens), n_vocab):
        tokens[f"[unused_{i}]"] = i
    return tokens, merges


def _tensor_shapes(config: BioGptConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """HF BioGPT tensor names and torch-order shapes, in file order."""
    d, ff = config.d_model, config.d_ff
    shapes = [
        ("biogpt.embed_tokens.weight", (config.n_vocab, d)),
        ("biogpt.embed_positions.weight",
         (config.n_positions + config.pos_offset, d)),
        ("biogpt.layer_norm.weight", (d,)),
        ("biogpt.layer_norm.bias", (d,)),
        ("output_projection.weight", (config.n_vocab, d)),
    ]
    for i in range(config.n_layer):
        p = f"biogpt.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes += [(p + f"self_attn.{proj}.weight", (d, d)),
                       (p + f"self_attn.{proj}.bias", (d,))]
        shapes += [(p + "self_attn_layer_norm.weight", (d,)),
                   (p + "self_attn_layer_norm.bias", (d,)),
                   (p + "final_layer_norm.weight", (d,)),
                   (p + "final_layer_norm.bias", (d,)),
                   (p + "fc1.weight", (ff, d)), (p + "fc1.bias", (ff,)),
                   (p + "fc2.weight", (d, ff)), (p + "fc2.bias", (d,))]
    return shapes


def make_state_dict(config: BioGptConfig, seed: int = 0,
                    scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random torch-layout state dict with the HF BioGPT names and shapes:
    N(0, scale) f32 weights and biases, layer norms ones and zeros."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in _tensor_shapes(config):
        if "layer_norm" in name:
            fill = 1.0 if name.endswith("weight") else 0.0
            sd[name] = np.full(shape, fill, np.float32)
        else:
            sd[name] = (rng.randn(*shape) * scale).astype(np.float32)
    return sd


def write_synthetic_model(path: str | Path, config: BioGptConfig | None = None,
                          seed: int = 0, use_f16: bool = False) -> BioGptConfig:
    """Write :func:`make_state_dict`'s model as an f32 file (f16 for the 2-D
    weights with ``use_f16``); returns its config."""
    config = config or BioGptConfig.tiny()
    vocab, merges = make_char_vocab(config.n_vocab)
    sd = make_state_dict(config, seed=seed)
    records = (tensor_record_from_array(name, arr, use_f16=use_f16)
               for name, arr in sd.items())
    ggml_format.write_model_file(path, config, vocab, merges, records)
    return config


def write_hf_dir(dir_path: str | Path, config: BioGptConfig,
                 state_dict: Dict[str, np.ndarray]) -> None:
    """Write ``state_dict`` as a HuggingFace BioGPT checkpoint directory:
    ``config.json`` (the HF schema's keys), ``vocab.json`` and
    ``merges.txt`` (:func:`make_char_vocab`) and ``pytorch_model.bin``."""
    import torch

    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    vocab, merges = make_char_vocab(config.n_vocab)
    hf = {
        "model_type": "biogpt",
        "vocab_size": config.n_vocab,
        "hidden_size": config.d_model,
        "intermediate_size": config.d_ff,
        "num_hidden_layers": config.n_layer,
        "num_attention_heads": config.n_head,
        "max_position_embeddings": config.n_positions,
    }
    with open(dir_path / "config.json", "w", encoding="utf-8") as f:
        json.dump(hf, f)
    with open(dir_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(dir_path / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state_dict.items()},
               dir_path / "pytorch_model.bin")


def write_synthetic_hf_dir(dir_path: str | Path,
                           config: BioGptConfig | None = None,
                           seed: int = 0) -> BioGptConfig:
    """Write :func:`make_state_dict`'s model as a HuggingFace checkpoint
    directory (:func:`write_hf_dir`), the converter's input; returns its
    config."""
    config = config or BioGptConfig.tiny()
    write_hf_dir(dir_path, config, make_state_dict(config, seed=seed))
    return config


def _random_blocks(rng: np.random.Generator, n_blocks: int, qtype: int) -> bytes:
    """Random ggml blocks: random level bytes, f16 scale (and min) fields
    overwritten with draws from the synthetic ranges."""
    bs = codecs.BLOCK_SIZES[qtype]
    blocks = rng.integers(0, 256, size=(n_blocks, bs), dtype=np.uint8)
    blocks[:, 0:2] = (rng.uniform(0.005, 0.02, n_blocks).astype(np.float16)
                      .view(np.uint8).reshape(n_blocks, 2))
    if qtype == codecs.GGML_TYPE_Q4_1:
        blocks[:, 2:4] = ((-rng.uniform(0.05, 0.2, n_blocks)).astype(np.float16)
                          .view(np.uint8).reshape(n_blocks, 2))
    return blocks.tobytes()


def write_random_quantized_model(path: str | Path, config: BioGptConfig,
                                 qtype: int = codecs.GGML_TYPE_Q4_0,
                                 seed: int = 0) -> BioGptConfig:
    """Write a random quantized model file; returns its config.

    Tensors that the reference quantization rule selects ("weight" in the
    name, 2-D) carry random Q4_0/Q4_1 block bytes, re-quantized to
    ``qtype`` where it is another format (see the module docstring); layer
    norms are ones and zeros; biases are N(0, 0.02) float32.
    """
    import dataclasses

    config = dataclasses.replace(config, ftype=_FTYPE_FOR_QTYPE[qtype])
    rng = np.random.default_rng(seed)
    vocab, merges = make_char_vocab(config.n_vocab)
    # the random blocks are drawn as Q4 ones; other formats re-quantize them
    drawn = (qtype if qtype in (codecs.GGML_TYPE_Q4_0, codecs.GGML_TYPE_Q4_1)
             else codecs.GGML_TYPE_Q4_1 if qtype == codecs.GGML_TYPE_Q5_1
             else codecs.GGML_TYPE_Q4_0)

    def records():
        for name, shape in _tensor_shapes(config):
            if "weight" in name and len(shape) == 2:
                n_blocks = shape[0] * shape[1] // codecs.QK
                data = _random_blocks(rng, n_blocks, drawn)
                if drawn != qtype:
                    data = codecs.quantize_blocks(
                        codecs.dequantize_blocks(data, drawn), qtype).tobytes()
                yield TensorRecord(name=name, shape=shape, ttype=qtype,
                                   data=data)
                continue
            if "layer_norm" in name:
                fill = 1.0 if name.endswith("weight") else 0.0
                arr = np.full(shape, fill, np.float32)
            else:
                arr = (rng.standard_normal(shape) * 0.02).astype(np.float32)
            yield TensorRecord(name=name, shape=shape,
                               ttype=codecs.GGML_TYPE_F32, data=arr.tobytes())

    ggml_format.write_model_file(path, config, vocab, merges, records())
    return config
