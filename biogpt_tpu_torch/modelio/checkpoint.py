"""Checkpoint -> params dict of torch tensors.

Maps the HF BioGPT tensor names (the keys in the model file) onto the same
params structure as the JAX package:

  params = {
    "embed_tokens":    (n_vocab, d_model) tensor | QuantizedTensor (row-major)
    "embed_positions": (n_positions + 2, d_model) float32 (always dense)
    "final_ln":        {"w": (d_model,), "b": (d_model,)}
    "lm_head":         (d_model, n_vocab) kernel | QuantizedTensor (planes)
    "layers":          one dict of LAYER-STACKED tensors (leading axis L):
       {"ln0": {w,b}, "ln1": {w,b},               (L, d_model)
        "q"|"k"|"v"|"o":  {"w": (L, d_model, d_model) | QT, "b": (L, d_model)},
        "fc1": {"w": (L, d_model, d_ff) | QT, "b": (L, d_ff)},
        "fc2": {"w": (L, d_ff, d_model) | QT, "b": (L, d_model)}}
  }

Matmul weights are in kernel orientation (d_in, d_out); quantized weights
stay in plane layout and are dequantized inside the matmul ops.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import BioGptConfig
from ..device import resolve_device
from ..quant import codecs
from ..quant.layouts import QuantizedTensor, to_lookup_planes, to_planes
from . import ggml_format
from .ggml_format import TensorRecord


def _dense(rec: TensorRecord) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rec.to_float32()))


def _matmul_weight(rec: TensorRecord):
    """2-D torch-(out,in) weight record -> kernel (in,out) dense or planes."""
    if rec.ttype in (codecs.GGML_TYPE_F32, codecs.GGML_TYPE_F16):
        return torch.from_numpy(np.ascontiguousarray(rec.to_float32().T))
    return to_planes(rec.data, rec.shape, rec.ttype)


def _embedding_weight(rec: TensorRecord):
    if rec.ttype in (codecs.GGML_TYPE_F32, codecs.GGML_TYPE_F16):
        return _dense(rec)
    return to_lookup_planes(rec.data, rec.shape, rec.ttype)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf (QuantizedTensor planes included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.map(fn)
    return fn(tree)


def stack_layers(layer_list: list) -> dict:
    """List of per-layer dicts -> one dict of (L, ...) stacked tensors."""
    first = layer_list[0]
    if isinstance(first, dict):
        return {k: stack_layers([lay[k] for lay in layer_list]) for k in first}
    if isinstance(first, QuantizedTensor):
        return QuantizedTensor(
            levels=torch.stack([q.levels for q in layer_list]),
            scales=torch.stack([q.scales for q in layer_list]),
            mins=(torch.stack([q.mins for q in layer_list])
                  if first.mins is not None else None),
            qtype=first.qtype, packed=first.packed)
    return torch.stack(layer_list)


def layer_slice(layers: dict, i: int) -> dict:
    """Per-layer view of the stacked layer dict."""
    return tree_map(lambda a: a[i], layers)


def params_from_records(records: Dict[str, TensorRecord],
                        config: BioGptConfig) -> dict:
    """Assemble the params dict (CPU tensors) from named tensor records."""

    def rec(name: str) -> TensorRecord:
        if name not in records:
            raise KeyError(f"model file is missing tensor '{name}'")
        return records[name]

    layers = []
    for i in range(config.n_layer):
        p = f"biogpt.layers.{i}."
        layer = {
            "ln0": {"w": _dense(rec(p + "self_attn_layer_norm.weight")),
                    "b": _dense(rec(p + "self_attn_layer_norm.bias"))},
            "ln1": {"w": _dense(rec(p + "final_layer_norm.weight")),
                    "b": _dense(rec(p + "final_layer_norm.bias"))},
            "fc1": {"w": _matmul_weight(rec(p + "fc1.weight")),
                    "b": _dense(rec(p + "fc1.bias"))},
            "fc2": {"w": _matmul_weight(rec(p + "fc2.weight")),
                    "b": _dense(rec(p + "fc2.bias"))},
        }
        for short, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
            layer[short] = {
                "w": _matmul_weight(rec(f"{p}self_attn.{hf}.weight")),
                "b": _dense(rec(f"{p}self_attn.{hf}.bias")),
            }
        layers.append(layer)
    return {
        "embed_tokens": _embedding_weight(rec("biogpt.embed_tokens.weight")),
        "embed_positions": _dense(rec("biogpt.embed_positions.weight")),
        "final_ln": {"w": _dense(rec("biogpt.layer_norm.weight")),
                     "b": _dense(rec("biogpt.layer_norm.bias"))},
        "lm_head": _matmul_weight(rec("output_projection.weight")),
        "layers": stack_layers(layers),
    }


def load_params(path: str | Path, device="cuda"):
    """Read a ggml-model.bin -> (config, token_to_id, merges, params) with
    the params on ``device``."""
    from ..utils.logging import get_logger

    dev = resolve_device(device)
    log = get_logger("modelio")
    config, token_to_id, merges, records = ggml_format.read_model_file(path)
    log.info("loaded %s: n_vocab=%d n_layer=%d d_model=%d ftype=%d, %d tensors",
             path, config.n_vocab, config.n_layer, config.d_model,
             config.ftype, len(records))
    params = params_from_records(records, config)
    return config, token_to_id, merges, tree_map(lambda a: a.to(dev), params)


def should_quantize(name: str, shape: Tuple[int, ...]) -> bool:
    """The reference's quantization rule (``biogpt.cpp:523``): "weight" in
    the name and a 2-D tensor whose first dim is not 1."""
    return "weight" in name and len(shape) == 2 and shape[0] != 1


def params_from_state_dict(state_dict: Dict[str, "np.ndarray | torch.Tensor"],
                           config: BioGptConfig, qtype: int | None = None,
                           device="cuda") -> dict:
    """Torch-layout state dict (HF names; numpy arrays or CPU tensors) ->
    the params on ``device``, as ``params_from_records`` builds them from
    a model file. Tensors are squeezed as the converter squeezes them;
    ``qtype`` (a GGML_TYPE_* code) quantizes those :func:`should_quantize`
    selects through the codec, so the planes are those of the quantized
    file."""
    dev = resolve_device(device)
    records: Dict[str, TensorRecord] = {}
    for name, arr in state_dict.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.squeeze(np.asarray(arr, dtype=np.float32))
        if qtype is not None and should_quantize(name, arr.shape):
            records[name] = TensorRecord(
                name=name, shape=tuple(arr.shape), ttype=qtype,
                data=codecs.quantize_rows(arr, qtype))
        else:
            if not arr.flags.writeable:   # e.g. a memory-mapped array
                arr = arr.copy()
            records[name] = TensorRecord(
                name=name, shape=tuple(arr.shape),
                ttype=codecs.GGML_TYPE_F32, data=arr)
    return tree_map(lambda a: a.to(dev), params_from_records(records, config))


def _tensor_from_numpy(a) -> torch.Tensor:
    """numpy (or JAX-on-host) array -> torch tensor with identical bytes;
    bfloat16 arrays (ml_dtypes) travel through a uint16 view."""
    a = np.asarray(a)
    if not a.flags.writeable:   # e.g. a memory-mapped cache file
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_numpy(tree, device="cuda"):
    """A params tree of numpy leaves (the JAX package's ``load_params``
    output, before or after its engine's weight packing) -> the port's
    params with identical bytes on ``device``.

    JAX quantized weights are duck-typed by their fields ``levels``,
    ``scales``, ``mins``, ``qtype`` and ``packed``; dicts recurse; every
    other leaf is an array.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if all(hasattr(x, f) for f in ("levels", "scales", "mins", "qtype",
                                        "packed")):
            return QuantizedTensor(
                levels=_tensor_from_numpy(x.levels).to(dev),
                scales=_tensor_from_numpy(x.scales).to(dev),
                mins=(_tensor_from_numpy(x.mins).to(dev)
                      if x.mins is not None else None),
                qtype=int(x.qtype), packed=bool(x.packed))
        return _tensor_from_numpy(x).to(dev)

    return conv(tree)
