"""Shardings of the unpacked weights and the KV cache over the (data,
model) mesh: the route a mesh takes without the packed tensor-parallel
path (``biogpt_tpu/parallel/sharding.py``, the JAX package's GSPMD route).

JAX annotates the params with PartitionSpecs and lets GSPMD partition the
per-op forward; its spec table is :func:`param_pspecs` here, each spec a
tuple of axis names (None: not sharded) over the leaf's dimensions:

  q, k, v, fc1  column-parallel: d_out over "model" (their biases too)
  o, fc2        row-parallel: d_in over "model" (their biases whole)
  lm_head       column-parallel over the vocab
  embed_tokens, embed_positions, the LayerNorms: whole

A quantized weight's planes share its spec: levels (d_in, d_out), scales
and mins (d_in / 32, d_out).

JAX's ``fit`` replicates any axis of a plane that the mesh does not divide
and GSPMD reshards wherever it must. The port has no GSPMD: every rank
holds its shard and the forward (``models.biogpt.forward(layout=)``) runs
the collectives itself. Its rule (:func:`shard_layout`): a weight is
sharded only where the model axis divides every one of its planes along
the spec's axis -- levels, scales, mins, and a column weight's bias -- and
else it is whole on every rank. The forward joins the two kinds as GSPMD
would:

  - a column shard's output holds this rank's columns, all-gathered over
    the model axis where the consumer needs the whole width;
  - a row shard takes this rank's columns of its input (a slice where the
    input is whole) and its partial product is summed over the model axis;
    a whole row weight takes its input whole (gathered where it is not);
  - attention runs on this rank's heads where q, k and v are all sharded
    and the model axis divides the heads, else on every head with q, k
    and v whole.

So wherever JAX shards every plane of a weight, the port's shard is JAX's
addressable shard, and the numbers are the single-device result up to the
order of the sums. The cache (:func:`cache_pspec`): the batch over "data"
where it divides (a replica's own slots, ``Mesh.batch_rows``), the
features over "model" where attention runs on local heads (else whole);
an int8 cache's scale planes are whole over "model", since
``cache.quantize_rows`` completes each row's absmax over the model group.

This route launches none of the port's CUDA kernels, as JAX's
``allow_pallas`` is False on it: the forward it returns runs the plain
products (``ops/qmatmul.py``'s dequantize-then-dot at m >= 32,
block-accumulated below) on the unpacked planes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import BioGptConfig
from ..modelio.checkpoint import tree_map
from ..quant.layouts import QuantizedTensor
from ..runtime.cache import KVCache, QuantKVCache
from .mesh import MODEL_AXIS, DATA_AXIS, Mesh

COL3 = (None, None, MODEL_AXIS)   # column-parallel: d_out of (L, d_in, d_out)
ROW3 = (None, MODEL_AXIS, None)   # row-parallel: d_in
BIAS3 = (None, MODEL_AXIS)        # a column weight's (L, d_out) bias
REP = ()                          # whole on every rank

# the weights the model axis can shard, by kind
COLUMN = ("q", "k", "v", "fc1")
ROW = ("o", "fc2")


def param_pspecs(params: dict) -> dict:
    """The spec tree of ``params`` (JAX ``param_pspecs``): layer tensors
    are layer-stacked, so their specs lead with None."""
    layer_specs = {
        "ln0": {"w": REP, "b": REP},
        "ln1": {"w": REP, "b": REP},
        **{n: {"w": COL3, "b": BIAS3} for n in COLUMN},
        **{n: {"w": ROW3, "b": REP} for n in ROW},
    }
    return {
        "embed_tokens": REP,
        "embed_positions": REP,
        "final_ln": {"w": REP, "b": REP},
        "lm_head": (None, MODEL_AXIS),
        "layers": layer_specs,
    }


def cache_pspec(batch_shardable: bool = True, quant: bool = False,
                heads: bool = True):
    """(L, B, S, D): B over "data" when ``batch_shardable``, D over "model"
    when attention runs on local heads (``heads``); an int8 cache's (L, B,
    1, S) scale planes have no D and are whole over "model"."""
    dspec = DATA_AXIS if batch_shardable else None
    spec = (None, dspec, None, MODEL_AXIS if heads else None)
    if quant:
        sspec = (None, dspec, None, None)
        return QuantKVCache(k=spec, v=spec, ks=sspec, vs=sspec)
    return KVCache(k=spec, v=spec)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which weights of the unpacked params are this rank's shards (the
    rest are whole on every rank), and whether attention runs on local
    heads (:func:`shard_layout`)."""
    sharded: frozenset
    heads: bool


def _planes(leaf) -> list:
    if isinstance(leaf, QuantizedTensor):
        return [a for a in (leaf.levels, leaf.scales, leaf.mins)
                if a is not None]
    return [leaf]


def _divides(spec: tuple, shape, mesh: Mesh) -> bool:
    return all(axis is None or dim % mesh.shape[axis] == 0
               for dim, axis in zip(shape, spec))


def _check_unpacked(name: str, w) -> None:
    if isinstance(w, QuantizedTensor) and w.packed:
        raise ValueError(f"{name}: packed planes interleave their rows; "
                         "this route shards unpacked weights")


def _sharded_weights(params: dict, mesh: Mesh) -> frozenset:
    """The weights whose every plane the model axis divides along its
    spec's axis."""
    specs = param_pspecs(params)
    sharded = set()
    for name in COLUMN + ROW + ("lm_head",):
        if name == "lm_head":
            leaves = [(params["lm_head"], specs["lm_head"])]
        else:
            leaf, spec = params["layers"][name], specs["layers"][name]
            leaves = [(leaf["w"], spec["w"]), (leaf["b"], spec["b"])]
        _check_unpacked(name, leaves[0][0])
        if all(_divides(spec, a.shape, mesh)
               for w, spec in leaves for a in _planes(w)):
            sharded.add(name)
    return frozenset(sharded)


def shard_layout(params: dict, config: BioGptConfig, mesh: Mesh) -> Layout:
    """The port's rule for the unpacked ``params`` on ``mesh`` (see the
    module docstring); on a model axis of one rank every weight is its own
    shard."""
    sharded = _sharded_weights(params, mesh)
    return Layout(sharded=sharded,
                  heads=({"q", "k", "v"} <= sharded
                         and config.n_head % mesh.model == 0))


def _shard(w, spec: tuple, mesh: Mesh):
    """This rank's chunk of every plane of ``w`` along the model axis of
    ``spec``."""
    axis = spec.index(MODEL_AXIS)
    r, n = mesh.index, mesh.model

    def take(a):
        size = a.shape[axis] // n
        return a.narrow(axis, r * size, size)
    return tree_map(take, w)


def shard_params(params: dict, mesh: Mesh,
                 layout: Optional[Layout] = None) -> dict:
    """This rank's shard of the unpacked ``params`` (q, k and v unfused) on
    its device: the sharded weights of ``layout`` (by default every weight
    whose planes all divide) cut along their spec's model axis, every
    other leaf whole."""
    sharded = (layout.sharded if layout is not None
               else _sharded_weights(params, mesh))
    specs = param_pspecs(params)
    out = dict(params)
    out["layers"] = dict(params["layers"])
    for name in sharded - {"lm_head"}:
        leaf, spec = params["layers"][name], specs["layers"][name]
        out["layers"][name] = {
            "w": _shard(leaf["w"], spec["w"], mesh),
            "b": (_shard(leaf["b"], spec["b"], mesh)
                  if MODEL_AXIS in spec["b"] else leaf["b"])}
    if "lm_head" in sharded:
        out["lm_head"] = _shard(params["lm_head"], specs["lm_head"], mesh)
    return tree_map(lambda a: a.contiguous().to(mesh.device), out)


def shard_cache(cache: KVCache, mesh: Mesh, layout: Layout) -> KVCache:
    """This rank's shard of a whole ``cache`` on its device, each plane cut
    along the axes of :func:`cache_pspec`."""
    lo, hi = mesh.batch_rows(cache.batch)
    specs = cache_pspec(batch_shardable=hi - lo < cache.batch,
                        quant=isinstance(cache, QuantKVCache),
                        heads=layout.heads)

    def take(a, spec):
        for axis, name in enumerate(spec):
            if name == DATA_AXIS:
                a = a.narrow(axis, lo, hi - lo)
            elif name == MODEL_AXIS:
                n = a.shape[axis] // mesh.model
                a = a.narrow(axis, mesh.index * n, n)
        return a.contiguous().to(mesh.device)
    return type(cache)(**{f.name: take(getattr(cache, f.name),
                                       getattr(specs, f.name))
                          for f in dataclasses.fields(cache)})


def make_sharded_forward(mesh: Mesh, layout: Layout):
    """A drop-in for ``models.biogpt.forward`` on this rank's shard (params
    from :func:`shard_params`, a cache of its replica's rows and, where
    attention runs on local heads, its heads' features); it runs
    no kernel whatever the caller's ``allow_kernels``."""
    from ..models.biogpt import forward

    def sharded_forward(params, tokens, cache, past, config: BioGptConfig,
                        compute_dtype=torch.float32, causal: bool = True,
                        logits_mode: str = "last", allow_kernels: bool = False,
                        kv_window: Optional[int] = None, last_index=None):
        return forward(params, tokens, cache, past, config,
                       compute_dtype=compute_dtype, causal=causal,
                       logits_mode=logits_mode, allow_kernels=False,
                       kv_window=kv_window, last_index=last_index, mesh=mesh,
                       layout=layout)

    return sharded_forward
