"""A random BioGPT model from a run's seed, as the bytes of a ggml model
file's tensors, made on the device in a few large calls.

Every 2-D weight (the reference quantizer's rule: "weight" in the name, 2-D)
is a run of ggml blocks of the configuration's format: random level bytes
and a random 16-bit scale per 32 weights, uniform in [0.005, 0.02] for
Q4_0 and that over 16 for Q8_0, so both formats carry weights of one
magnitude (Q4_0's levels run -8..7, Q8_0's -128..127). Biases are
N(0, 0.02); LayerNorms ones and zeros. Random weights suffice for speed
and for holding the program to the reference.

The program gets the bytes as the tensor records of a model file
(``biogpt_tpu_torch.modelio.checkpoint.params_from_records``, its own
loader); the reference reads the same bytes (:class:`SeedWeights`). No
file is written.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

QK = 32
BLOCK_BYTES = {"q4_0": 18, "q8_0": 34}
GGML_TYPE = {"q4_0": 2, "q8_0": 8, "f32": 0}   # the file's tensor type codes
SCALE = {"q4_0": (0.005, 0.02), "q8_0": (0.005 / 16, 0.02 / 16)}


def tensor_shapes(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """The model file's tensors: HF BioGPT names and torch-order shapes."""
    d, ff = m["d_model"], m["d_ff"]
    shapes = [("biogpt.embed_tokens.weight", (m["n_vocab"], d)),
              ("biogpt.embed_positions.weight",
               (m["n_positions"] + m["pos_offset"], d)),
              ("biogpt.layer_norm.weight", (d,)),
              ("biogpt.layer_norm.bias", (d,)),
              ("output_projection.weight", (m["n_vocab"], d))]
    for i in range(m["n_layer"]):
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


def quantized(name: str, shape: tuple) -> bool:
    return "weight" in name and len(shape) == 2


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a torch generator from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@dataclass
class SeedWeights:
    """The seed's model: ``blocks`` (n_blocks, block bytes) uint8 of every
    quantized tensor in file order on the host, ``where`` name -> (first
    block, blocks, shape), and the dense tensors (f32, host)."""
    fmt: str
    blocks: np.ndarray
    where: Dict[str, Tuple[int, int, tuple]]
    dense: Dict[str, np.ndarray]

    def records(self) -> dict:
        """name -> the program's ``TensorRecord`` of the same bytes."""
        from biogpt_tpu_torch.modelio.ggml_format import TensorRecord

        out = {}
        for name, (b0, nb, shape) in self.where.items():
            data = self.blocks[b0:b0 + nb]
            if name == "biogpt.embed_positions.weight":
                # a dense parameter of the model: its loader dequantizes
                # the record's raw bytes
                data = data.tobytes()
            out[name] = TensorRecord(name=name, shape=shape,
                                     ttype=GGML_TYPE[self.fmt], data=data)
        for name, arr in self.dense.items():
            out[name] = TensorRecord(name=name, shape=arr.shape,
                                     ttype=GGML_TYPE["f32"], data=arr)
        return out


def make(m: dict, fmt: str, seed: int, device) -> SeedWeights:
    """The seed's model, drawn on ``device`` by one generator in four
    calls (level bytes, scales, biases; LayerNorms are constant) and
    copied to the host once."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(torch_seed(seed, 7))
    shapes = tensor_shapes(m)
    where, nb_total = {}, 0
    for name, shape in shapes:
        if quantized(name, shape):
            nb = shape[0] * shape[1] // QK
            where[name] = (nb_total, nb, shape)
            nb_total += nb
    bs = BLOCK_BYTES[fmt]
    blocks = torch.randint(0, 256, (nb_total, bs), dtype=torch.uint8,
                           device=dev, generator=g)
    lo, hi = SCALE[fmt]
    scales = torch.rand(nb_total, device=dev, generator=g) * (hi - lo) + lo
    blocks[:, 0:2] = scales.to(torch.float16).view(torch.uint8).view(
        nb_total, 2)
    biases = [(n, s) for n, s in shapes
              if not quantized(n, s) and n.endswith("bias")
              and "layer_norm" not in n]
    n_bias = sum(s[0] for _, s in biases)
    draws = (torch.randn(n_bias, device=dev, generator=g) * 0.02).cpu().numpy()
    dense, off = {}, 0
    for name, shape in shapes:
        if quantized(name, shape):
            continue
        if "layer_norm" in name:
            fill = 1.0 if name.endswith("weight") else 0.0
            dense[name] = np.full(shape, fill, np.float32)
        else:
            dense[name] = draws[off:off + shape[0]]
            off += shape[0]
    return SeedWeights(fmt=fmt, blocks=blocks.cpu().numpy(), where=where,
                       dense=dense)
