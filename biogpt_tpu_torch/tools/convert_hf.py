"""Convert a HuggingFace BioGPT checkpoint directory to a model file.

    python -m biogpt_tpu_torch.tools.convert_hf --dir-model DIR --out-dir DIR
        [--use-f16] [--device cuda|cpu]

Reads ``config.json``, ``vocab.json``, ``merges.txt`` and the weights
(``pytorch_model.bin``, else ``model.safetensors``) and writes
``ggml-model.bin`` (``modelio.ggml_format``). Tensors are squeezed and
stored f32, or f16 for 2-D ``*.weight`` tensors with ``--use-f16`` (the
reference ``convert.py``'s policy). Host work only: ``--device`` is
checked as every entry point checks it (cuda by default, which needs a
card; cpu runs anywhere) and nothing runs on it.

``model.safetensors`` is read by :func:`read_safetensors`, with no
``safetensors`` package: its records follow the file's own order (the
format keeps no other), so a converted file holds the same records as
one converted from ``pytorch_model.bin``, perhaps in another order.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

import numpy as np

from ..config import FTYPE_F16, FTYPE_F32, BioGptConfig
from ..device import resolve_device
from ..modelio import ggml_format
from ..modelio.ggml_format import tensor_record_from_array

# safetensors dtype names -> numpy (BF16 widens through a u16 view)
_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def read_safetensors(path: str | Path) -> dict:
    """A ``.safetensors`` file -> {name: numpy array}, in the header's
    order: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (offsets into the buffer that
    follows it) and the raw little-endian buffer."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"tensor '{name}': unsupported safetensors "
                             f"dtype {meta['dtype']}")
        begin, end = meta["data_offsets"]
        arr = np.frombuffer(buf[begin:end],
                            dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(meta["shape"])
    return out


def _load_state_dict(dir_model: Path) -> dict:
    pt = dir_model / "pytorch_model.bin"
    st = dir_model / "model.safetensors"
    if pt.exists():
        import torch
        with open(pt, "rb") as f:
            checkpoint = torch.load(f, map_location="cpu", weights_only=True)
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in checkpoint.items()}
    if st.exists():
        return read_safetensors(st)
    raise FileNotFoundError(
        f"no pytorch_model.bin or model.safetensors in {dir_model}")


def convert(dir_model: str | Path, out_dir: str | Path, use_f16: bool = False,
            verbose: bool = True) -> Path:
    """Write ``out_dir/ggml-model.bin`` from the checkpoint in ``dir_model``;
    returns its path."""
    dir_model = Path(dir_model)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    with open(dir_model / "config.json", encoding="utf-8") as f:
        hf = json.load(f)
    with open(dir_model / "vocab.json", encoding="utf-8") as f:
        vocab = json.load(f)
    with open(dir_model / "merges.txt", encoding="utf-8") as f:
        lines = f.read().split("\n")[:-1]
    # skip headers and blank lines; a merge line is "first second"
    merges = [tuple(parts[:2]) for line in lines
              if len(parts := line.split()) >= 2]

    config = BioGptConfig(
        n_vocab=hf["vocab_size"],
        n_merges=len(merges),
        d_ff=hf["intermediate_size"],
        d_model=hf["hidden_size"],
        n_layer=hf["num_hidden_layers"],
        n_head=hf["num_attention_heads"],
        n_positions=hf["max_position_embeddings"],
        ftype=FTYPE_F16 if use_f16 else FTYPE_F32,
    )

    state_dict = _load_state_dict(dir_model)
    out_path = out_dir / "ggml-model.bin"

    def records():
        for name, arr in state_dict.items():
            arr = np.squeeze(np.asarray(arr))
            if verbose:
                print(f"  {name:55s} {str(tuple(arr.shape)):>16s}")
            yield tensor_record_from_array(name, arr, use_f16=use_f16)

    ggml_format.write_model_file(out_path, config, vocab, merges, records())
    if verbose:
        size = out_path.stat().st_size
        print(f"wrote {out_path} ({size / 1e6:.2f} MB, "
              f"{'f16' if use_f16 else 'f32'})")
    return out_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a HuggingFace BioGPT checkpoint to a model file.")
    parser.add_argument("--dir-model", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--use-f16", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the work is the host's")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    convert(args.dir_model, args.out_dir, use_f16=args.use_f16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
