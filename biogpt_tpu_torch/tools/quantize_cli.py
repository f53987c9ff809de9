"""Quantize an f32/f16 model file to a block-quantized one.

    python -m biogpt_tpu_torch.tools.quantize_cli IN.bin OUT.bin --type q4_0
        [--device cuda|cpu]

Copies the magic, hparams, vocab and merges with the new ftype, then
streams the tensor records, re-encoding those the reference rule selects
("weight" in the name, 2-D; ``modelio.checkpoint.should_quantize``) with
the format's numpy codec (``quant.codecs``); f16 sources widen to f32
first. Host work only: ``--device`` is checked as every entry point
checks it (cuda by default, which needs a card; cpu runs anywhere) and
nothing runs on it.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from ..config import FTYPE_BY_NAME
from ..device import resolve_device
from ..modelio import ggml_format
from ..modelio.checkpoint import should_quantize
from ..quant import codecs

QUANT_CHOICES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0")


def quantize_file(path_in: str, path_out: str, type_name: str,
                  verbose: bool = True) -> dict:
    """Stream-quantize a model file -> {"bytes_in", "bytes_out", "seconds"}."""
    if type_name not in QUANT_CHOICES:
        raise ValueError(f"unsupported quant type '{type_name}' "
                         f"(choose from {', '.join(QUANT_CHOICES)})")
    ftype = FTYPE_BY_NAME[type_name]
    qtype = codecs.ggml_type_for_ftype(ftype)

    t0 = time.time()
    total_in = total_out = 0
    with open(path_in, "rb") as fin, open(path_out, "wb") as fout:
        config, vocab, merges = ggml_format.read_header(fin)
        ggml_format.write_header(
            fout, dataclasses.replace(config, ftype=ftype), vocab, merges)
        for rec in ggml_format.iter_tensor_records(fin):
            total_in += rec.nbytes_expected()
            if should_quantize(rec.name, rec.shape):
                if rec.ttype not in (codecs.GGML_TYPE_F32,
                                     codecs.GGML_TYPE_F16):
                    raise ValueError(
                        f"tensor '{rec.name}' has type "
                        f"{codecs.GGML_TYPE_NAMES.get(rec.ttype, rec.ttype)}; "
                        "only f32/f16 models can be quantized")
                data = codecs.quantize_blocks(
                    rec.to_float32().reshape(-1), qtype).tobytes()
                out_rec = ggml_format.TensorRecord(
                    name=rec.name, shape=rec.shape, ttype=qtype, data=data)
                if verbose:
                    print(f"  {rec.name:55s} {str(rec.shape):>16s} "
                          f"{codecs.GGML_TYPE_NAMES[rec.ttype]} -> {type_name} "
                          f"({len(data) / 1e6:.2f} MB)")
            else:
                out_rec = rec
                if verbose:
                    print(f"  {rec.name:55s} {str(rec.shape):>16s} "
                          f"{codecs.GGML_TYPE_NAMES.get(rec.ttype, '?')} "
                          "(copied)")
            total_out += out_rec.nbytes_expected()
            ggml_format.write_tensor_record(fout, out_rec)

    stats = {"bytes_in": total_in, "bytes_out": total_out,
             "seconds": time.time() - t0}
    if verbose:
        print(f"quantized {total_in / 1e6:.2f} MB -> {total_out / 1e6:.2f} MB "
              f"({type_name}) in {stats['seconds']:.2f}s")
    return stats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Quantize an f32/f16 model file to a block-quantized one.")
    parser.add_argument("model_in")
    parser.add_argument("model_out")
    parser.add_argument("--type", "-t", required=True, choices=QUANT_CHOICES)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the work is the host's")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    quantize_file(args.model_in, args.model_out, args.type,
                  verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
