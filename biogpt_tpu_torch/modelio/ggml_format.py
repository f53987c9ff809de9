"""Reader/writer for the ggml-model.bin serialization contract.

Little-endian layout (produced by the reference's ``convert.py:86-97`` and
consumed by ``biogpt_model_load``, ``biogpt.cpp:27-453``):

  1. int32 magic 0x67676d6c ('ggml')
  2. 7 x int32 hparams: n_vocab, n_layer, n_head, n_positions, d_ff,
     d_model, ftype  (n_merges is NOT in the file)
  3. vocab: int32 count, then per token {int32 len, utf8 bytes}
  4. merges: int32 count, then per merge {int32 len, "first second" utf8}
  5. tensor records until EOF:
     {int32 n_dims, int32 name_len, int32 ttype,
      int32 dims[n_dims]  (REVERSED vs torch order: dims[0] is fastest),
      name bytes, raw tensor data}

Existing reference-produced model files load unchanged. The converse claim
— files written here load in the reference engine — is by-construction
(the reference binary cannot be built in this environment: its ggml
submodule is absent from the mount) and cross-checked against an
independent C++ re-implementation of the reference loader contract,
``csrc/bgpt_reader.cpp``, which shares no code with this module
(tests/test_native.py::test_model_file_parses_in_independent_cpp_reader).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import BinaryIO, Dict, Iterable, Iterator, List, Tuple

import numpy as np

from ..config import BioGptConfig
from ..quant import codecs

GGML_MAGIC = 0x67676D6C

_TTYPE_DTYPES = {
    codecs.GGML_TYPE_F32: np.dtype("<f4"),
    codecs.GGML_TYPE_F16: np.dtype("<f2"),
}


@dataclass
class TensorRecord:
    """One tensor section of the file.

    ``shape`` is in torch/row-major order (shape[-1] varies fastest — the
    file stores dims reversed; this struct un-reverses). ``data`` is the raw
    on-disk bytes (f32/f16 values or ggml quant blocks per ``ttype``), or —
    for records built in memory from an existing array — the ndarray
    itself, which skips a serialize/parse copy of the whole model.
    """

    name: str
    shape: Tuple[int, ...]
    ttype: int
    data: "bytes | np.ndarray"

    @property
    def nelements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def nbytes_expected(self) -> int:
        if self.ttype in _TTYPE_DTYPES:
            return self.nelements * _TTYPE_DTYPES[self.ttype].itemsize
        bs = codecs.BLOCK_SIZES[self.ttype]
        return self.nelements // codecs.QK * bs

    def data_bytes(self) -> "bytes | np.ndarray":
        """On-disk bytes for writers, normalizing the ndarray variant:
        forces the ttype's little-endian dtype and C-contiguity so
        ``f.write`` (buffer protocol) emits exactly the file contract.
        Quantized records must already carry raw block bytes."""
        if isinstance(self.data, np.ndarray):
            if self.ttype not in _TTYPE_DTYPES:
                raise TypeError(
                    f"tensor '{self.name}': quantized records must carry "
                    "raw block bytes, not an ndarray")
            return np.ascontiguousarray(
                self.data, dtype=_TTYPE_DTYPES[self.ttype])
        return self.data

    def to_float32(self) -> np.ndarray:
        """Decode to float32 in torch orientation (dequantizing if needed)."""
        if isinstance(self.data, np.ndarray):
            return self.data.astype(np.float32, copy=False).reshape(self.shape)
        if self.ttype in _TTYPE_DTYPES:
            arr = np.frombuffer(self.data, dtype=_TTYPE_DTYPES[self.ttype])
            return arr.astype(np.float32).reshape(self.shape)
        vals = codecs.dequantize_blocks(self.data, self.ttype)
        return vals.reshape(self.shape)


def _read_i32(f: BinaryIO) -> int:
    raw = f.read(4)
    if len(raw) != 4:
        raise EOFError("unexpected end of file")
    return struct.unpack("<i", raw)[0]


def _read_str(f: BinaryIO) -> str:
    n = _read_i32(f)
    raw = f.read(n)
    if len(raw) != n:
        raise EOFError("unexpected end of file in string")
    return raw.decode("utf-8", errors="replace")


def read_header(f: BinaryIO) -> Tuple[BioGptConfig, Dict[str, int], List[Tuple[str, str]]]:
    """Read magic + hparams + vocab + merges; leaves `f` at the tensor section."""
    magic = _read_i32(f)
    if magic != GGML_MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x} (not a ggml model file)")
    n_vocab = _read_i32(f)
    n_layer = _read_i32(f)
    n_head = _read_i32(f)
    n_positions = _read_i32(f)
    d_ff = _read_i32(f)
    d_model = _read_i32(f)
    ftype = _read_i32(f)

    vocab_count = _read_i32(f)
    token_to_id: Dict[str, int] = {}
    for i in range(vocab_count):
        word = _read_str(f)
        token_to_id[word] = i
    # pad shortfall like the reference (biogpt.cpp:105-112)
    for i in range(vocab_count, n_vocab):
        token_to_id[f"[_extra_token_{i}]"] = i

    merges_count = _read_i32(f)
    merges: List[Tuple[str, str]] = []
    for _ in range(merges_count):
        entry = _read_str(f)
        first, _, second = entry.partition(" ")
        merges.append((first, second))

    config = BioGptConfig(
        n_vocab=n_vocab, n_merges=merges_count, d_ff=d_ff, d_model=d_model,
        n_layer=n_layer, n_head=n_head, n_positions=n_positions, ftype=ftype,
    )
    return config, token_to_id, merges


def iter_tensor_records(f: BinaryIO) -> Iterator[TensorRecord]:
    """Stream tensor records from the current position until EOF."""
    while True:
        peek = f.read(4)
        if len(peek) == 0:
            return
        if len(peek) != 4:
            raise EOFError("truncated tensor record")
        n_dims = struct.unpack("<i", peek)[0]
        name_len = _read_i32(f)
        ttype = _read_i32(f)
        if not (1 <= n_dims <= 4):
            raise ValueError(f"implausible n_dims={n_dims}")
        dims = [_read_i32(f) for _ in range(n_dims)]
        name = f.read(name_len).decode("utf-8")
        shape = tuple(reversed(dims))
        rec = TensorRecord(name=name, shape=shape, ttype=ttype, data=b"")
        nbytes = rec.nbytes_expected()
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise EOFError(f"tensor '{name}': expected {nbytes} bytes, got {len(data)}")
        rec.data = data
        yield rec


def read_model_file(path: str | Path):
    """Read a full model file.

    Returns (config, token_to_id, merges, {name: TensorRecord}).
    A file with zero tensors is allowed (vocab-only test files, matching
    the reference's warn-and-continue at biogpt.cpp:442-444).
    """
    with open(path, "rb") as f:
        config, token_to_id, merges = read_header(f)
        tensors = {rec.name: rec for rec in iter_tensor_records(f)}
    return config, token_to_id, merges, tensors


# ------------------------------------------------------------------ writing

def write_header(
    f: BinaryIO,
    config: BioGptConfig,
    token_to_id: Dict[str, int],
    merges: Iterable[Tuple[str, str]],
) -> None:
    f.write(struct.pack("<i", GGML_MAGIC))
    for v in (config.n_vocab, config.n_layer, config.n_head,
              config.n_positions, config.d_ff, config.d_model, config.ftype):
        f.write(struct.pack("<i", v))
    tokens = sorted(token_to_id.items(), key=lambda kv: kv[1])
    f.write(struct.pack("<i", len(tokens)))
    for token, _ in tokens:
        raw = token.encode("utf-8")
        f.write(struct.pack("<i", len(raw)))
        f.write(raw)
    merges = list(merges)
    f.write(struct.pack("<i", len(merges)))
    for first, second in merges:
        raw = f"{first} {second}".encode("utf-8")
        f.write(struct.pack("<i", len(raw)))
        f.write(raw)


def write_tensor_record(f: BinaryIO, rec: TensorRecord) -> None:
    name_raw = rec.name.encode("utf-8")
    dims = list(reversed(rec.shape))
    f.write(struct.pack("<iii", len(dims), len(name_raw), rec.ttype))
    for d in dims:
        f.write(struct.pack("<i", d))
    f.write(name_raw)
    f.write(rec.data_bytes())


def tensor_record_from_array(name: str, arr: np.ndarray, use_f16: bool = False) -> TensorRecord:
    """Build an f32/f16 record following convert.py's dtype policy:
    f16 only for 2-D ``*.weight`` tensors when requested (convert.py:60-71)."""
    arr = np.asarray(arr)
    if use_f16 and name.endswith(".weight") and arr.ndim == 2:
        data = arr.astype("<f2")
        ttype = codecs.GGML_TYPE_F16
    else:
        data = arr.astype("<f4")
        ttype = codecs.GGML_TYPE_F32
    return TensorRecord(name=name, shape=tuple(arr.shape), ttype=ttype,
                        data=data.tobytes())


def write_model_file(
    path: str | Path,
    config: BioGptConfig,
    token_to_id: Dict[str, int],
    merges: Iterable[Tuple[str, str]],
    tensors: Iterable[TensorRecord],
) -> None:
    with open(path, "wb") as f:
        write_header(f, config, token_to_id, merges)
        for rec in tensors:
            write_tensor_record(f, rec)
