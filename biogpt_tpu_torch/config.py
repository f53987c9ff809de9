"""Model and generation configuration.

Mirrors the reference hparams struct (``biogpt.h:25-35``) and
CLI parameter defaults (``biogpt.h:109-126``), re-expressed as
plain dataclasses. The hparams default to BioGPT-347M.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# ftype codes shared with the ggml file header (see modelio.ggml_format).
FTYPE_F32 = 0
FTYPE_F16 = 1
FTYPE_Q4_0 = 2
FTYPE_Q4_1 = 3
FTYPE_Q8_0 = 7
FTYPE_Q5_0 = 8
FTYPE_Q5_1 = 9

FTYPE_NAMES = {
    FTYPE_F32: "f32",
    FTYPE_F16: "f16",
    FTYPE_Q4_0: "q4_0",
    FTYPE_Q4_1: "q4_1",
    FTYPE_Q8_0: "q8_0",
    FTYPE_Q5_0: "q5_0",
    FTYPE_Q5_1: "q5_1",
}
FTYPE_BY_NAME = {v: k for k, v in FTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class BioGptConfig:
    """Transformer hyperparameters (defaults: BioGPT-347M).

    Field names follow the reference hparams struct; ``biogpt.h:25-35``.
    """

    n_vocab: int = 42384
    n_merges: int = 40000
    d_ff: int = 4096
    d_model: int = 1024
    n_layer: int = 24
    n_head: int = 16
    n_positions: int = 1024
    ftype: int = FTYPE_F32
    # Learned-position offset inherited from OPT: position id = pos + 2,
    # table has n_positions + 2 rows (reference biogpt.cpp:672).
    pos_offset: int = 2
    ln_eps: float = 1e-5

    @property
    def d_kv(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def tiny(cls, **overrides) -> "BioGptConfig":
        """A small config for tests."""
        base = dict(
            n_vocab=256, n_merges=0, d_ff=128, d_model=64, n_layer=2,
            n_head=4, n_positions=64,
        )
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass
class GenerationParams:
    """Generation/CLI parameters, defaults matching ``biogpt.h:109-126``."""

    seed: int = -1
    n_predict: int = 200
    top_k: int = 40
    top_p: float = 0.9
    temp: float = 0.9
    n_batch: int = 8        # prompt prefill chunk size in the reference
    lang: str = "en"
    model: str = "ggml-model.bin"
    prompt: str = ""
    verbosity: int = 0
    # Correct-by-default extensions over the reference:
    eos_token_id: Optional[int] = 2   # </s>; reference EOS check is broken (main.cpp:148)
    stop_at_eos: bool = True
