"""Full-size golden outputs of BioGPT-347M over seeded random weights.

No real BioGPT checkpoint is reachable offline. The regression anchor is
deterministic random weights at the full 347M configuration
(``modelio.synthetic.make_state_dict(seed=7, scale=0.1)``: plain seeded
numpy, so the weights reproduce across library versions), written under
``tests/goldens/`` in three modes:

- the default mode loads them into HuggingFace ``BioGptForCausalLM`` and
  records its greedy continuation and logits (``hf347m_seed7.npz``), the
  parity oracle. It needs ``transformers``, imported inside it; where that
  is absent it exits 2.
- ``--quant`` records the Q4_0 and Q4_1 greedy continuations of the f32
  per-op path over unpacked planes (``own347m_seed7_quant.npz``),
  replayable on the CPU.
- ``--gpu-bf16`` records the production path's continuation on the card:
  bf16 compute, packed planes, the whole-model decode step and its fused
  greedy tail, the prompt's prefill and the decode chunks as
  ``Engine.generate`` runs them (``gpu347m_seed7_bf16.npz``), with the
  card's name and power limit as ``nvidia-smi`` gives them. It runs on the
  card or raises. ``python -m biogpt_tpu_torch.tools.check_goldens_gpu``
  replays it there. It locks the card's kernels against regressions and is
  no oracle: the kernels sum in their own orders, so neither the CPU's
  plain versions nor the TPU golden reproduce its ids.

Usage: python -m biogpt_tpu_torch.tools.make_goldens [out.npz]
       python -m biogpt_tpu_torch.tools.make_goldens --quant [out.npz]
       python -m biogpt_tpu_torch.tools.make_goldens --gpu-bf16 [out.npz]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

SEED = 7
SCALE = 0.1   # 0.02-scale weights collapse to a constant echo continuation
PROMPT = [2, 431, 88, 2901, 17, 1512, 40960, 233, 11, 5, 92, 1203]
N_NEW = 24
QTYPES = ("q4_0", "q4_1")
N_NEW_Q = 12      # tokens of the quantized continuations


def _goldens_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tests", "goldens")


def card_stamp() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def _state_dict(config=None) -> dict:
    from ..config import BioGptConfig
    from ..modelio.synthetic import make_state_dict

    return make_state_dict(config or BioGptConfig(), seed=SEED, scale=SCALE)


def _quant_engine(qname: str, compute_dtype, pack: bool, config=None,
                  device="cuda", state_dict=None):
    """An ``Engine`` over the seeded weights quantized to ``qname``: bf16
    and packed planes (``pack``) or f32 unpacked, 64 positions, at
    ``config`` (BioGPT-347M by default). ``state_dict``: the seeded
    weights at that config, where the caller has drawn them already."""
    import torch

    from ..config import BioGptConfig
    from ..modelio.checkpoint import params_from_state_dict
    from ..quant.codecs import GGML_TYPE_BY_NAME
    from ..runtime.engine import Engine

    config = config or BioGptConfig()
    sd = state_dict if state_dict is not None else _state_dict(config)
    params = params_from_state_dict(sd, config,
                                    qtype=GGML_TYPE_BY_NAME[qname],
                                    device=device)
    cache_dtype = None if pack else torch.float32
    return Engine(config, params, compute_dtype=compute_dtype,
                  cache_dtype=cache_dtype, max_seq=64, pack_q4=pack,
                  device=device)


def _write(out: str, data: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **data)
    print(f"wrote {out}")


def make_quant_goldens(out: str, config=None, device="cuda") -> int:
    """The quantized goldens of the f32 per-op path, unpacked planes
    (streamed one token a step, as the JAX tool runs it), on ``device``."""
    import torch

    from ..config import GenerationParams

    data = {"seed": np.int32(SEED), "scale": np.float32(SCALE),
            "prompt": np.asarray(PROMPT, np.int32)}
    gen = GenerationParams(n_predict=N_NEW_Q, temp=0.0, stop_at_eos=False)
    sd = _state_dict(config)
    for qname in QTYPES:
        eng = _quant_engine(qname, torch.float32, pack=False, config=config,
                            device=device, state_dict=sd)
        res = eng.generate(PROMPT, gen, stream_cb=lambda _: None)
        data[f"{qname}_greedy_ids"] = np.asarray(res.ids, np.int32)
        print(f"{qname}: {res.ids[len(PROMPT):]}")
    _write(out, data)
    return 0


def make_gpu_bf16_goldens(out: str) -> int:
    """The production path's goldens on the card: packed planes, bf16,
    the whole-model decode step; the continuation of one ``generate``
    (its prefill and decode chunks run eagerly on a fresh engine)."""
    import torch

    from ..config import GenerationParams

    if not torch.cuda.is_available():
        raise RuntimeError("--gpu-bf16 runs on the card (use --quant for "
                           "the goldens the CPU replays)")
    data = {"seed": np.int32(SEED), "scale": np.float32(SCALE),
            "prompt": np.asarray(PROMPT, np.int32), "device": card_stamp()}
    gen = GenerationParams(n_predict=N_NEW_Q, temp=0.0, stop_at_eos=False)
    sd = _state_dict()
    for qname in QTYPES:
        eng = _quant_engine(qname, torch.bfloat16, pack=True, state_dict=sd)
        if not eng._fused_decode:
            raise RuntimeError("the whole-model decode step must run for "
                               "this golden")
        res = eng.generate(PROMPT, gen)
        data[f"{qname}_greedy_ids"] = np.asarray(res.ids, np.int32)
        print(f"{qname} (bf16, packed, fused decode): "
              f"{res.ids[len(PROMPT):]}")
        del eng
    _write(out, data)
    return 0


def make_hf_goldens(out: str, config=None) -> int:
    """HuggingFace's greedy continuation (``N_NEW`` tokens) and its first
    and last logits over the seeded f32 weights."""
    # the golden is a torch model's: transformers need not load its
    # TensorFlow and Flax back ends (seconds of import each)
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    try:
        from transformers import BioGptConfig as HFConfig
        from transformers import BioGptForCausalLM
    except ImportError:
        print("error: the HF golden needs the transformers package "
              "(--quant and --gpu-bf16 do not)", file=sys.stderr)
        return 2
    import torch

    from ..config import BioGptConfig

    config = config or BioGptConfig()
    sd = _state_dict(config)
    hf_config = HFConfig(
        vocab_size=config.n_vocab,
        hidden_size=config.d_model,
        num_hidden_layers=config.n_layer,
        num_attention_heads=config.n_head,
        intermediate_size=config.d_ff,
        max_position_embeddings=config.n_positions,
        scale_embedding=True,
        activation_function="gelu",
        # HF ties output_projection to embed_tokens by default, which would
        # overwrite one of the two independent random tables
        tie_word_embeddings=False,
    )
    model = BioGptForCausalLM(hf_config).eval()
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert not unexpected, unexpected
    # HF may track non-parameter buffers; every actual weight must load
    assert all("bias" not in m and "weight" not in m for m in missing), missing

    ids = list(PROMPT)
    prefill_logits = None
    with torch.no_grad():
        for step in range(N_NEW):
            out_t = model(input_ids=torch.tensor([ids], dtype=torch.long))
            logits = out_t.logits[0, -1].numpy()
            if step == 0:
                prefill_logits = logits.copy()
            ids.append(int(logits.argmax()))
    _write(out, {"seed": np.int32(SEED), "scale": np.float32(SCALE),
                 "prompt": np.asarray(PROMPT, np.int32),
                 "greedy_ids": np.asarray(ids, np.int32),
                 "prefill_logits": prefill_logits.astype(np.float16),
                 "final_logits": logits.astype(np.float16)})
    print(f"greedy continuation {ids[len(PROMPT):]}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Write a 347M golden under tests/goldens/.")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--quant", action="store_true",
                      help="Q4_0/Q4_1 greedy ids, f32 per-op, unpacked")
    mode.add_argument("--gpu-bf16", action="store_true",
                      help="Q4_0/Q4_1 greedy ids of the card's production "
                      "path (bf16, packed, fused decode)")
    p.add_argument("out", nargs="?", default=None)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.quant:
        return make_quant_goldens(args.out or os.path.join(
            _goldens_dir(), f"own347m_seed{SEED}_quant.npz"))
    if args.gpu_bf16:
        return make_gpu_bf16_goldens(args.out or os.path.join(
            _goldens_dir(), f"gpu347m_seed{SEED}_bf16.npz"))
    return make_hf_goldens(args.out or os.path.join(
        _goldens_dir(), f"hf347m_seed{SEED}.npz"))


if __name__ == "__main__":
    sys.exit(main())
