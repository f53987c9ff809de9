"""Perplexity of a model file over a text: the Δppl harness of quantization.

    python -m biogpt_tpu_torch.tools.perplexity -m model.bin -f corpus.txt
        [--dtype f32|bf16] [--window 1024] [--stride N] [--device cuda|cpu]

Scores the text's tokens with full-sequence logits (``Engine.logits``) in
sliding windows and prints the token-level negative log-likelihood and
perplexity. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from ..modelio.checkpoint import load_params
from ..runtime.engine import Engine
from ..tokenizer import BioGptTokenizer


def perplexity_of_ids(engine: Engine, ids: list[int], window: int = 1024,
                      stride: int | None = None) -> dict:
    """Sliding-window perplexity over a token stream -> {"nll", "ppl",
    "tokens", "window_nll"} (``window_nll``: each scored window's mean nll).

    With stride < window, each window after the first scores only its last
    targets: those an earlier window scored are skipped
    (``window - stride - 1`` of them), so each token counts once. The
    log-softmax runs in f32 on the engine's device.
    """
    stride = stride or window
    total_nll = 0.0
    total_tokens = 0
    window_nll = []
    for start in range(0, max(len(ids) - 1, 1), stride):
        chunk = ids[start:start + window]
        if len(chunk) < 2:
            break
        # targets are positions start+1 .. start+len-1; skip the ones an
        # earlier window scored
        skip = 0 if start == 0 else max(window - stride - 1, 0)
        if skip >= len(chunk) - 1:
            continue
        logp = torch.log_softmax(engine.logits([chunk])[0], dim=-1)
        targets = torch.as_tensor(chunk[1:], device=logp.device)
        token_logp = logp[:-1].gather(1, targets[:, None])[skip:, 0]
        nll = float(-token_logp.sum())
        total_nll += nll
        total_tokens += token_logp.numel()
        window_nll.append(nll / token_logp.numel())
    nll = total_nll / max(total_tokens, 1)
    return {"nll": nll, "ppl": math.exp(nll), "tokens": total_tokens,
            "window_nll": window_nll}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Perplexity of a model file over a UTF-8 text.")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", required=True, help="UTF-8 text file to score")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="f32")
    p.add_argument("--window", type=int, default=1024)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    config, token_to_id, merges, params = load_params(args.model,
                                                      device=args.device)
    tokenizer = BioGptTokenizer(token_to_id, merges)
    # --dtype f32 scores with true f32 products, as the JAX tool's HIGHEST
    # precision does: TF32 stays off for matmuls (PyTorch's default, made
    # sure of here)
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = Engine(
        config, params,
        compute_dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
        device=args.device)

    with open(args.file, encoding="utf-8") as f:
        text = f.read()
    ids = tokenizer.encode(text)
    window = min(args.window, config.n_positions)
    stats = perplexity_of_ids(engine, ids, window=window, stride=args.stride)
    print(f"tokens={stats['tokens']} nll={stats['nll']:.6f} "
          f"ppl={stats['ppl']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
