"""Generation CLI of the PyTorch/CUDA port.

Same flags and defaults as ``python -m biogpt_tpu.cli`` (the reference
``biogpt`` binary's flags, with ``-l`` really setting the language and
generation stopping at ``</s>``), plus ``--device`` (default ``cuda``).

Usage: python -m biogpt_tpu_torch.cli -m ggml-model.bin -p "COVID-19 is" -n 128
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .config import GenerationParams
from .modelio.checkpoint import load_params
from .runtime.engine import Engine
from .runtime.health import ModelHealthError, check_params_finite
from .tokenizer import BioGptTokenizer
from .utils.logging import get_logger, set_verbosity
from .utils.profiling import Timer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="biogpt_tpu_torch", description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", default="ggml-model.bin", help="model path")
    p.add_argument("-p", "--prompt", default="", help="prompt to start generation with")
    p.add_argument("-s", "--seed", type=int, default=-1, help="RNG seed (default: -1 = time)")
    p.add_argument("-n", "--n_predict", type=int, default=200, help="number of tokens to predict")
    p.add_argument("-l", "--lang", default="en", help="language of the prompt")
    p.add_argument("--top_k", type=int, default=40, help="top-k sampling")
    p.add_argument("--top_p", type=float, default=0.9, help="top-p sampling")
    p.add_argument("--temp", type=float, default=0.9, help="temperature (0 = greedy)")
    p.add_argument("-b", "--batch_size", type=int, default=8,
                   help="accepted for reference compatibility (prefill is bucketed)")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="accepted for reference compatibility")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype (f32 for parity work)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or the CPU, which runs "
                        "each kernel's plain PyTorch version")
    p.add_argument("--no-stop-at-eos", action="store_true",
                   help="reference-compat: never stop at </s>")
    p.add_argument("--stream", action="store_true",
                   help="print tokens as they are sampled (one device read "
                        "per token)")
    p.add_argument("--warmup", type=int, default=0, metavar="N",
                   help="run N warmup tokens first (kernel builds, "
                        "allocator, the first decode graphs)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache with per-row f32 scales (half the KV "
                        "bytes of bf16)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    set_verbosity(args.verbosity)
    log = get_logger("cli")

    timer = Timer()
    t_start = time.perf_counter()
    with timer.phase("load"):
        try:
            # planes load on the host; the engine packs them and moves
            # them to the device
            config, token_to_id, merges, params = load_params(
                args.model, device="cpu")
        except FileNotFoundError:
            print(f"error: failed to open '{args.model}': no such file",
                  file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"error: failed to load model from '{args.model}': {e}",
                  file=sys.stderr)
            return 1
        tokenizer = BioGptTokenizer(token_to_id, merges, lang=args.lang)
        try:
            check_params_finite(params, name=args.model)
        except ModelHealthError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    log.info(
        "model: %s d_model=%d n_layer=%d n_head=%d n_vocab=%d ftype=%d",
        args.model, config.d_model, config.n_layer, config.n_head,
        config.n_vocab, config.ftype)

    engine = Engine(
        config, params,
        compute_dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
        kv_quant=args.kv_quant, device=args.device)

    gen = GenerationParams(
        seed=args.seed, n_predict=args.n_predict, top_k=args.top_k,
        top_p=args.top_p, temp=args.temp, lang=args.lang,
        stop_at_eos=not args.no_stop_at_eos)

    if args.warmup > 0:
        # on the card: the kernels' builds, the allocator, and the decode
        # chunks' graphs of the first KV window
        engine.warmup(n_tokens=args.warmup, sampled=args.temp > 0,
                      top_k=args.top_k)

    prompt_ids = tokenizer.encode(args.prompt)
    print(f"prompt: '{args.prompt}'", file=sys.stderr)
    print(f"number of tokens in prompt = {len(prompt_ids)}, first 8 tokens: "
          f"{prompt_ids[:8]}", file=sys.stderr)

    def stream(tok_id: int) -> None:
        piece = tokenizer.id_to_token.get(tok_id, "<unk>")
        print(piece.replace("</w>", " ").replace("</s>", ""), end="", flush=True)

    if len(prompt_ids) >= min(engine.max_seq, config.n_positions):
        print(f"error: prompt is {len(prompt_ids)} tokens but the context "
              f"window holds {min(engine.max_seq, config.n_positions)} -- "
              "no room to generate", file=sys.stderr)
        return 1

    try:
        result = engine.generate(prompt_ids, gen,
                                 stream_cb=stream if args.stream else None)
    except ModelHealthError as e:
        if args.stream:
            print()
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.stream:
        print()

    text = tokenizer.decode(result.ids)
    print("\n--- detokenized ---", file=sys.stderr)
    print(text)

    t_total = time.perf_counter() - t_start
    t = result.timings
    print(file=sys.stderr)
    print(f"    load time = {timer.ms('load'):8.2f} ms", file=sys.stderr)
    if t:
        print(f" prefill time = {t['prefill_s'] * 1e3:8.2f} ms", file=sys.stderr)
        print(f"  sample time = {t['sample_s'] * 1e3:8.2f} ms", file=sys.stderr)
        print(f" predict time = {t['decode_s'] * 1e3:8.2f} ms / "
              f"{t['ms_per_token']:.2f} ms per token", file=sys.stderr)
    print(f"   total time = {t_total * 1e3:8.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
