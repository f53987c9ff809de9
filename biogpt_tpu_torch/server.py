"""HTTP serving front end of the PyTorch/CUDA port (``biogpt_tpu/server.py``)
-- standard library only.

POST /generate with a JSON body:

    {"prompt": "COVID-19 is", "n_predict": 64,
     "temp": 0.7, "top_k": 40, "top_p": 0.9}       # sampling keys optional
    {"prompt_ids": [2, 431, ...], "n_predict": 8}  # pre-tokenized variant
    {..., "stream": true}                          # server-sent events

responds ``{"ids": [...], "new_ids": [...], "text": ...}`` (``text`` only
when the server has a tokenizer); a streamed request gets one ``data:``
event per generated token and a final ``done`` event with the result. GET
/healthz answers 200, GET /stats the serving counters. Requests from
concurrent clients batch together on the card through
:class:`~biogpt_tpu_torch.runtime.serving.ServingScheduler`: submissions
that arrive while a batch decodes join it at the next free slot.

Usage: python -m biogpt_tpu_torch.server -m ggml-model-q4_0.bin --port 8080
       (``--device cpu`` runs each kernel's plain PyTorch version)
"""

from __future__ import annotations

import argparse
import json
import queue as _queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .config import GenerationParams
from .runtime.serving import BatchedEngine, ServingScheduler
from .utils.logging import get_logger


class BioGptServer:
    """Bind a ServingScheduler (and an optional tokenizer) to an HTTP port."""

    def __init__(self, scheduler: ServingScheduler, tokenizer=None,
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 600.0):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                get_logger("server").debug(fmt, *args)

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True})
                elif self.path == "/stats":
                    self._json(200, outer.scheduler.stats())
                else:
                    self._json(404, {"error": "not found"})

            def _stream(self, ids, sampling):
                """Server-sent events: one ``data:`` line per generated token
                (tokens arrive in bursts as drains land), then a final done
                event with the whole result."""
                q: "_queue.Queue" = _queue.Queue()
                fut = outer.scheduler.submit(ids, on_token=q.put, **sampling)
                fut.add_done_callback(lambda f: q.put(None))

                def abort():   # a gone client must not keep a batch slot
                    outer.scheduler.abort(fut.request_id)

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                # once the headers are out, every failure ends inside the
                # stream: an error event if the socket still works
                try:
                    while True:
                        try:
                            tid = q.get(timeout=request_timeout_s)
                        except _queue.Empty:
                            abort()
                            self.wfile.write(
                                b'data: {"error": "timeout"}\n\n')
                            return
                        if tid is None:
                            break
                        ev = {"token_id": tid}
                        if outer.tokenizer is not None:
                            ev["piece"] = outer.tokenizer.id_to_token.get(
                                tid, "<unk>")
                        self.wfile.write(
                            f"data: {json.dumps(ev)}\n\n".encode())
                        self.wfile.flush()
                    result = fut.result()
                    done = {"done": True, "ids": result.ids,
                            "new_ids": result.new_ids}
                    if outer.tokenizer is not None:
                        done["text"] = outer.tokenizer.decode(result.ids)
                    self.wfile.write(f"data: {json.dumps(done)}\n\n".encode())
                except OSError:
                    abort()   # the client went away mid-stream
                except Exception as e:
                    try:
                        self.wfile.write(
                            f"data: {json.dumps({'error': str(e)})}\n\n"
                            .encode())
                    except OSError:
                        pass

            def do_POST(self):
                if self.path != "/generate":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if "prompt_ids" in body:
                        ids = [int(t) for t in body["prompt_ids"]]
                    elif "prompt" in body:
                        if outer.tokenizer is None:
                            self._json(400, {"error": "server has no "
                                             "tokenizer; send prompt_ids"})
                            return
                        ids = outer.tokenizer.encode(str(body["prompt"]))
                    else:
                        self._json(400, {"error": "need prompt or prompt_ids"})
                        return
                    sampling = dict(
                        n_predict=int(body.get("n_predict", 64)),
                        temp=(None if "temp" not in body
                              else float(body["temp"])),
                        top_k=(None if "top_k" not in body
                               else int(body["top_k"])),
                        top_p=(None if "top_p" not in body
                               else float(body["top_p"])))
                    if body.get("stream"):
                        self._stream(ids, sampling)
                        return
                    fut = outer.scheduler.submit(ids, **sampling)
                    try:
                        result = fut.result(timeout=request_timeout_s)
                    except Exception:
                        # timed out or failed: release the slot
                        outer.scheduler.abort(fut.request_id)
                        raise
                except json.JSONDecodeError:
                    self._json(400, {"error": "invalid JSON"})
                    return
                except Exception as e:   # timeout or engine failure
                    self._json(500, {"error": str(e)})
                    return
                payload = {"ids": result.ids, "new_ids": result.new_ids}
                if outer.tokenizer is not None:
                    payload["text"] = outer.tokenizer.decode(result.ids)
                self._json(200, payload)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Serve in a background thread (returns at once)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="biogpt-http", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop the HTTP thread, close the socket and the scheduler."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.scheduler.close()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="biogpt_tpu_torch.server",
                                description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", required=True, help="ggml-model .bin")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("-b", "--batch", type=int, default=16,
                   help="lockstep batch slots (the fused step takes 2..32)")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--temp", type=float, default=0.0,
                   help="default temperature (requests may override)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache with per-row f32 scales (half the KV "
                        "bytes of bf16)")
    p.add_argument("--kv-groups", type=int, default=None,
                   help="slot groups of the length-affine slot assignment "
                        "(default auto: 16 or 8 when the batch divides; "
                        "0 disables)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or the CPU, which runs "
                        "each kernel's plain PyTorch version")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from .modelio.checkpoint import load_params
    from .tokenizer import BioGptTokenizer

    try:
        config, vocab, merges, params = load_params(args.model, device="cpu")
    except FileNotFoundError:
        print(f"error: model file not found: {args.model}", file=sys.stderr)
        return 1
    tokenizer = BioGptTokenizer(vocab, merges)
    engine = BatchedEngine(config, params, max_batch=args.batch,
                           max_seq=args.max_seq, kv_quant=args.kv_quant,
                           kv_groups=args.kv_groups, device=args.device)
    # the kernels' builds and, on the card, the first chunk graphs
    engine.warmup()
    scheduler = ServingScheduler(engine, GenerationParams(temp=args.temp))
    server = BioGptServer(scheduler, tokenizer, host=args.host,
                          port=args.port)
    print(f"serving on http://{server.host}:{server.port} "
          f"(B={args.batch} slots, {engine.device})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
