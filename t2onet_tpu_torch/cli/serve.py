"""Serving entry point: batched editing over HTTP or as a one-shot bench
(counterpart of `t2onet_tpu.cli.serve`).

A ServingEngine (t2onet_tpu_torch/serve.py) decodes micro-batched
requests at a fixed probe resolution and executes the programs at
native resolution with the chain kernel.

  # throughput self-test (synthetic requests, no files needed)
  python -m t2onet_tpu_torch.cli.serve --synthetic --bench 64 --img_size 512

  # HTTP server:  POST /edit  {"request": "...", "image_b64": <png/jpg>}
  #               -> {"image_b64": <png>, "ops": [...], "params": [...]}
  python -m t2onet_tpu_torch.cli.serve --synthetic --port 8787

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import time

import numpy as np

from t2onet_tpu_torch.cli import common


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    common.add_base_args(p)
    p.add_argument("--port", type=int, default=0,
                   help="serve HTTP on this port (0 = bench/one-shot only)")
    p.add_argument("--bench", type=int, default=0,
                   help="run N synthetic requests and print throughput")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--decode_size", type=int, default=128)
    p.add_argument("--linger_ms", type=float, default=10.0)
    p.add_argument("--decode_native", action="store_true",
                   help="decode at native bucket resolution (the "
                        "reference's programs)")
    p.add_argument("--no_pallas", action="store_true",
                   help="execute through the bank, step by step, instead "
                        "of the chain kernel")
    p.add_argument("--io_threads", type=int, default=8,
                   help="threads that wait on launched micro-batches and "
                        "assemble their results (1 = the caller, serially)")
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="launched-but-unread micro-batches the HTTP "
                        "batcher keeps in flight")
    return p


def build_engine(a):
    """The engine of the run dir's best L1 checkpoint (a warning and the
    seeded random init without one)."""
    from t2onet_tpu_torch.serve import ServingEngine
    from t2onet_tpu_torch.train.checkpoint import restore_actor

    device = common.resolve_device(a.device)
    _, vocab2id, _, w2v = common.build_dataset_and_vocab(a, "test")
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    ckpt_dir = os.path.join(common.resolve_run_dir(a, record=False),
                            "seq2seqL1_model")
    if os.path.exists(os.path.join(ckpt_dir, "checkpoint_best.pt")):
        restore_actor(actor, ckpt_dir, "best")
        print(f"loaded checkpoint from {ckpt_dir}")
    else:
        print("WARNING: no checkpoint — using random init")
    return ServingEngine(
        actor, vocab2id, device=device, decode_size=a.decode_size,
        max_batch=a.max_batch, decode_native=a.decode_native,
        encoder_max_len=a.encoder_max_len, use_pallas=not a.no_pallas,
        io_threads=a.io_threads)


def run_bench(engine, n: int, size: int):
    """n synthetic requests at size² through edit_batch: one JSON line of
    req/s with the engine's stats and `device_compute_probe`."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    reqs, imgs = [], []
    texts = ["increase the brightness", "improve contrast",
             "increase saturation", "sharpen the image"]
    for i in range(n):
        imgs.append(np.clip(
            np.stack([x, y, 0.5 * (x + y)], 0)
            + rng.uniform(-0.2, 0.2, (3, size, size)).astype(np.float32),
            0, 1))
        reqs.append(texts[i % len(texts)])
    engine.warmup(buckets=[(size, size)])
    t0 = time.time()
    results = engine.edit_batch(imgs, reqs)
    dt = time.time() - t0
    if any(r is None for r in results):
        raise RuntimeError("the bench lost a request")
    st = engine.stats_snapshot()
    probe = engine.device_compute_probe(size=size)
    line = {
        "metric": f"{size}px serving requests/sec/chip",
        "value": round(n / dt, 2),
        "unit": "req/s",
        "detail": {
            "n": n, "batch": engine.max_batch,
            "io_threads": engine.io_threads,
            "launch_s": round(st["launch_s"], 3),
            "sync_s": round(st["sync_s"], 3),
            "mean_program_len": float(np.mean(
                [len(r.ops) for r in results])),
            "device_compute": probe,
        },
    }
    print(json.dumps(line))
    return line


def _png_b64(img_chw: np.ndarray) -> str:
    from PIL import Image

    arr = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1)
           * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_b64(image_b64: str) -> np.ndarray:
    from PIL import Image

    raw = base64.b64decode(image_b64)
    img = Image.open(io.BytesIO(raw)).convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def make_http_handler(engine):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):          # quiet access log
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "stats": engine.stats_snapshot()})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/edit":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                img = _decode_b64(req["image_b64"])
                pending = engine.submit(img, req.get("request", ""))
                if not pending.done.wait(timeout=120):
                    self._reply(504, {"error": "timed out"})
                    return
                if pending.error is not None:
                    self._reply(500, {"error": str(pending.error)})
                    return
                r = pending.result
                self._reply(200, {
                    "image_b64": _png_b64(r.image),
                    "ops": r.ops, "params": r.params,
                    "latency_s": round(r.latency_s, 4),
                })
            except Exception as e:  # noqa: BLE001 — serving boundary
                self._reply(400, {"error": str(e)})

    return Handler


def make_server(engine, port: int, linger_ms: float = 10.0,
                pipeline_depth: int = 2):
    """(ThreadingHTTPServer on 127.0.0.1:port, its started MicroBatcher);
    port 0 takes a free one (server.server_address[1])."""
    from http.server import ThreadingHTTPServer

    from t2onet_tpu_torch.serve import MicroBatcher

    batcher = MicroBatcher(engine, linger_ms=linger_ms,
                           pipeline_depth=pipeline_depth).start()
    try:
        server = ThreadingHTTPServer(("127.0.0.1", port),
                                     make_http_handler(engine))
    except OSError:
        batcher.stop()
        raise
    return server, batcher


def main(argv=None):
    a = build_parser().parse_args(argv)
    engine = build_engine(a)
    if a.bench:
        run_bench(engine, a.bench, a.img_size)
    if a.port:
        server, batcher = make_server(engine, a.port, a.linger_ms,
                                      a.pipeline_depth)
        print(f"serving on http://127.0.0.1:{a.port}  "
              f"(POST /edit, GET /healthz)", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            batcher.stop()
            server.server_close()
    return engine


if __name__ == "__main__":
    main()
