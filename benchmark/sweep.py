"""The knee of a serving cell: the highest offered rate at which the
queue does not grow over the window, found once by a sweep on the card,
whose result goes into the mix's file as a number.

    python3 benchmark/sweep.py --workload fivek_serve_bulk \\
        --seed 7 --seconds 10 --rates 60 80 100 120

One process: the engine is set up once, then each rate runs an open loop
of `--seconds` with the mix's traffic at that rate, and a closed loop of
`--clients` requests in flight ends the sweep. Each prints a
JSON line: the offered and completed rates, the median and 95th
percentile latency, and the median latency of the last quarter of the
requests (by due time) against the first quarter's: a queue that grows
makes the last quarter wait longer. `--clients 0` leaves the closed
loop out.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
os.environ["T2ONET_TORCH_BUILD_DIR"] = os.path.join(HERE, "_build")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--clients", type=int, default=64)
    a = p.parse_args(argv)
    import numpy as np
    import torch

    from benchmark.drivers import serve
    from benchmark.harness import Run
    from benchmark.traffic import Traffic, quantile
    from benchmark.weights import serving_weights

    run = Run(argparse.Namespace(workload=a.workload, seed=a.seed,
                                 seconds=a.seconds, trace=0), time.time())
    vocab2id = run.vocab()
    W = serving_weights(run.model_config(), len(vocab2id), a.seed, "cuda",
                        run.traffic)
    engine, batcher = serve._program(run, W, vocab2id)
    try:
        for k, rate in enumerate(a.rates):
            mix = dict(run.traffic, loop="open", rate_per_s=rate)
            traffic = Traffic(mix, ROOT, a.seed + k, a.seconds)
            if k == 0:
                serve._warm(engine, traffic, mix["engine"]["max_batch"])
                gc.collect()
                gc.freeze()
            rec = {"late_s": []}
            serve._open_loop(engine, traffic, a.seconds, rec, lambda t: None)
            lat = rec["latencies_s"]
            q = max(len(lat) // 4, 1)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat),
                "completed_per_s": sum(1 for _, _, t in rec["done"]
                                       if t <= rec["t1"]) / a.seconds,
                "p50_ms": quantile(lat, 0.5) * 1e3,
                "p95_ms": quantile(lat, 0.95) * 1e3,
                "p95_ms_by_quarter": [
                    quantile(lat[k * q:(k + 1) * q], 0.95) * 1e3
                    for k in range(4)],
                "first_quarter_p50_ms": float(np.median(lat[:q])) * 1e3,
                "last_quarter_p50_ms": float(np.median(lat[-q:])) * 1e3,
                "late_p99_ms": float(np.percentile(rec["late_s"], 99)) * 1e3,
                "failed": rec["failed"]}), flush=True)
        if a.clients <= 0:
            return
        mix = dict(run.traffic, loop="closed", requests_per_run=20000)
        traffic = Traffic(mix, ROOT, a.seed, a.seconds)
        rec = {}
        serve._closed_loop(engine, traffic, a.seconds, a.clients, 2.0, rec,
                           lambda now: rec.update(t0=now), lambda t: None)
        n = sum(1 for _, _, t in rec["done"] if t <= rec["t1"])
        print(json.dumps({"closed_clients": a.clients,
                          "completed_per_s": n / (rec["t1"] - rec["t0"])}),
              flush=True)
    finally:
        batcher.stop()
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
