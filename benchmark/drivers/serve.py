"""Serving cells: the system's `MicroBatcher` over its `ServingEngine`,
driven by an open loop (requests due on a schedule) or a closed loop (a
fixed number of requests in flight), from one client thread.

Set-up: the actor with the seed's weights, the engine and the batcher
as the mix configures them, the traffic, and one micro-batch of every
size up to `max_batch` in every bucket the mix uses, through the
batcher. Set-up ends with a collection and `gc.freeze()`, so that the
collector's passes inside the window do not walk set-up's objects. A
closed loop then runs `ramp_s` before its window opens.

The window: an open loop sends each request at its due time and times it
from then to the moment its edited image was assembled; when the window
closes the run waits for every request that was due in it. A closed
loop keeps `clients` requests in flight and counts those assembled
inside the window. The engine's counters are read at both ends.

After the window the reference judges a sample of the served answers
drawn from the seed, the longest programs always in it
(`check_serve.judge`).
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from benchmark import check_serve, flops
from benchmark.reference import model as RM
from benchmark.traffic import Traffic, quantile
from benchmark.weights import serving_weights

WAIT_AFTER_CLOSE_S = 60.0
# the closed loop's client wakes at least this often, for the window's
# ends and the traced stretch
CLIENT_WAKE_S = 0.05


def _program(ctx, W, vocab2id):
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.models.actor import Actor
    from t2onet_tpu_torch.serve import MicroBatcher, ServingEngine

    model = ctx.model_config()
    actor = Actor(ModelConfig(**model), OperatorConfig(**ctx.op_config()),
                  len(vocab2id), generator=torch.Generator().manual_seed(0),
                  explore_prob=ctx.config["explore_prob"])
    actor.load_state_dict(W, strict=True)
    mix = ctx.traffic
    engine = ServingEngine(actor, vocab2id, device=ctx.device,
                           encoder_max_len=model["encoder_max_len"],
                           **mix["engine"])
    batcher = MicroBatcher(engine, linger_ms=mix["linger_ms"],
                           pipeline_depth=mix["pipeline_depth"]).start()
    return engine, batcher


def _warm(engine, traffic, max_batch):
    """One micro-batch of each size in each of the mix's shapes."""
    text = traffic.requests[0][3]
    for pool in traffic.images_f32:
        for n in range(1, max_batch + 1):
            handles = [engine.submit(pool[0], text) for _ in range(n)]
            for h in handles:
                h.done.wait()
                if h.error is not None:
                    raise h.error


def _done_time(p):
    return p.t_submit + p.result.latency_s


def _open_loop(engine, traffic, seconds, rec, tick):
    t0 = time.time()
    sent = []
    for i, (due, _, _, text) in enumerate(traffic.requests):
        t_due = t0 + due
        tick(time.time() - t0)
        wait = t_due - time.time()
        if wait > 0:
            time.sleep(wait)
        rec["late_s"].append(max(time.time() - t_due, 0.0))
        sent.append((i, t_due, engine.submit(traffic.image_f32(i), text)))
    _wait_until(t0 + seconds, lambda: tick(time.time() - t0))
    t1 = time.time()
    deadline = t1 + WAIT_AFTER_CLOSE_S
    for _, _, p in sent:
        p.done.wait(max(deadline - time.time(), 0.0))
    lat, done = [], []
    for i, t_due, p in sent:
        if p.done.is_set() and p.error is None and p.result is not None:
            lat.append(_done_time(p) - t_due)
            done.append((i, p.result, _done_time(p)))
        else:
            lat.append(float("inf"))
    rec.update(t0=t0, t1=t1, latencies_s=lat, done=done,
               attempted=len(sent), failed=len(sent) - len(done))
    return rec


def _closed_loop(engine, traffic, seconds, clients, ramp_s, rec, on_open,
                 tick):
    n_req = len(traffic.requests)
    nxt = 0
    flight = deque()
    finished = []

    def send():
        nonlocal nxt
        i = nxt % n_req
        nxt += 1
        flight.append((i, engine.submit(traffic.image_f32(i),
                                        traffic.requests[i][3])))

    for _ in range(clients):
        send()
    t_open = time.time() + ramp_s
    opened = False
    while True:
        now = time.time()
        if not opened and now >= t_open:
            opened = True
            on_open(now)
        if opened:
            if now >= rec["t0"] + seconds:
                break
            tick(now - rec["t0"])
        # Sleep until the oldest request in flight is answered: answers
        # come back a taken group at a time, oldest group first. Polling
        # instead took the GIL from the batcher's launches every few ms.
        flight[0][1].done.wait(CLIENT_WAKE_S)
        for _ in range(len(flight)):
            i, p = flight.popleft()
            if p.done.is_set():
                finished.append((i, p))
                send()
            else:
                flight.append((i, p))
    t1 = time.time()
    deadline = t1 + WAIT_AFTER_CLOSE_S
    for _, p in flight:
        p.done.wait(max(deadline - time.time(), 0.0))
    finished.extend(flight)
    ok = [(i, p.result, _done_time(p)) for i, p in finished
          if p.done.is_set() and p.error is None and p.result is not None]
    rec.update(t1=t1, done=[d for d in ok if d[2] >= rec["t0"]],
               attempted=len(finished), failed=len(finished) - len(ok))
    return rec


def _wait_until(t, tick):
    while True:
        tick()
        left = t - time.time()
        if left <= 0:
            return
        time.sleep(min(left, 0.01))


def run(ctx):
    mix, cell = ctx.traffic, ctx.cell
    device = torch.device(ctx.device)
    vocab2id = ctx.vocab()
    model = ctx.model_config()
    ctx.phase("imports")
    W = serving_weights(model, len(vocab2id), ctx.seed, device, mix)
    ctx.phase("weights")
    engine, batcher = _program(ctx, W, vocab2id)
    ctx.phase("actor and engine")
    traffic = Traffic(mix, ctx.root, ctx.seed, ctx.seconds)
    ctx.phase("traffic")
    max_batch = mix["engine"]["max_batch"]
    rec = {"late_s": []}
    snap = {}
    try:
        _warm(engine, traffic, max_batch)
        ctx.sync()
        # what set-up left stays out of the collector's later passes
        gc.collect()
        gc.freeze()
        ctx.phase("warm-up")

        def on_open(now):
            rec["t0"] = now
            snap["stats0"] = engine.stats_snapshot()
            ctx.mark_setup_done()

        if mix["loop"] == "open":
            on_open(time.time())
            _open_loop(engine, traffic, ctx.seconds, rec, ctx.trace_tick)
        else:
            _closed_loop(engine, traffic, ctx.seconds, mix["clients"],
                         mix["ramp_s"], rec, on_open, ctx.trace_tick)
        ctx.finish_trace()
        stats1 = engine.stats_snapshot()
    finally:
        batcher.stop()
    ctx.sync()
    ctx.read_memory_peak()

    t0, t1 = rec["t0"], rec["t1"]
    in_window = [(i, res) for i, res, t in rec["done"] if t0 <= t <= t1]
    window_flops = 0.0
    for i, res in in_window:
        h, w = traffic.image(i).shape[1:]
        slots = [check_serve.OP_IDS[n] - 2 for n in res.ops]
        window_flops += flops.serve_request(
            model, int(np.count_nonzero(_tokens(traffic, i, vocab2id,
                                                model))),
            slots, h, w, mix["engine"]["decode_size"])
    stats0 = snap["stats0"]
    ctx.readings.update(
        window_s=t1 - t0, latencies_s=rec.get("latencies_s"),
        completed=len(in_window), model_flops=window_flops,
        batches=stats1["batches"] - stats0["batches"],
        batch_requests=stats1["requests"] - stats0["requests"],
        max_batch=max_batch, launch_s=stats1["launch_s"] - stats0["launch_s"])
    lat = rec.get("latencies_s")
    if lat:
        q = len(lat) // 4
        ctx.note("p95 ms by quarter of the window: " + ", ".join(
            f"{quantile(lat[k * q:(k + 1) * q], 0.95) * 1e3:.1f}"
            for k in range(4)))
    late = rec["late_s"]
    if late:
        ctx.note(f"generator lateness: median {np.median(late) * 1e3:.3f} "
                 f"ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, max "
                 f"{max(late) * 1e3:.3f} ms over {len(late)} requests")
    failed = rec["failed"]

    # -- correctness: the engine is stopped and its state freed first ----
    del engine, batcher
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    done = [(i, res) for i, res, _ in rec["done"]]
    sample = _sample(done, cell["check"]["requests"], ctx.seed)
    answers = [(res.ops, res.params,
                np.round(res.image * 255.0).astype(np.uint8))
               for _, res in sample]
    RM.set_precision("f32", device)
    numbers = check_serve.judge(
        answers, [traffic.requests[i][3] for i, _ in sample],
        [traffic.image(i) for i, _ in sample], W, model, ctx.op_config(),
        vocab2id, mix["engine"], device, failed)
    ctx.readings["checked"] = len(sample)
    return {"attempted": rec["attempted"], "failed": failed,
            "numbers": numbers}


def _tokens(traffic, i, vocab2id, model):
    from benchmark.reference.text import tokenize

    return tokenize(traffic.requests[i][3], vocab2id,
                    model["encoder_max_len"])


def _sample(done, n, seed):
    """Up to n of the answered requests, drawn from the seed: a quarter
    of them the longest programs, the rest at random."""
    if len(done) <= n:
        return list(done)
    rng = np.random.default_rng(seed + 1)
    order = [int(k) for k in rng.permutation(len(done))]
    longest = sorted(order, key=lambda k: -len(done[k][1].ops))[:n // 4]
    taken = set(longest)
    rest = [k for k in order if k not in taken][:n - len(longest)]
    return [done[k] for k in sorted(longest + rest)]
