"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: a CUDA card of compute capability 9.0, with TF32 off for
   matmuls and cuDNN convolutions so that f32 means f32;
2. build: the chain kernel from t2onet_tpu_torch/csrc/ with nvcc;
3. kernel against plain: the chain kernel and its plain PyTorch version on
   the same tensors on the card, at the serving shapes and at the chain
   benchmark's (bench.py's draw: b128, 512 px, K5), max abs error
   <= 1e-5 (both round every multiply and add alone, in the same order),
   then both timed with CUDA events;
4. serve: a full-width actor (ModelConfig() defaults, 918-token
   vocabulary, seeded random weights) behind ServingEngine on the card:
   32 requests over two shape buckets with the launch counters read
   around the run, two of them again on the CPU for parity, then the
   request rate over 64 requests at 512 px.

The last three lines of stdout are the kernels JSON line, the card's
name and power limit from nvidia-smi, and {"ok": true, "device": ...}.
Imports nothing of JAX and nothing of the JAX package.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from t2onet_tpu_torch.config import (FIVEK_VOCAB_SIZE, ModelConfig,
                                     OperatorConfig)
from t2onet_tpu_torch.data.text import parse_sent
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.ops import chain
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.serve import ServingEngine

CHAIN_ATOL = 1e-5
TEXTS = ["increase the brightness", "improve contrast",
         "increase saturation", "sharpen the image"]   # cli/serve.py's


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- phase 1 ------------------------------------------------------------------
def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}, compute capability {cap}, "
        f"{torch.cuda.device_count()} card(s); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    return smi


# -- phase 2 ------------------------------------------------------------------
def build_phase():
    t0 = time.perf_counter()
    so = chain.build()
    chain._library()
    log(f"build: {so} in {time.perf_counter() - t0:.2f} s")
    for line in chain.BUILD_LOG.get("output", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


# -- phase 3 ------------------------------------------------------------------
def bench_workload(batch=128, size=512, steps=5, seed=0):
    """bench.py:build_workload's draw (same rng calls), plus forced cases:
    a chain with two sharpness steps, one with slots 0 and 5, and exact
    0 / 0.5 / 1 patches."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    base = np.stack([x, y, 0.5 * (x + y)], 0)
    imgs = np.clip(base[None] + rng.uniform(-0.2, 0.2, (batch, 3, size, size))
                   .astype(np.float32), 0, 1)
    vocab_ids = rng.choice([3, 4, 5, 6, 8, 9], size=(batch, steps))
    params = rng.uniform(0.1, 0.6, size=(batch, steps, 24)).astype(np.float32)
    slots = np.where(vocab_ids < 3, 0, vocab_ids - 2).astype(np.int32)
    slots[0] = [7, 1, 7, 4, 6]
    slots[1] = [0, 2, 5, 3, 0]
    for v, (r0, r1) in ((0.0, (0, 64)), (0.5, (64, 128)), (1.0, (128, 192))):
        imgs[:5, :, r0:r1, :96] = v
    return imgs, slots, params


def random_case(b, h, w, k=5, seed=1, identity=False):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32)
    pool = [0, 5] if identity else [0, 1, 2, 3, 4, 5, 6, 7, 8]
    slots = rng.choice(pool, size=(b, k)).astype(np.int32)
    params = rng.uniform(0.1, 0.6, (b, k, 24)).astype(np.float32)
    return imgs, slots, params


def to_card(*arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def max_err(out, ref):
    if not torch.equal(torch.isnan(out), torch.isnan(ref)):
        return float("nan")
    d = (out - ref).abs()
    return float(torch.nan_to_num(d, nan=0.0).max())


def time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def kernel_phase():
    cases = {
        "bench b128 512x512 K5": bench_workload(),
        "serve b8 512x512 K5": random_case(8, 512, 512, seed=2),
        "serve b8 384x640 K5": random_case(8, 384, 640, seed=3),
        "1x64x1024": random_case(1, 64, 1024, seed=4),
        "3x320x448": random_case(3, 320, 448, seed=5),
        "2x33x97": random_case(2, 33, 97, seed=6),
        "identity 4x128x128": random_case(4, 128, 128, seed=7, identity=True),
    }
    worst = 0.0
    for name, arrays in cases.items():
        args = to_card(*arrays)
        out = chain.fused_chain(*args)
        torch.cuda.synchronize()
        ref = chain.fused_chain_reference(*args)
        err = max_err(out, ref)
        log(f"chain vs plain [{name}]: max abs err {err:.3e}")
        if not err <= CHAIN_ATOL:
            fail(f"chain kernel disagrees with its plain version on {name}: "
                 f"{err} > {CHAIN_ATOL}")
        if name.startswith("identity") and not torch.equal(out, args[0]):
            fail("an all-identity chain changed the image")
        worst = max(worst, err)

    imgs, slots, params = to_card(*cases["bench b128 512x512 K5"])
    b, k = slots.shape

    def kern():
        chain.fused_chain(imgs, slots, params)

    def plain():
        chain.fused_chain_reference(imgs, slots, params)

    # in turns, so drift in clocks or power hits both alike
    p1 = time_ms(plain)
    k1 = time_ms(kern)
    k2 = time_ms(kern)
    p2 = time_ms(plain)
    kernel_ms = statistics.median(k1 + k2)
    plain_ms = statistics.median(p1 + p2)
    log(f"chain b{b} 512x512 K{k}: kernel {kernel_ms:.4f} ms "
        f"({b * k / kernel_ms * 1e3:.1f} op-applications/s), plain "
        f"{plain_ms:.4f} ms ({b * k / plain_ms * 1e3:.1f} op-applications/s)"
        f"; medians of 2x20 calls after 3 warm-ups")
    hbm = 2 * imgs.numel() * 4
    log(f"  kernel moves {hbm / 1e6:.1f} MB of device memory: "
        f"{hbm / kernel_ms / 1e6:.1f} GB/s")
    serve_args = to_card(*cases["serve b8 512x512 K5"])
    serve_ms = statistics.median(time_ms(lambda: chain.fused_chain(
        *serve_args)))
    log(f"chain b8 512x512 K5 (serving micro-batch): kernel {serve_ms:.4f} ms")
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms}


# -- phase 4 ------------------------------------------------------------------
def make_vocab():
    """918 tokens: the 4 specials, the requests' words, then filler."""
    words = []
    for t in TEXTS:
        words += [w for w in parse_sent(t) if w not in words]
    toks = ["<NONE>", "<START>", "<END>", "<UNK>"] + words
    toks += [f"filler{i}" for i in range(FIVEK_VOCAB_SIZE - len(toks))]
    return {t: i for i, t in enumerate(toks)}


def make_images(n, h, w, seed):
    """cli/serve.py's synthetic requests: a gradient plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y, x = y / max(h - 1, 1), x / max(w - 1, 1)
    base = np.stack([x, y, 0.5 * (x + y)], 0)
    return [np.clip(base + rng.uniform(-0.2, 0.2, (3, h, w))
                    .astype(np.float32), 0, 1) for _ in range(n)]


def serve_phase():
    vocab = make_vocab()
    cfg = ModelConfig()
    t0 = time.perf_counter()
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # curve knots near 1 as a trained model's (tone range 0.5-2,
        # color 0.9-1.1); random heads put them near 0, where the curve's
        # division by the knot sum magnifies rounding
        actor.executor.color_op.fc2.bias += 1.0
        actor.executor.tone_op.fc2.bias += 1.0
    actor_cpu = copy.deepcopy(actor)
    n_params = sum(p.numel() for p in actor.parameters())
    log(f"actor: ModelConfig() full width, {n_params} parameters, vocab "
        f"{len(vocab)}, built in {time.perf_counter() - t0:.2f} s")
    kw = dict(decode_size=128, max_batch=8, u8_wire=True,
              encoder_max_len=cfg.encoder_max_len)
    engine = ServingEngine(actor, vocab, device="cuda", **kw)

    imgs = make_images(24, 512, 512, seed=0) + make_images(8, 384, 640, 1)
    reqs = [TEXTS[i % len(TEXTS)] for i in range(len(imgs))]

    chain.LAUNCHES["chain"] = 0
    t0 = time.perf_counter()
    results = engine.edit_batch(imgs, reqs)
    first_s = time.perf_counter() - t0
    launches = chain.LAUNCHES["chain"]
    batches = engine.stats["batches"]
    log(f"serve: {len(results)} requests in {batches} micro-batches, first "
        f"run {first_s:.3f} s; chain launches {launches}")
    if launches == 0 or launches != batches or batches != 4:
        fail(f"chain kernel launched {launches} times over {batches} "
             f"micro-batches (want 4 and 4)")
    lens = []
    for im, r in zip(imgs, results):
        if r is None:
            fail("a request got no result")
        if r.image.shape != im.shape or not np.isfinite(r.image).all():
            fail(f"bad result image {r.image.shape}")
        if any(op not in OP_NAMES for op in r.ops):
            fail(f"unknown op names {r.ops}")
        if not all(np.isfinite(p).all() for p in r.params):
            fail("non-finite params")
        lens.append(len(r.ops))
    log(f"  buckets {sorted({r.bucket for r in results})}; program lengths "
        f"{sorted(set(lens))}; first programs {[r.ops for r in results[:4]]}")

    cpu = ServingEngine(actor_cpu, vocab, device="cpu", **kw)
    pick = [0, 24]                               # one of each bucket
    ref = cpu.edit_batch([imgs[i] for i in pick], [reqs[i] for i in pick])
    for i, r in zip(pick, ref):
        g = results[i]
        if g.ops != r.ops:
            fail(f"card and CPU decoded different programs: {g.ops} vs "
                 f"{r.ops}")
        for pg, pr in zip(g.params, r.params):
            # params are rounded to 4 places: values 1e-6 apart can round
            # 1e-4 apart
            if np.abs(np.array(pg) - np.array(pr)).max() > 1e-4 + 1e-6:
                fail(f"card and CPU params differ: {pg} vs {pr}")
        lsb = np.abs(g.image - r.image).max() * 255
        log(f"  card vs CPU [{i}]: ops {g.ops}, image max diff {lsb:.3f} LSB")
        if lsb > 1.0 + 1e-3:
            fail(f"card and CPU images differ by {lsb} LSB")

    engine.warmup(buckets=[(512, 512)])
    timed = make_images(64, 512, 512, seed=3)
    treqs = [TEXTS[i % 4] for i in range(64)]
    before = engine.stats["batches"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.edit_batch(timed, treqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nb = engine.stats["batches"] - before
    if len(out) != 64 or any(r is None for r in out):
        fail("timed run lost requests")
    log(f"serve 512 px, max_batch 8: {64 / dt:.2f} req/s, "
        f"{dt * 1e3 / nb:.2f} ms per micro-batch ({nb} micro-batches, "
        f"host clock around edit_batch)")
    return launches


def main():
    smi = device_phase()
    build_phase()
    k = kernel_phase()
    launches = serve_phase()
    kernels = {"kernels": [{
        "name": "chain", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/chain.cu",
        "replaces": "t2onet_tpu/ops/pallas_fused.py:270",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"]}]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
