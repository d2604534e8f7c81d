"""Where the bf16 ResNet's time goes on the card: the FiveK trainer's
supervised and fused episode steps at ModelConfig() width, b64 x 128 px,
in f32 and in bf16 as the port runs it (each convolution casts its f32
weight to bf16 as it runs, NCHW), beside two variants of the bf16 path
patched in here for the measurement only:

- "cast_once": each weight cast to bf16 once per training step (cached
  until the optimizer changes the weight), not once per forward;
- "channels_last": the same casts, the activations and weights in
  channels-last (NHWC) layout.

Each variant's steps are timed in turns (f32, bf16, cast_once,
channels_last, then the reverse): host clock around each synchronised
step (median of 6 after 2 warm-ups), device time and operations per
step (torch.profiler, 2 steps). It only times; chip_smoke.py checks.

    python3 scripts/torch_bf16_steps.py      # on a CUDA card, ~1 min
"""

import dataclasses
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig  # noqa: E402
from t2onet_tpu_torch.data.loader import device_put_batch  # noqa: E402
from t2onet_tpu_torch.data.synthetic import (SyntheticFiveK,  # noqa: E402
                                             synthetic_vocab)
from t2onet_tpu_torch.models import resnet  # noqa: E402
from t2onet_tpu_torch.models.actor import Actor  # noqa: E402
from t2onet_tpu_torch.precision import set_cuda_precision  # noqa: E402
from t2onet_tpu_torch.train import loop  # noqa: E402

PORT_CONV = resnet._conv
PORT_FORWARD = resnet.ResNet.forward


def cast_once_conv():
    cache = {}

    def conv(c, x):
        if x.dtype != torch.bfloat16:
            return PORT_CONV(c, x)
        hit = cache.get(id(c.weight))
        if hit is None or hit[0] != c.weight._version:
            hit = (c.weight._version, c.weight.to(torch.bfloat16))
            cache[id(c.weight)] = hit
        return F.conv2d(x, hit[1], None, c.stride, c.padding)

    return conv


def channels_last_conv(c, x):
    w = c.weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, None, c.stride, c.padding)


def channels_last_forward(self, img):
    return PORT_FORWARD(self, img.contiguous(
        memory_format=torch.channels_last))


def use(variant):
    resnet._conv = {"cast_once": cast_once_conv(),
                    "channels_last": channels_last_conv}.get(variant,
                                                             PORT_CONV)
    resnet.ResNet.forward = (channels_last_forward
                             if variant == "channels_last" else PORT_FORWARD)


def timed(fn, n=6, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def device(fn, calls=2):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = count = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            total += t
            count += e.count
    return total / calls / 1e3, count / calls


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_bf16_steps.py needs a CUDA card")
    set_cuda_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    nb = next(SyntheticFiveK(n=64, img_size=128, seed=5)
              .batches(64, 1, shuffle=False))
    sup = device_put_batch({k: nb[k] for k in ("x", "y", "img_x", "img_y",
                                               "gt_params")}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1]}, "cuda")
    base = ModelConfig()
    states = {}
    for bf16 in (False, True):
        actor = Actor(dataclasses.replace(base, vis_bf16=bf16),
                      OperatorConfig(), len(synthetic_vocab()),
                      generator=torch.Generator().manual_seed(3))
        states[bf16] = loop.TrainState(actor.cuda())
    gen = torch.Generator(device="cuda").manual_seed(7)
    order = ("f32", "bf16", "cast_once", "channels_last")
    rows = {v: [] for v in order}
    for variant in order + order[::-1]:
        use(variant)
        st = states[variant != "f32"]

        def s_step(st=st):
            return loop.supervised_step(st, sup)

        def e_step(st=st):
            return loop.episode_step(st, epi, gen, fused_exec=True)

        row = (timed(s_step), timed(e_step)) + device(s_step) + \
            device(e_step)
        rows[variant].append(row)
        print(f"{variant:>13}: supervised {row[0]:.2f} ms host, "
              f"{row[2]:.2f} ms device in {row[3]:.0f} operations; "
              f"episode {row[1]:.2f} ms host, {row[4]:.2f} ms device in "
              f"{row[5]:.0f} operations", flush=True)
    use("bf16")
    print("summary (both turns): " + "; ".join(
        f"{v} sup {min(r[0] for r in rows[v]):.2f}-"
        f"{max(r[0] for r in rows[v]):.2f} / "
        f"{min(r[2] for r in rows[v]):.2f}-{max(r[2] for r in rows[v]):.2f}"
        f" ms, epi {min(r[1] for r in rows[v]):.2f}-"
        f"{max(r[1] for r in rows[v]):.2f} / "
        f"{min(r[4] for r in rows[v]):.2f}-{max(r[4] for r in rows[v]):.2f}"
        f" ms (host / device)" for v in order))


if __name__ == "__main__":
    main()
