"""The inpainting cell: EdgeConnect's MODEL 3 stage, the inpaint slot's
EdgeConnect filler trained through the system's step
(`train.edgeconnect.edgeconnect_inpaint_step`) over one
`EdgeConnectState`, one iteration a step, on batches staged by the
system's `data.loader.Prefetcher`.

Set-up: the committed GIER images, each read once by the system's reader
(`data.fivek.load_train_img`: cv2, resized to the configuration's input
size, uint8) into a host pool; the external masks of MASK 4, every local
operation's unioned object mask of the committed GIER annotations
(`data.gier.GIER.resize_and_union_mask`, nearest, binary); every weight
from the seed (`weights_edgeconnect`); the state; the prefetcher over
the seeded batches: the images in an order drawn from the seed, epoch
after epoch, and for each image even odds of an external mask (drawn
uniformly) or a block of half the side at a uniform place
(EdgeConnect's MASK 4). Then the first `warm_steps` steps through the
window's own call and feed. They warm every shape, and the first two are
what the reference follows (`check_inpaint`): the edge G's edge channel
and output of each (forward hooks), the losses of each, the first
gradients as the Adams hold them and every spectral-normed layer's
vectors after the first, each network's change after the second.

The window: steps until `--seconds` have passed, then a synchronise; the
rate counts 8 images a step (the batch) over the window and that wait.
The time spent taking each batch from the prefetcher is summed. The
model FLOPs of the window are `flops_edgeconnect.step_flops` times the
steps `EdgeConnectState.stats` counted over it. A `--trace 1` run traces
its stretch with `span_trace`, dividing the card's time by the three
spans of a step, and counts the hysteresis kernel's time and calls.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch

from benchmark import check_inpaint, flops_edgeconnect
from benchmark.weights_edgeconnect import copy, make_edgeconnect_weights

SPANS = ("train.inpaint.edges", "train.inpaint.gen", "train.inpaint.disc")
# the profiler's kernel names: every hysteresis kernel, and one a call
HYSTERESIS_PARTS = ("hysteresis", "hysteresis_init")
SPLITS = ("train", "val", "test")


def load_images(ctx, size: int) -> np.ndarray:
    from t2onet_tpu_torch.data.fivek import load_train_img

    paths = sorted(glob.glob(os.path.join(ctx.root,
                                          ctx.config["data"]["images"], "*")))
    return np.stack([load_train_img(p, size, np.uint8) for p in paths])


def load_masks(ctx, size: int) -> np.ndarray:
    """Every local operation's unioned object mask, (N, size, size) f32."""
    from t2onet_tpu_torch.data.gier import GIER

    data = ctx.config["data"]
    out = []
    for phase in SPLITS:
        g = GIER(os.path.join(ctx.root, data["dir"]),
                 os.path.join(ctx.root, data["vocab_dir"]), phase,
                 data_mode=data["mask_data_mode"], is_load_mask=True,
                 session=data["session"])
        for pid in range(len(g)):
            name = g.op_data[pid]["input"].split("_")[0]
            for ids in g.get_op_info(pid)[2].values():
                out.append(g.resize_and_union_mask(ids, name, (size, size)))
    return np.stack(out).astype(np.float32)


def draw_masks(rng, n: int, size: int, external) -> np.ndarray:
    """EdgeConnect's MASK 4: (n, 1, size, size), 1 = hole. The benchmark
    draws its own (the program's `train.edgeconnect.mask4` is the CLI's),
    so that the cell's traffic does not move with the program."""
    out = np.zeros((n, 1, size, size), np.float32)
    half = size // 2
    for i in range(n):
        if rng.binomial(1, 0.5):
            y, x = rng.integers(0, size - half + 1, size=2)
            out[i, 0, y:y + half, x:x + half] = 1.0
        else:
            out[i, 0] = external[rng.integers(len(external))]
    return out


def batches(images, masks, batch: int, seed: int):
    rng = np.random.default_rng(seed & (2 ** 63 - 1))
    size = images.shape[-1]
    while True:
        order = rng.permutation(len(images))
        for at in range(0, len(order) - batch + 1, batch):
            yield {"images": images[order[at:at + batch]],
                   "masks": draw_masks(rng, batch, size, masks)}


def _state(W, ctx, device):
    from t2onet_tpu_torch.models.edgeconnect import (Discriminator,
                                                     EdgeGenerator,
                                                     InpaintGenerator)
    from t2onet_tpu_torch.models.vgg import Vgg19Features
    from t2onet_tpu_torch.train.edgeconnect import VGG_END, EdgeConnectState

    with torch.device(device):      # their default init, overwritten here
        nets = {"edge": EdgeGenerator(spectral=True),
                "inpaint": InpaintGenerator(), "disc": Discriminator(),
                "vgg": Vgg19Features(VGG_END)}
    for part, net in nets.items():
        net.load_state_dict(W[part], strict=True)
    return EdgeConnectState(nets["edge"], nets["inpaint"], nets["disc"],
                            nets["vgg"], lr=ctx.model_config()["lr"])


def _vectors(state) -> dict:
    from t2onet_tpu_torch.models.edgeconnect import spectral_layers

    return {n: (m.weight_u.detach().clone(), m.weight_v.detach().clone())
            for net in (state.edge_g, state.disc)
            for n, m in spectral_layers(net)}


def run(ctx):
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.precision import set_cuda_precision
    from t2onet_tpu_torch.train.edgeconnect import edgeconnect_inpaint_step

    if ctx.device == "cuda":
        set_cuda_precision()        # the configuration's f32
    mix, size = ctx.traffic, ctx.model_config()["input_size"]
    device = torch.device(ctx.device)
    batch = mix["batch_size"]
    ctx.phase("imports")
    images = load_images(ctx, size)
    masks = load_masks(ctx, size)
    ctx.phase(f"data pool ({len(images)} images, {len(masks)} masks)")
    W = make_edgeconnect_weights(ctx.seed, device)
    state = _state(copy(W), ctx, device)
    ctx.phase("weights and state")
    per_step = flops_edgeconnect.step_flops(batch, size, size)
    ctx.readings["hysteresis_call"] = flops_edgeconnect.hysteresis_call(
        batch, size, size)

    kept = []

    def keep(b):
        if len(kept) < check_inpaint.STEPS:
            kept.append(b)
        return device_put_batch(b, device)

    it = Prefetcher(batches(images, masks, batch, ctx.seed), to_device=keep,
                    depth=mix["prefetch_depth"])

    def one_step():
        t = time.perf_counter()
        b = next(it)
        wait = time.perf_counter() - t
        return edgeconnect_inpaint_step(state, b), wait

    def trace_tick(elapsed):
        """The harness's traced stretch with `SpanTrace` in place of
        `Trace` (the GAN driver's start); the harness stops it."""
        if not ctx.trace or ctx.trace_summary is not None:
            return
        if ctx._tracer is None:
            if elapsed >= mix["trace_at"] * ctx.seconds:
                from benchmark.span_trace import SpanTrace

                ctx._tracer = SpanTrace(
                    SPANS, ctx.kernel_parts() + HYSTERESIS_PARTS)
                ctx._tracer.start()
                ctx.kernels.recording = True
                ctx._trace_t0 = elapsed
        else:
            ctx.trace_tick(elapsed)

    seen = []
    hook = state.edge_g.register_forward_hook(
        lambda mod, inp, out: seen.append(
            (inp[0][:, 1].bool().cpu(), out.detach().cpu())))
    prog = {"losses": []}
    try:
        for s in range(1, mix["warm_steps"] + 1):
            m, _ = one_step()
            if s <= check_inpaint.STEPS:
                prog["losses"].append({k: float(v) for k, v in m.items()})
            if s == 1:
                prog["g_grad"] = torch.cat([
                    state.g_opt.state[p]["exp_avg"].reshape(-1)
                    for p in state.g_params]).clone()
                prog["d_grad"] = torch.cat([
                    state.d_opt.state[p]["exp_avg"].reshape(-1)
                    for p in state.d_params]).clone()
                prog["sigma"] = check_inpaint.sigmas(
                    _vectors(state), {**W["edge"], **W["disc"]})
            if s == check_inpaint.STEPS:
                hook.remove()
                with torch.no_grad():
                    prog["change"] = torch.cat([
                        (p - W["inpaint"][n]).reshape(-1) for n, p in
                        state.inpaint_g.named_parameters()])
                    prog["d_change"] = torch.cat([
                        (p - W["disc"][n]).reshape(-1) for n, p in
                        state.disc.named_parameters()])
        prog["edges"] = [e for e, _ in seen]
        prog["pred"] = [p for _, p in seen]
        ctx.sync()
        ctx.phase("warm-up steps")
        ctx.mark_setup_done()
        stats = getattr(state, "stats", None)
        before = dict(stats) if stats is not None else None
        t0 = time.perf_counter()
        n_steps, wait_s = 0, 0.0
        while time.perf_counter() - t0 < ctx.seconds:
            trace_tick(time.perf_counter() - t0)
            _, wait = one_step()
            n_steps += 1
            wait_s += wait
        ctx.sync()
        t1 = time.perf_counter()
        after = dict(stats) if stats is not None else None
        ctx.finish_trace()
    finally:
        it.close()
    if ctx.trace_summary is not None:
        ctx.note(f"traced device s by span [seconds, spans]: "
                 f"{ctx.trace_summary.get('span_device')} of busy "
                 f"{ctx.trace_summary['busy_s']:.4f}")
    ctx.read_memory_peak()
    ctx.readings.update(window_s=t1 - t0, images=n_steps * batch,
                        steps=n_steps, data_wait_s=wait_s)
    if before is not None:
        ctx.readings["edgeconnect_flops"] = \
            (after["steps"] - before["steps"]) * per_step

    # -- correctness: the system's state freed first -----------------------
    del state, it
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = check_inpaint.reference_readings(ctx, W, kept, device, "f32")
    numbers = check_inpaint.judge(prog, ref)
    return {"attempted": n_steps, "failed": 0, "numbers": numbers}
