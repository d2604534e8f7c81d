"""The pix2pixHD cell: its 2048x1024 recipe trained through the system's
step (`train.pix2pixhd.pix2pixhd_step`) over one `Pix2PixHDState`, one
iteration a step, on batches staged by the system's
`data.loader.Prefetcher`.

Set-up: the committed FiveK training pairs (the photo as input, its
expert's retouch as target), each image read once by the system's reader
(`data.fivek.load_train_img`: cv2, resized to the configuration's
height x width, uint8) into a host pool; every weight from the seed
(`weights_pix2pixhd`), kept on the host for the check once the state
holds them; the state; the prefetcher over the seeded batches: the pairs
in an order drawn from the seed, epoch after epoch, each pair flipped
horizontally with even odds, drawn from the seed (pix2pixHD's default
flip). Then the first `warm_steps` steps through the window's own call
and feed. They warm every shape, and the first two are what the
reference follows (`check_p2p`): G's output and D's logits of the first
(forward hooks), the losses of each, the first gradients as the Adams
hold them, and after the second the second gradients (from the Adams'
first moments) and each network's change.

The window: steps until `--seconds` have passed, then a synchronise; the
rate counts the batch's images a step over the window and that wait. The
time spent taking each batch from the prefetcher is summed. The model
FLOPs of the window are `flops_pix2pixhd.step`'s, the whole step's and
D's part (`p2p_flops`, `disc_flops`), times the steps
`Pix2PixHDState.stats` counted over it. A `--trace 1` run traces its
stretch with `span_trace`, dividing the card's time by the two spans of a
step.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from benchmark import check_p2p, flops_pix2pixhd
from benchmark.weights_pix2pixhd import make_pix2pixhd_weights, options

SPANS = ("train.p2p.gen", "train.p2p.disc")


def load_pairs(ctx, h: int, w: int):
    """(inputs, targets) of the configuration's split, (N, 3, h, w)
    uint8."""
    from t2onet_tpu_torch.data.fivek import load_train_img

    data = ctx.config["data"]
    root = os.path.join(ctx.root, data["dir"])
    with open(os.path.join(root, "annotations",
                           f"{data['split']}_sess_{data['session']}.json")
              ) as f:
        pairs = json.load(f)

    def read(name):
        return load_train_img(os.path.join(root, "images", name), (h, w),
                              np.uint8)

    return (np.stack([read(d["input"]) for d in pairs]),
            np.stack([read(d["output"]) for d in pairs]))


def batches(inputs, targets, batch: int, seed: int):
    """The pairs in a seeded order, epoch after epoch, each flipped
    horizontally with even odds. The benchmark draws its own (the
    program's `train.pix2pixhd.pair_batches` is the CLI's), so that the
    cell's traffic does not move with the program."""
    rng = np.random.default_rng(seed & (2 ** 63 - 1))
    while True:
        order = rng.permutation(len(inputs))
        for at in range(0, len(order) - batch + 1, batch):
            sel = order[at:at + batch]
            lab, img = inputs[sel], targets[sel]
            turn = rng.random(batch) < 0.5
            lab[turn] = lab[turn][..., ::-1]
            img[turn] = img[turn][..., ::-1]
            yield {"label": lab, "image": img}


def _state(W, m, device):
    from t2onet_tpu_torch.models.gan import MultiscaleDiscriminator
    from t2onet_tpu_torch.models.pix2pixhd import define_generator
    from t2onet_tpu_torch.models.vgg import Vgg19Features
    from t2onet_tpu_torch.train.pix2pixhd import Pix2PixHDState

    o = options(m)
    with torch.device(device):      # their default init, overwritten here
        nets = {"gen": define_generator(
                    m["netG"], **{k: o[k] for k in (
                        "ngf", "n_downsample_global", "n_blocks_global",
                        "n_local_enhancers", "n_blocks_local")}),
                "disc": MultiscaleDiscriminator(
                    m["input_nc"] + m["output_nc"], 0, o["ndf"],
                    o["n_layers_D"], o["num_D"], norm=m["norm"]),
                "vgg": Vgg19Features()}
    for part, net in nets.items():
        net.load_state_dict(W[part], strict=True)
    return Pix2PixHDState(nets["gen"], nets["disc"], nets["vgg"])


def _grad(opt, net, names, beta1):
    """The first gradient as the Adam holds it, in `names`' order."""
    params = dict(net.named_parameters())
    return check_p2p.flat({n: opt.state[params[n]]["exp_avg"]
                           for n in names}, names, 1.0 / (1.0 - beta1))


def run(ctx):
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.precision import set_cuda_precision
    from t2onet_tpu_torch.train.pix2pixhd import pix2pixhd_step

    from benchmark.reference import pix2pixhd as R

    if ctx.device == "cuda":
        set_cuda_precision()        # the configuration's f32
    mix, m = ctx.traffic, ctx.model_config()
    h, w = m["height"], m["width"]
    device = torch.device(ctx.device)
    batch = mix["batch_size"]
    o = options(m)
    ctx.phase("imports")
    inputs, targets = load_pairs(ctx, h, w)
    ctx.phase(f"data pool ({len(inputs)} pairs at {h}x{w})")
    W = make_pix2pixhd_weights(ctx.seed, device, o)
    state = _state(W, m, device)
    W = {part: {n: t.cpu() for n, t in v.items()} for part, v in W.items()}
    ctx.phase("weights and state")
    parts = flops_pix2pixhd.step(o, batch, h, w)
    per_step = sum(parts.values())
    g_names = R.names(R.generator_specs(o))
    d_names = R.names(R.disc_specs(o))

    kept = []

    def keep(b):
        if len(kept) < check_p2p.STEPS:
            kept.append(b)
        return device_put_batch(b, device)

    it = Prefetcher(batches(inputs, targets, batch, ctx.seed),
                    to_device=keep, depth=mix["prefetch_depth"])

    def one_step():
        t = time.perf_counter()
        b = next(it)
        wait = time.perf_counter() - t
        return pix2pixhd_step(state, b), wait

    def trace_tick(elapsed):
        """The harness's traced stretch with `SpanTrace` in place of
        `Trace` (the GAN driver's start); the harness stops it."""
        if not ctx.trace or ctx.trace_summary is not None:
            return
        if ctx._tracer is None:
            if elapsed >= mix["trace_at"] * ctx.seconds:
                from benchmark.span_trace import SpanTrace

                ctx._tracer = SpanTrace(SPANS, ctx.kernel_parts())
                ctx._tracer.start()
                ctx.kernels.recording = True
                ctx._trace_t0 = elapsed
        else:
            ctx.trace_tick(elapsed)

    seen = {"fake": [], "logits": []}
    hooks = [state.gen.register_forward_hook(
                 lambda mod, inp, out: seen["fake"].append(
                     out.detach().cpu())),
             state.disc.register_forward_hook(
                 lambda mod, inp, out: seen["logits"].append(
                     [s[-1].detach().cpu() for s in out]))]
    prog = {"losses": []}
    try:
        for s in range(1, mix["warm_steps"] + 1):
            got, _ = one_step()
            if s <= check_p2p.STEPS:
                prog["losses"].append({k: float(v) for k, v in got.items()})
            if s == 1:
                for hook in hooks:
                    hook.remove()
                prog["g_grad"] = _grad(state.g_opt, state.gen, g_names,
                                       m["beta1"])
                prog["d_grad"] = _grad(state.d_opt, state.disc, d_names,
                                       m["beta1"])
            if s == check_p2p.STEPS:
                # the second gradient from the Adams' first moments
                for key, opt, net, names in (
                        ("g_grad", state.g_opt, state.gen, g_names),
                        ("d_grad", state.d_opt, state.disc, d_names)):
                    prog[f"{key}2"] = _grad(opt, net, names, m["beta1"]) \
                        - m["beta1"] * prog[key]
                for key, net, part, names in zip(
                        ("change", "d_change"), (state.gen, state.disc),
                        ("gen", "disc"), check_p2p.changed_names(o)):
                    params = dict(net.named_parameters())
                    prog[key] = check_p2p.flat(
                        {n: params[n].detach().cpu() - W[part][n]
                         for n in names}, names)
        # D's passes in pix2pixHD's order: the fake's, the target's, G's
        prog["fake"] = seen["fake"][0]
        prog["logits"] = {"fake": seen["logits"][0],
                          "real": seen["logits"][1]}
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
        steps = after["steps"] - before["steps"]
        ctx.readings.update(p2p_flops=steps * per_step,
                            disc_flops=steps * parts["disc"])

    # -- correctness: the system's state freed first -----------------------
    del state, it
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = check_p2p.reference_readings(ctx, W, kept, device, "f32")
    numbers = check_p2p.judge(prog, ref)
    return {"attempted": n_steps, "failed": 0, "numbers": numbers}
