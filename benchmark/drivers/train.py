"""Training cells: the system's alternating trainer (`train.loop`
supervised and episode steps over one `TrainState`) on the committed
pairs, batches staged by its `data.loader.Prefetcher` as the training CLI
stages them.

Set-up: every item of the committed pairs read once by the system's
readers into a host pool, which `batches` draws from in a seeded order
and collates as the readers do; the actor with the seed's weights and
its Adam; the prefetcher over the seeded batch order; then the first `warm_steps`
steps through the window's own call and feed (odd iterations supervised,
even ones the sampled episode, as the CLI counts them). They warm every
shape, and the first three are what the reference follows: their
losses, the first two gradients as Adam holds them after the first and
the second step, and each parameter's change over the three, read
before the fourth. A sample of the pool is first held to a decode of
the benchmark's own (`pool_check`).

The window: steps until `--seconds` have passed, then a synchronise;
the rate counts every step taken over the window and that wait. The
time spent taking each batch from the prefetcher is summed.

The episode's Gumbel draws come from the seed, one generator for each
step and rollout step (`gumbel`), so the reference draws the same.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from benchmark import check_train, flops, pool_check
from benchmark.weights import make_weights

FOLLOWED = 3                  # steps the reference follows
FIRST_ITERATION = 1           # the CLI's count: odd iterations supervised


def gumbel(seed: int, step: int, k: int, shape, device):
    """Standard Gumbel draws for rollout step k of training step `step`."""
    g = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step * 101 + k) % (2 ** 63))
    u = torch.rand(shape, generator=g, device=device)
    u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def reader(ctx):
    """The system's dataset object of the configuration's training data,
    reading uint8 images at the training size."""
    data = ctx.config["data"]
    r = ctx.root
    if data["dataset"] == "GIER":
        from t2onet_tpu_torch.data.gier import GIERDatasetAct

        return GIERDatasetAct(
            os.path.join(r, data["dir"]), os.path.join(r, data["vocab_dir"]),
            os.path.join(r, data["actions"]), "train",
            data_mode=data["data_mode"], is_load_mask=data["masks"],
            session=data["session"], train_img_size=data["img_size"],
            wire_dtype=np.uint8)
    from t2onet_tpu_torch.data.fivek import FiveKAct

    return FiveKAct(os.path.join(r, data["dir"], "images"),
                    os.path.join(r, data["dir"], "annotations"),
                    os.path.join(r, data["actions"]), "train",
                    data["session"], data["img_size"],
                    op_max_len=ctx.model_config()["decoder_max_len"],
                    wire_dtype=np.uint8)


def load_pool(ctx, ds=None):
    """Every training item of the configuration's data, read once by the
    system's readers: (input, planned step images then the target, request
    ids, ops, params, {op id: mask} or None), images uint8."""
    ds = reader(ctx) if ds is None else ds
    if hasattr(ds, "GIER"):
        items = [ds[i] for i in range(len(ds))]
        return [(it["input"], it["output"], it["request_idx"],
                 it["operations"], it["parameters"], it.get("mask_dict"))
                for it in items]
    return [ds[i][:5] + (None,) for i in range(len(ds))]


def batches(pool, batch_size: int, seed: int, n_ops: int, masks: bool):
    """Batches of the pool in a seeded order, a fresh permutation each
    epoch, collated as the system's readers collate them (uint8 images;
    with masks, each local op's mask by the step's ground-truth op and by
    op id, ones where an op has none)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros(0, np.int64)
    while True:
        while len(buf) < batch_size:
            buf = np.concatenate([buf, rng.permutation(len(pool))])
        sel, buf = buf[:batch_size], buf[batch_size:]
        items = [pool[int(j)] for j in sel]
        b = {"img_x": np.stack([it[0] for it in items]),
             "img_y": np.stack([it[1] for it in items]),
             "x": np.stack([it[2] for it in items]).astype(np.int32),
             "y": np.stack([it[3] for it in items]).astype(np.int32),
             "gt_params": np.stack([it[4] for it in items])}
        if masks:
            size = b["img_x"].shape[-1]
            s = b["y"].shape[1] - 2
            step_m = np.ones((batch_size, s, 1, size, size), np.float32)
            vocab_m = np.ones((batch_size, n_ops, 1, size, size), np.float32)
            for bi, it in enumerate(items):
                for op_id, m in (it[5] or {}).items():
                    vocab_m[bi, int(op_id), 0] = m
                for si in range(s):
                    op_id = int(b["y"][bi, si + 1])
                    if it[5] and op_id in it[5]:
                        step_m[bi, si, 0] = it[5][op_id]
            b["step_masks"] = step_m
            b["masks_vocab"] = vocab_m
        yield b


def phase_batch(b, supervised: bool, masks: bool):
    """What a step of the phase reads, as the training CLI ships it: the
    supervised step the whole teacher sequence, the episode the input, the
    final target and, with masks, the masks by op id."""
    if supervised:
        return {k: b[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    keep = {"x": b["x"], "img_x": b["img_x"], "gt_img": b["img_y"][:, -1]}
    if masks:
        keep["masks_vocab"] = b["masks_vocab"]
    return keep


def followed_batches(ctx, pool):
    """The host batches of steps 1..FOLLOWED, as `run` stages them."""
    model = ctx.model_config()
    masks = bool(ctx.config["data"]["masks"])
    it = batches(pool, ctx.traffic["batch_size"], ctx.seed,
                 model["op_vocab_size"], masks)
    return [(s % 2 == 1, phase_batch(next(it), s % 2 == 1, masks))
            for s in range(FIRST_ITERATION, FIRST_ITERATION + FOLLOWED)]


def run(ctx):
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.models.actor import Actor
    from t2onet_tpu_torch.precision import set_cuda_precision
    from t2onet_tpu_torch.train.loop import (TrainState, episode_step,
                                             supervised_step)

    if ctx.device == "cuda":
        set_cuda_precision()        # the configuration's f32, as the CLI
    mix = ctx.traffic
    device = torch.device(ctx.device)
    model = ctx.model_config()
    vocab2id = ctx.vocab()
    ctx.phase("imports")
    ds = reader(ctx)
    pool = load_pool(ctx, ds)
    ctx.phase("data pool")
    data = ctx.config["data"]
    pool_off = pool_check.pool_off(ds, pool, ctx.seed, data["img_size"],
                                   os.path.join(ctx.root, data["actions"]))
    del ds
    ctx.phase("data pool checked")
    W = make_weights(model, len(vocab2id), ctx.seed, device)
    ctx.phase("weights")
    actor = Actor(ModelConfig(**model), OperatorConfig(**ctx.op_config()),
                  len(vocab2id), generator=torch.Generator().manual_seed(0),
                  explore_prob=ctx.config["explore_prob"])
    actor.load_state_dict(W, strict=True)
    state = TrainState(actor.to(device), learning_rate=mix["learning_rate"])
    ctx.phase("actor")
    masks = bool(ctx.config["data"]["masks"])
    batch_size = mix["batch_size"]

    kept = []                 # the host batches of the followed steps
    counter = itertools.count(FIRST_ITERATION)

    def stage(b):
        itr = next(counter)
        sup = itr % 2 == 1
        keep = phase_batch(b, sup, masks)
        if itr < FIRST_ITERATION + FOLLOWED:
            kept.append((sup, keep))
        return sup, flops.train_step(model, keep, sup), \
            device_put_batch(keep, device)

    it = Prefetcher(batches(pool, batch_size, ctx.seed,
                            model["op_vocab_size"], masks),
                    to_device=stage, depth=mix["prefetch_depth"])
    step_no = [0]
    draws = [0]

    def noise_fn(shape):
        draws[0] += 1
        return gumbel(ctx.seed, step_no[0], draws[0] - 1, shape, device)

    def one_step():
        step_no[0] += 1
        draws[0] = 0
        t = time.perf_counter()
        sup, step_flops, batch = next(it)
        wait = time.perf_counter() - t
        if sup:
            m = supervised_step(state, batch)["loss"]
        else:
            m = episode_step(state, batch, sample=True, fused_exec=True,
                             noise_fn=noise_fn)["L1_loss"]
        return m, step_flops, wait

    trainable = [(n, p) for n, p in actor.named_parameters()
                 if p.requires_grad]
    prog = {"losses": []}
    try:
        for s in range(1, mix["warm_steps"] + 1):
            loss, _, _ = one_step()
            if s <= FOLLOWED:
                prog["losses"].append(loss)
            if s == 1:
                first = {n: state.opt.state[p]["exp_avg"].clone()
                         for n, p in trainable}
                prog["grad_norms"] = {n: float(m.norm() / (1.0 - 0.9))
                                      for n, m in first.items()}
            if s == 2:
                # Adam's first moment after two steps is
                # 0.9 m1 + 0.1 g2: the second gradient as Adam got it
                prog["grad_norms_2"] = {
                    n: float(((state.opt.state[p]["exp_avg"]
                               - 0.9 * first[n]) / (1.0 - 0.9)).norm())
                    for n, p in trainable}
                del first
            if s == FOLLOWED:
                with torch.no_grad():
                    prog["change_norms"] = {
                        n: float((p - W[n]).norm()) for n, p in trainable}
        ctx.sync()
        prog["losses"] = [float(v) for v in prog["losses"]]
        ctx.phase("warm-up steps")
        ctx.mark_setup_done()
        t0 = time.perf_counter()
        n_steps, wait_s, step_flops = 0, 0.0, 0.0
        while time.perf_counter() - t0 < ctx.seconds:
            ctx.trace_tick(time.perf_counter() - t0)
            _, f, wait = one_step()
            n_steps += 1
            wait_s += wait
            step_flops += f
        ctx.sync()
        t1 = time.perf_counter()
        ctx.finish_trace()
    finally:
        it.close()
    ctx.read_memory_peak()
    ctx.readings.update(window_s=t1 - t0, images=n_steps * batch_size,
                        steps=n_steps, model_flops=step_flops,
                        data_wait_s=wait_s)

    # -- correctness: the system's state freed first -----------------------
    del state, actor, it
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = check_train.reference_readings(
        ctx, W, kept, lambda step, k, shape: gumbel(ctx.seed, step, k,
                                                    shape, device),
        device, "f32")
    numbers = check_train.judge(prog, ref)
    numbers["pool_off"] = float(pool_off)
    return {"attempted": n_steps, "failed": 0, "numbers": numbers}
