"""The GAN cell: T2ONet+D's trainer (`cli.train_gan`), supervised
iterations (`train.loop.supervised_step`) alternating with GAN iterations
(`cli.train_gan.gan_step`) as the CLI counts them, over one `TrainState`
and one `GANState`, on the committed pairs staged by the `Prefetcher`.

What it shares with the training driver (`drivers/train.py`, imported):
the host pool read by the system's readers and checked against the
benchmark's own decode, the seeded batch order, the phase batches, the
Gumbel draws from the seed and the warm-up that the reference follows.
The discriminator bundle (`models.gan.DiscBundle`) takes its weights from
the seed too (`weights_gan`); G's and D's Adams are the CLI's.

The reference follows the first three iterations (supervised, GAN,
supervised): the losses, the actor's first gradient, G's and D's first
gradients as their Adams hold them, D's running averages after the
statistics update, and each parameter's change, read before the fourth
(`check_gan`).

The window and its rate are the training driver's. Its model FLOPs add
the discriminator's (`flops_gan`) to the actor's for each GAN iteration,
so `train_mfu` counts D; the discriminator's own FLOPs in the window come
from `GANState.stats`' counts at the window's ends where the program
keeps them. A `--trace 1` run traces its stretch with `span_trace`, which
divides the card's time by the `train.gan.gen` and `train.gan.disc`
spans where the program records them.
"""

from __future__ import annotations

import itertools
import os
import time

import torch

from benchmark import check_gan, flops, flops_gan, pool_check
from benchmark.drivers import train as T
from benchmark.weights import make_weights
from benchmark.weights_gan import make_disc_weights

SPANS = ("train.gan.gen", "train.gan.disc")


def _counts(gan):
    """The program's update counters, or None where it keeps none."""
    stats = getattr(gan, "stats", None)
    return dict(stats) if stats is not None else None


def run(ctx):
    from t2onet_tpu_torch.cli.train_gan import GANState, gan_step
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.models.actor import Actor
    from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses
    from t2onet_tpu_torch.precision import set_cuda_precision
    from t2onet_tpu_torch.train.loop import TrainState, supervised_step

    if ctx.device == "cuda":
        set_cuda_precision()        # the configuration's f32, as the CLI
    mix = ctx.traffic
    device = torch.device(ctx.device)
    model, gcfg = ctx.model_config(), ctx.config["gan"]
    vocab2id = ctx.vocab()
    ctx.phase("imports")
    ds = T.reader(ctx)
    pool = T.load_pool(ctx, ds)
    ctx.phase("data pool")
    data = ctx.config["data"]
    pool_off = pool_check.pool_off(ds, pool, ctx.seed, data["img_size"],
                                   os.path.join(ctx.root, data["actions"]))
    del ds
    ctx.phase("data pool checked")
    hidden = check_gan.hidden_dim(model)
    W = make_weights(model, len(vocab2id), ctx.seed, device)
    WD = make_disc_weights(gcfg, hidden, ctx.seed, device)
    ctx.phase("weights")
    actor = Actor(ModelConfig(**model), OperatorConfig(**ctx.op_config()),
                  len(vocab2id), generator=torch.Generator().manual_seed(0),
                  explore_prob=ctx.config["explore_prob"])
    actor.load_state_dict(W, strict=True)
    state = TrainState(actor.to(device), learning_rate=mix["learning_rate"])
    bundle = DiscBundle(hidden, cond_nc=gcfg["cond_nc"], ndf=gcfg["ndf"],
                        n_layers=gcfg["n_layers_D"], num_D=gcfg["num_D"])
    bundle.load_state_dict(WD, strict=True)
    gan = GANState(bundle.to(device), state.params, mix["gan_lr"],
                   mix["beta1"])
    losses = Seq2SeqGANLosses(n_layers=gcfg["n_layers_D"],
                              num_D=gcfg["num_D"],
                              use_lsgan=gcfg["use_lsgan"],
                              lambda_feat=gcfg["lambda_feat"],
                              use_gan_feat=gcfg["gan_feat"])
    ctx.phase("actor and discriminator")
    batch_size = mix["batch_size"]
    size = data["img_size"]
    per_update = flops_gan.updates(gcfg, batch_size, size, size, hidden)

    kept = []                 # the host batches of the followed steps
    counter = itertools.count(T.FIRST_ITERATION)

    def stage(b):
        itr = next(counter)
        sup = itr % 2 == 1
        keep = T.phase_batch(b, sup, False)
        if itr < T.FIRST_ITERATION + T.FOLLOWED:
            kept.append((sup, keep))
        step_flops = flops.train_step(model, keep, sup)
        if not sup:
            step_flops += sum(per_update.values())
        return sup, step_flops, device_put_batch(keep, device)

    it = Prefetcher(T.batches(pool, batch_size, ctx.seed,
                              model["op_vocab_size"], False),
                    to_device=stage, depth=mix["prefetch_depth"])
    step_no = [0]
    draws = [0]

    def noise_fn(shape):
        draws[0] += 1
        return T.gumbel(ctx.seed, step_no[0], draws[0] - 1, shape, device)

    def one_step():
        step_no[0] += 1
        draws[0] = 0
        t = time.perf_counter()
        sup, step_flops, batch = next(it)
        wait = time.perf_counter() - t
        if sup:
            m = supervised_step(state, batch)["loss"]
        else:
            m = gan_step(state, gan, batch, losses, fused_exec=True,
                         noise_fn=noise_fn)
        return m, step_flops, wait

    def trace_tick(elapsed):
        """Starts the harness's traced stretch (at the mix's `trace_at`
        share of the window) with `SpanTrace` in place of `Trace`, so that
        the card's time is also divided by the GAN iteration's spans; the
        harness's own `trace_tick` stops it `trace_s` later."""
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

    trainable = [(n, p) for n, p in actor.named_parameters()
                 if p.requires_grad]
    stat_names = check_gan.stat_keys(WD)
    initial_stats = {n: WD[n].clone() for n in stat_names}
    prog = {"losses": []}
    try:
        for s in range(1, mix["warm_steps"] + 1):
            m, _, _ = one_step()
            if s == 1:
                prog["losses"].append(m)
                prog["grad_norms"] = {
                    n: float(state.opt.state[p]["exp_avg"].norm()
                             / (1.0 - 0.9)) for n, p in trainable}
            if s == 2:
                # each Adam's first moment after its first step: (1 -
                # beta1) times the gradient
                keep = 1.0 - mix["beta1"]
                prog["losses"].append(m["G_loss"])
                prog["g_loss"] = float(m["G_loss"])
                prog["d_loss"] = float(m["D_loss"])
                prog["g_grad_norms"] = {
                    n: float(gan.g_opt.state[p]["exp_avg"].norm() / keep)
                    for n, p in trainable}
                prog["d_grad_norms"] = {
                    n: float(gan.d_opt.state[p]["exp_avg"].norm() / keep)
                    for n, p in gan.bundle.named_parameters()}
                with torch.no_grad():
                    sd = gan.bundle.state_dict()
                    prog["d_stats"] = {n: sd[n].clone() for n in stat_names}
                    prog["d_change_norms"] = {
                        n: float((p - WD[n]).norm())
                        for n, p in gan.bundle.named_parameters()}
            if s == T.FOLLOWED:
                prog["losses"].append(m)
                with torch.no_grad():
                    prog["change_norms"] = {
                        n: float((p - W[n]).norm()) for n, p in trainable}
        ctx.sync()
        prog["losses"] = [float(v) for v in prog["losses"]]
        ctx.phase("warm-up steps")
        ctx.mark_setup_done()
        before = _counts(gan)
        t0 = time.perf_counter()
        n_steps, wait_s, step_flops = 0, 0.0, 0.0
        while time.perf_counter() - t0 < ctx.seconds:
            trace_tick(time.perf_counter() - t0)
            _, f, wait = one_step()
            n_steps += 1
            wait_s += wait
            step_flops += f
        ctx.sync()
        t1 = time.perf_counter()
        after = _counts(gan)
        ctx.finish_trace()
    finally:
        it.close()
    if ctx.trace_summary is not None:
        ctx.note(f"traced device s by span [seconds, spans]: "
                 f"{ctx.trace_summary.get('span_device')} of busy "
                 f"{ctx.trace_summary['busy_s']:.4f}")
    ctx.read_memory_peak()
    ctx.readings.update(window_s=t1 - t0, images=n_steps * batch_size,
                        steps=n_steps, model_flops=step_flops,
                        data_wait_s=wait_s)
    if before is not None:
        ctx.readings["disc_flops"] = sum(
            (after[f"{k}s"] - before[f"{k}s"]) * per_update[k]
            for k in per_update)

    # -- correctness: the system's state freed first -----------------------
    del state, gan, actor, bundle, it
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref = check_gan.reference_readings(
        ctx, W, WD, kept, lambda step, k, shape: T.gumbel(ctx.seed, step, k,
                                                          shape, device),
        device, "f32")
    numbers = check_gan.judge(prog, ref, initial_stats)
    numbers["pool_off"] = float(pool_off)
    return {"attempted": n_steps, "failed": 0, "numbers": numbers}
