"""T2ONet+D trainer: alternating supervised and conditional-GAN iterations
(counterpart of `t2onet_tpu.cli.train_gan`; reference
experiments/t2onet+D-L1/train_seq2seqGAN.py).

Odd iterations are teacher-forced, as in the FiveK trainer. Even ones
roll the actor out with sampled ops, take each sample's image at <END>
as the fake, and update twice: G (the actor) on G_GAN + G_GAN_Feat (+
G_VGG with `--vgg_ckpt`) through its own Adam, then D (the multiscale
discriminator and the condition encoder) on (D_fake + D_real) / 2. The
condition is the encoder's hidden state, held fixed; D sees the fake
detached. The discriminator's BatchNorm running averages move once an
iteration (`DiscBundle.update_stats`).

On a CUDA device each sampled rollout step executes through the fused
step (`--fused_exec`, on by default there): the chain kernel forward and
the step backward kernel when the G loss is differentiated through the
executed images; the validation's greedy rollout runs the chain kernel.
On the CPU the rollout runs the one-hot bank, as the JAX trainer's
always does.

Checkpoints go to `{run_dir}/seq2seqGAN_model/`: the actor's as the
FiveK trainer's, the discriminator's state_dict (reference names) in
`disc/`, the G and D optimizers in `gan_opt/`. `--resume` restores all
three.

  python -m t2onet_tpu_torch.cli.train_gan --data_dir data_real_h2h \\
      --act_dir data_real_h2h_acts/actions_set_1 \\
      --glove_path data_real_h2h_acts/FiveK_vocabs_glove_feat_1.npy
  python -m t2onet_tpu_torch.cli.train_gan --synthetic --device cpu ...

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.cli.train_fivek import evaluate
from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
from t2onet_tpu_torch.models.actor import select_end_images
from t2onet_tpu_torch.models.common import init_torch_defaults
from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses
from t2onet_tpu_torch.train.checkpoint import (CheckpointManager,
                                               StateCheckpointer)
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.train.loop import (TrainState, adam_step, global_draws,
                                         global_metrics, supervised_step)


class GANState:
    """The discriminator bundle and the GAN iteration's two Adams: G's over
    the actor's trainable parameters, D's over the bundle's."""

    def __init__(self, bundle: DiscBundle, actor_params, gan_lr: float = 2e-4,
                 beta1: float = 0.5):
        self.bundle = bundle
        self.d_params = list(bundle.parameters())
        self.g_params = list(actor_params)
        self.d_opt = torch.optim.Adam(self.d_params, lr=gan_lr,
                                      betas=(beta1, 0.999), eps=1e-8)
        self.g_opt = torch.optim.Adam(self.g_params, lr=gan_lr,
                                      betas=(beta1, 0.999), eps=1e-8)


def last_valid_teacher(img_y: np.ndarray) -> np.ndarray:
    """Each sample's last non-black planner step image, the AdaptGAN
    pseudo-real (reference seq2seqAdaptGAN.py:85-111); the first slot
    when none is. img_y (B, T, 3, H, W) with the ground truth last; the
    dataset zero-pads the steps past the trajectory's truncation.
    Host numpy: the one frame is picked before the transfer."""
    inter = img_y[:, :-1]
    mag = inter.astype(np.int64) if img_y.dtype == np.uint8 else inter
    valid = np.abs(mag).sum(axis=(2, 3, 4)) > 0           # (B, T-1)
    t = valid.shape[1]
    idx = t - 1 - np.argmax(valid[:, ::-1].astype(np.int32), axis=1)
    idx = np.where(valid.any(axis=1), idx, 0)
    return np.take_along_axis(inter, idx[:, None, None, None, None],
                              axis=1)[:, 0]


def gan_step(state: TrainState, gan: GANState, batch, losses,
             generator=None, fused_exec: bool = False, noise_fn=None):
    """One GAN iteration (train_seq2seqGAN.py:77-130). batch: x (B,L),
    img_x (B,3,H,W), gt_img (B,3,H,W), optionally pseudo_real (B,3,H,W),
    on the actor's device. The rollout samples its ops with Gumbel draws
    from `generator` (or `noise_fn`); `fused_exec` executes each step
    through `ops.step.fused_step`. Returns the metrics as tensors on the
    device.

    Under a data-parallel group (JAX's `make_gan_step(mesh=)`) each rank
    takes its rows: the draws are the global batch's rows, every
    BatchNorm (the actor's, D's and the condition encoder's, and D's
    statistics update) normalises with the global batch's statistics,
    each loss, a mean over the batch, counts as its rank's share of the
    global mean, and G's and D's gradients are summed over the ranks;
    both Adams stay replicated."""
    actor, bundle = state.actor, gan.bundle
    actor.train()
    bundle.train()
    src, gt = batch["img_x"], batch["gt_img"]
    pseudo = batch.get("pseudo_real")
    # a rank's share of a global mean over equal row blocks
    share = 1.0 / mesh.data_size()
    # the text condition from the encoder's hidden state, held fixed
    with torch.no_grad():
        enc_h = actor.lang_encoder(batch["x"])[1][0]
        cond = bundle.cond_encoder(enc_h)

    noise_fn, _ = global_draws(generator, noise_fn)
    out = actor.episode(batch["x"], src, sample=True, generator=generator,
                        noise_fn=noise_fn, fused_exec=fused_exec)
    fake = select_end_images(out["imgs"], out["ops"])
    bundle.requires_grad_(False)       # G's loss reaches the actor only
    try:
        ld = losses(bundle.netD, src, fake, gt, cond, pseudo_real=pseudo,
                    parts="g")
    finally:
        bundle.requires_grad_(True)
    g_total = ld["G_GAN"] + ld["G_GAN_Feat"] + ld["G_VGG"]
    adam_step(gan.g_opt, gan.g_params,
              g_total * share if mesh.active() else g_total)

    ld2 = losses(bundle.netD, src, fake.detach(), gt,
                 bundle.cond_encoder(enc_h), pseudo_real=pseudo, parts="d")
    d_total = 0.5 * (ld2["D_fake"] + ld2["D_real"])
    adam_step(gan.d_opt, gan.d_params,
              d_total * share if mesh.active() else d_total)

    bundle.update_stats(torch.cat([src, gt], dim=1), enc_h)
    state.step += 1
    metrics = {"G_loss": g_total, "D_loss": d_total,
               "G_GAN": ld["G_GAN"], "G_GAN_Feat": ld["G_GAN_Feat"],
               "D_real": ld2["D_real"], "D_fake": ld2["D_fake"]}
    if mesh.active():
        metrics = {k: v * share for k, v in metrics.items()}
    return global_metrics(metrics)


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    common.add_train_args(p)
    p.add_argument("--gan_lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--lambda_feat", type=float, default=10.0)
    p.add_argument("--adapt_pseudo_real", type=int, default=0,
                   help="AdaptGAN: use the last planner edit as pseudo-real")
    p.add_argument("--wire_u8", type=int, default=1, choices=(0, 1),
                   help="file datasets ship images to the device as uint8 "
                        "and divide by 255 there (4x fewer bytes)")
    p.add_argument("--vgg_ckpt", default=None,
                   help="torchvision vgg19 .pth: adds the G_VGG perceptual "
                        "term (reference VGGLoss); without it G_VGG is 0, "
                        "as the reference's --no_vgg_loss")
    p.add_argument("--fused_exec", type=int, default=-1, choices=(-1, 0, 1),
                   help="the GAN rollout executes ops through the fused "
                        "step kernels instead of the one-hot bank. -1 "
                        "(default): on for a CUDA device, off on the CPU")
    return p


def build_disc(a, device) -> DiscBundle:
    """The discriminator bundle the flags describe, weights drawn as
    torch's defaults from --manual_seed + 7, on `device`."""
    bundle = DiscBundle(a.n_layers * 2 * a.hidden_size, ndf=64,
                        n_layers=a.n_layers_D, num_D=a.num_D)
    init_torch_defaults(bundle, torch.Generator().manual_seed(
        a.manual_seed + 7))
    return bundle.to(device)


def main(argv=None):
    """Train; returns (TrainState, GANState)."""
    a = train_parser().parse_args(argv)
    device = common.resolve_device(a.device)
    run_dir = common.resolve_run_dir(a)

    train_ds, vocab2id, _, w2v = common.build_dataset_and_vocab(
        a, "train", wire_u8=bool(a.wire_u8))
    val_ds = common.build_dataset_and_vocab(a, "val",
                                            eval_img_mode="train_size")[0]
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    state = TrainState(actor.to(device), learning_rate=a.learning_rate)
    gan = GANState(build_disc(a, device), state.params, a.gan_lr, a.beta1)
    perceptual_fn = None
    if a.vgg_ckpt:
        from t2onet_tpu_torch.models.vgg import load_vgg19

        perceptual_fn = load_vgg19(a.vgg_ckpt, device)[1]
    losses = Seq2SeqGANLosses(n_layers=a.n_layers_D, num_D=a.num_D,
                              lambda_feat=a.lambda_feat,
                              perceptual_fn=perceptual_fn)
    fused = common.resolve_fused_exec(a.fused_exec, device)
    print(f"GAN rollout executor: "
          f"{'fused step kernels' if fused else 'one-hot bank'} on {device}")

    keep = a.max_keep_ckpts or None
    ckpt_dir = os.path.join(run_dir, "seq2seqGAN_model")
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=keep)
    # the discriminator rides along for the planner's disc distance
    # (cli/plan_fivek.py --dist_type seq2seqGAN-disc); its blob stays
    # weights-only, so the optimizers resume from a twin of their own
    d_ckpt = StateCheckpointer(os.path.join(ckpt_dir, "disc"), keep)
    opt_ckpt = StateCheckpointer(os.path.join(ckpt_dir, "gan_opt"), keep)
    gen = torch.Generator(device=device).manual_seed(a.manual_seed + 1)
    start_itr = 1
    if a.resume:
        try:
            ckpt.restore(state, "latest", generator=gen)
            start_itr = state.step + 1
            gan.bundle.load_state_dict(d_ckpt.restore("latest"))
            try:
                opts = opt_ckpt.restore("latest")
                gan.d_opt.load_state_dict(opts["d_opt"])
                gan.g_opt.load_state_dict(opts["g_opt"])
            except FileNotFoundError:
                print("--resume: no gan_opt checkpoint; G/D Adam moments "
                      "start fresh")
            print(f"resumed from iter {state.step}")
        except FileNotFoundError:
            print("--resume: no checkpoint found, starting fresh")

    logger = common.ScalarLogger(run_dir)
    stage_itr = itertools.count(start_itr)

    def stage(b):
        # phase-aware transfer on the prefetch thread: GAN iterations ship
        # img_x and the final teacher image (and the one host-picked
        # pseudo-real frame), never the whole teacher stack
        sup = next(stage_itr) % 2 == 1
        if sup:
            keep_b = {k: b[k] for k in ("x", "y", "img_x", "img_y",
                                        "gt_params")}
        else:
            keep_b = {"x": b["x"], "img_x": b["img_x"],
                      "gt_img": b["img_y"][:, -1]}
            if a.adapt_pseudo_real:
                keep_b["pseudo_real"] = last_valid_teacher(b["img_y"])
        return sup, device_put_batch(keep_b, device)

    n_left = max(a.num_iters - start_itr + 1, 0)
    it = Prefetcher(train_ds.batches(a.batch_size, n_left, shuffle=True),
                    to_device=stage, depth=2)
    keys = ("op_loss", "param_loss", "G_loss", "D_loss", "G_GAN",
            "G_GAN_Feat", "D_real", "D_fake")
    sums = {k: torch.zeros((), device=device) for k in keys}
    counts = {k: 0 for k in keys}
    tik = time.time()
    try:
        for itr, (sup, batch) in enumerate(it, start=start_itr):
            if sup:
                m = supervised_step(state, batch)
            else:
                m = gan_step(state, gan, batch, losses, generator=gen,
                             fused_exec=fused)
            for k, v in m.items():
                if k in sums:
                    sums[k] = sums[k] + v
                    counts[k] += 1
            if itr % a.print_every == 0:
                avg = {k: float(sums[k]) / counts[k] for k in keys
                       if counts[k]}
                sums = {k: torch.zeros((), device=device) for k in keys}
                counts = {k: 0 for k in keys}
                dt = (time.time() - tik) / a.print_every
                tik = time.time()
                print(f"iter {itr}/{a.num_iters} "
                      + " ".join(f"{k} {v:.3f}" for k, v in avg.items())
                      + f" {dt * 1e3:.0f} ms/it", flush=True)
                logger.log(itr, **avg)
            if itr % a.checkpoint_every == 0 or itr >= a.num_iters:
                val = evaluate(actor, val_ds, min(a.batch_size, 16), 4,
                               device, fused_exec=fused)
                logger.log(itr, val_L1=val)
                best = ckpt.save(state, itr, val, generator=gen)
                d_ckpt.save(gan.bundle.state_dict(), itr, best=best)
                opt_ckpt.save({"d_opt": gan.d_opt.state_dict(),
                               "g_opt": gan.g_opt.state_dict()}, itr)
            if itr >= a.num_iters:
                break
    finally:
        it.close()
        logger.close()
    print("GAN training done")
    return state, gan


if __name__ == "__main__":
    main()
