"""FiveK trainer: alternating supervised / end-to-end-L1 iterations
(counterpart of `t2onet_tpu.cli.train_fivek`).

Odd iterations are teacher-forced (op NLL + param MSE), even ones a
sampled free rollout with L1 to the ground truth; one Adam over
everything; periodic validation and best-checkpoint tracking. On a CUDA
device the episode phase executes each rollout step through the fused
step kernels (`--fused_exec`, on by default there), and so does the
validation's greedy rollout. With GIER's local-edit masks
(`cli/train_gier.py --is_load_mask 1`) the episode phase blends each
step through the mask of its predicted op, and the fused step runs the
masked kernels.

Usage (synthetic, no image files needed; then the real FiveK pairs with
the planner's actions):
  python -m t2onet_tpu_torch.cli.train_fivek --synthetic --num_iters 200 \\
      --batch_size 16 --img_size 64
  python -m t2onet_tpu_torch.cli.train_fivek --data_dir data_real_h2h \\
      --act_dir data_real_h2h_acts/actions_set_1 \\
      --glove_path data_real_h2h_acts/FiveK_vocabs_glove_feat_1.npy

`--fs_only` trains the supervised phase alone (`cli/train_actor_fs.py`),
`--per_step_bn` runs the supervised phase's ResNet once per decode step,
`--episode_probe N` decodes the episode phase at N px (execution and the
L1 stay at --img_size), and `--profile_steps N` traces N steps with
torch.profiler and the host's spans (`utils.profiling`). The model's
modes are the common flags `--vis_bf16` and `--discrete_param` /
`--discrete_step`.

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU.

Data parallelism (`--data_parallel`, default 1): started by torchrun,
each process joins the group as a rank (NCCL on `cuda:{LOCAL_RANK}`,
gloo with `--device cpu`), iterates the same seeded batch order as one
process and steps on its rows of the global `--batch_size`, which the
world size must divide (`train/loop.py` keeps the step world size 1's).
Rank 0 alone prints, logs, validates and writes checkpoints; the others
wait for it. `--resume` restores on every rank.

  torchrun --standalone --nproc_per_node 8 -m \
      t2onet_tpu_torch.cli.train_fivek --synthetic --batch_size 512
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.train.checkpoint import CheckpointManager
from t2onet_tpu_torch.train.loop import (TrainState, episode_step,
                                         eval_episode, supervised_step)
from t2onet_tpu_torch.utils import profiling


def evaluate(actor, val_ds, batch_size: int, n_batches: int, device,
             fused_exec: bool = False) -> float:
    """Mean L1 of greedy rollouts over `n_batches` validation batches;
    `fused_exec` executes each step as the episode phase does."""
    dists, init_dists = [], []
    for batch in val_ds.batches(batch_size, n_batches, shuffle=False):
        b = device_put_batch({"x": batch["x"], "img_x": batch["img_x"],
                              "gt": batch["img_y"][:, -1]}, device)
        pred, _ = eval_episode(actor, b, fused_exec=fused_exec)
        dists.append(float((pred - b["gt"]).abs().mean()))
        init_dists.append(float((b["img_x"] - b["gt"]).abs().mean()))
    print(f"validation init L1 {np.mean(init_dists):.4f}  "
          f"L1 {np.mean(dists):.4f}")
    return float(np.mean(dists))


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    common.add_train_args(p)
    common.add_data_parallel_arg(p)
    p.add_argument("--fused_exec", type=int, default=-1, choices=(-1, 0, 1),
                   help="episode phase executes ops through the fused step "
                        "kernels (selected branch only, forward and "
                        "backward) instead of the one-hot bank. -1 "
                        "(default): on for a CUDA device, off on the CPU")
    p.add_argument("--wire_u8", type=int, default=1, choices=(0, 1),
                   help="file datasets ship images to the device as uint8 "
                        "and divide by 255 there (4x fewer bytes)")
    p.add_argument("--fs_only", action="store_true",
                   help="ablation: purely supervised, no episode-L1 phase "
                        "(reference experiments/t2onet-L1/train_actor_fs.py)")
    p.add_argument("--per_step_bn", action="store_true",
                   help="the reference's per-step BatchNorm statistics in "
                        "the supervised phase (one ResNet forward per "
                        "decode step; default: all steps in one forward)")
    p.add_argument("--episode_probe", type=int, default=0,
                   help="the episode rollout decodes at this probe "
                        "resolution (an antialiased bilinear view for the "
                        "vis encoder) while the ops and the L1 run at "
                        "--img_size; 0 = off")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace N steps (after 4 warm-up steps) with "
                        "torch.profiler into {run_dir}/profile, the host "
                        "spans beside it as spans.json")
    return p


def main(argv=None, parser=None):
    """Train; returns the final TrainState. `parser` defaults to
    `train_parser()` (cli/train_gier.py passes its own)."""
    a = (parser or train_parser()).parse_args(argv)
    device, joined = common.join_data_parallel(a)
    try:
        return _train(a, device)
    finally:
        if joined:
            mesh.close_data_parallel()


def _train(a, device):
    main_rank = mesh.rank() == 0
    say = common.rank0_print()
    run_dir = common.resolve_run_dir(a, record=main_rank)

    train_ds, vocab2id, _, w2v = common.build_dataset_and_vocab(
        a, "train", wire_u8=bool(a.wire_u8))
    # square validation images at the train size, so that they batch
    val_ds = common.build_dataset_and_vocab(a, "val",
                                            eval_img_mode="train_size")[0]
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    state = TrainState(actor.to(device), learning_rate=a.learning_rate)
    n_params = sum(x.numel() for x in actor.parameters())
    say(f"model: {n_params / 1e6:.2f}M params on {device}")

    ckpt = CheckpointManager(os.path.join(run_dir, "seq2seqL1_model"),
                             max_to_keep=a.max_keep_ckpts or None)
    # the episode phase's Gumbel draws; its state rides in the checkpoints
    gen = torch.Generator(device=device).manual_seed(a.manual_seed + 1)
    start_itr = 1
    if a.resume:
        try:
            ckpt.restore(state, "latest", generator=gen)
            start_itr = state.step + 1
            say(f"resumed from iter {state.step}")
        except FileNotFoundError:
            say("--resume: no checkpoint found, starting fresh")

    logger = common.ScalarLogger(run_dir, enabled=main_rank)
    # GIER local edits: the masks reach the episode phase only (the
    # supervised loss reads no executed image)
    use_masks = (bool(getattr(a, "is_load_mask", 0)) and not a.synthetic
                 and a.dataset == "GIER")
    if getattr(a, "is_load_mask", 0) and not use_masks:
        say("warning: --is_load_mask set but the dataset emits no masks: "
              "training global-only")
    fused = common.resolve_fused_exec(a.fused_exec, device)
    say(f"episode executor: "
          f"{'fused step kernels' if fused else 'one-hot bank'}")
    probe = a.episode_probe or None
    if probe:
        say(f"episode probe resolution: {probe} px (execution and L1 at "
              f"{a.img_size} px)")

    stage_itr = itertools.count(start_itr)

    def stage(b):
        # phase-aware transfer: this runs on the prefetch thread in
        # production order, so it knows each batch's phase and ships only
        # what that phase reads (the episode phase: img_x and the final
        # teacher image, not the whole img_y stack)
        sup = a.fs_only or next(stage_itr) % 2 == 1
        if sup:
            keep = {k: b[k] for k in ("x", "y", "img_x", "img_y",
                                      "gt_params")}
        else:
            keep = {"x": b["x"], "img_x": b["img_x"],
                    "gt_img": b["img_y"][:, -1]}
            if use_masks:
                keep["masks_vocab"] = b["masks_vocab"]
        return sup, device_put_batch(mesh.rows_of(keep), device)

    n_left = max(a.num_iters - start_itr + 1, 0)
    it = Prefetcher(train_ds.batches(a.batch_size, n_left, shuffle=True),
                    to_device=stage, depth=2)
    # metric sums stay on the device between prints
    keys = ("op_loss", "param_loss", "L1_loss")
    sums = {k: torch.zeros((), device=device) for k in keys}
    counts = {k: 0 for k in keys}
    tik = time.time()
    # profile window: steps prof_start..prof_stop, after both phases warm
    prof_start = start_itr + 4 if a.profile_steps and main_rank else -1
    prof_stop = prof_start + a.profile_steps - 1
    prof_dir = os.path.join(run_dir, "profile")
    prof = None
    try:
        for itr, (sup, batch) in enumerate(it, start=start_itr):
            if itr == prof_start:
                prof = profiling.trace(prof_dir)
                prof.__enter__()
            if sup:
                m = supervised_step(state, batch,
                                    per_step_bn=a.per_step_bn)
            else:
                m = episode_step(state, batch, generator=gen, sample=True,
                                 fused_exec=fused, probe_size=probe)
            for k, v in m.items():
                if k in sums:
                    sums[k] = sums[k] + v
                    counts[k] += 1
            if prof is not None and itr >= prof_stop:
                prof.__exit__(None, None, None)
                prof = None
                print(f"profile trace ({itr - prof_start + 1} steps) -> "
                      f"{prof_dir}", flush=True)

            if itr % a.print_every == 0:
                avg = {k: float(sums[k]) / max(counts[k], 1) for k in keys}
                sums = {k: torch.zeros((), device=device) for k in keys}
                counts = {k: 0 for k in keys}
                dt = (time.time() - tik) / a.print_every
                tik = time.time()
                say(f"iter {itr:6d}/{a.num_iters} op {avg['op_loss']:.3f} "
                      f"param {avg['param_loss']:.3f} L1 {avg['L1_loss']:.3f} "
                      f"{dt * 1e3:.0f} ms/it", flush=True)
                logger.log(itr, **avg)

            if (itr % a.checkpoint_every == 0 or itr >= a.num_iters) \
                    and main_rank:
                if a.val_batches > 0:
                    val = evaluate(actor, val_ds, min(a.batch_size, 16),
                                   a.val_batches, device, fused_exec=fused)
                    best = ckpt.save(state, itr, val, generator=gen)
                    logger.log(itr, val_L1=val)
                    if best:
                        print(f"best model at iter {itr} "
                              f"(val L1 {val:.4f})")
                else:
                    ckpt.save(state, itr, None, generator=gen)
            if itr % a.checkpoint_every == 0 or itr >= a.num_iters:
                mesh.barrier()      # the other ranks wait for rank 0
            if itr >= a.num_iters:
                break
    finally:
        it.close()
        logger.close()
        if prof is not None:      # the run ended inside the profile window
            prof.__exit__(None, None, None)
    say("training done")
    return state


if __name__ == "__main__":
    main()
