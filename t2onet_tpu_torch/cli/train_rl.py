"""RL fine-tuning trainer (counterpart of `t2onet_tpu.cli.train_rl`): a
supervised warmup of `--warmup` iterations, then `--num_iters` RL
iterations (REINFORCE over the ops, the pathwise L1 through the executed
ops, the entropy penalty; `train/rl.py`). The RL rollout samples on
policy (explore_prob defaults to 0 here), with `--param_noise` on the
parameters, and executes through the bank as the JAX trainer's does, so
it launches no kernel; the validation's greedy rollout
(`train_fivek.evaluate`) runs the chain kernel on a CUDA device.
Checkpoints go to {run_dir}/seq2seqRL_model and hold the sampling
generator's state, which `--resume` restores.

  python -m t2onet_tpu_torch.cli.train_rl --synthetic --warmup 200 \\
      --num_iters 1000 --batch_size 16 --img_size 64

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU. `--data_parallel`
under torchrun as `cli.train_fivek`'s: each rank steps on its rows of
the global batch, with the global baseline and spread (`train/rl.py`);
rank 0 alone prints, logs, validates and writes checkpoints.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.cli.train_fivek import evaluate
from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.train import rl
from t2onet_tpu_torch.train.checkpoint import CheckpointManager
from t2onet_tpu_torch.train.loop import TrainState, supervised_step


def train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_base_args(p)
    common.add_train_args(p)
    common.add_data_parallel_arg(p)
    p.add_argument("--warmup", type=int, default=200,
                   help="supervised warmup iterations before RL")
    # the JAX CLI's 0.01, not the reference flag's 0.05: at 0.05 the pull
    # towards uniform op choices overpowered the REINFORCE signal there
    p.add_argument("--entropy_factor", type=float,
                   default=rl.ENTROPY_FACTOR)
    p.add_argument("--param_noise", type=float, default=0.0,
                   help="exploration noise on op params (the reference's "
                        "param_noise_factor is 0.6; 0 = off)")
    p.add_argument("--pg_weight", type=float, default=rl.PG_WEIGHT,
                   help="weight of the REINFORCE op-choice term against "
                        "the pathwise L1")
    # on policy: REINFORCE scores the sampled ops under the model's own
    # log-probs, so the rollout draws from the model's softmax
    p.set_defaults(explore_prob=0.0)
    return p


def main(argv=None):
    """Train; returns the final TrainState."""
    a = train_parser().parse_args(argv)
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
    train_ds, vocab2id, _, w2v = common.build_dataset_and_vocab(a, "train")
    val_ds = common.build_dataset_and_vocab(a, "val",
                                            eval_img_mode="train_size")[0]
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    state = TrainState(actor.to(device), learning_rate=a.learning_rate)

    ckpt = CheckpointManager(os.path.join(run_dir, "seq2seqRL_model"),
                             max_to_keep=a.max_keep_ckpts or None)
    gen = torch.Generator(device=device).manual_seed(a.manual_seed + 1)
    start_itr = 1
    if a.resume:
        try:
            ckpt.restore(state, "latest", generator=gen)
            start_itr = state.step + 1
            say(f"resumed from iter {state.step}")
        except FileNotFoundError:
            say("--resume: no checkpoint found, starting fresh")

    logger = common.ScalarLogger(run_dir, name="rl_metrics",
                                 enabled=main_rank)
    fused = common.resolve_fused_exec(-1, device)
    total = a.warmup + a.num_iters
    stage_itr = itertools.count(start_itr)

    def stage(b):
        # the warmup ships what the supervised step reads, RL its three
        warm = next(stage_itr) <= a.warmup
        keep = ({k: b[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
                if warm else {"x": b["x"], "img_x": b["img_x"],
                              "gt_img": b["img_y"][:, -1]})
        return warm, device_put_batch(mesh.rows_of(keep), device)

    n_left = max(total - start_itr + 1, 0)
    it = Prefetcher(train_ds.batches(a.batch_size, n_left, shuffle=True),
                    to_device=stage, depth=2)
    # metric sums stay on the device between prints
    sums, counts, tik = {}, {}, time.time()
    try:
        for itr, (warm, batch) in enumerate(it, start=start_itr):
            if warm:
                m = supervised_step(state, batch)
            else:
                m = rl.rl_step(state, batch, gen,
                               entropy_factor=a.entropy_factor,
                               param_noise=a.param_noise,
                               pg_weight=a.pg_weight)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1

            if itr % a.print_every == 0:
                avg = {k: float(sums[k]) / counts[k] for k in sums}
                sums, counts = {}, {}
                dt = (time.time() - tik) / a.print_every
                tik = time.time()
                line = " ".join(f"{k} {v:.4f}" for k, v in sorted(avg.items()))
                say(f"iter {itr:6d}/{total} "
                      f"[{'warmup' if warm else 'rl'}] {line} "
                      f"{dt * 1e3:.0f} ms/it", flush=True)
                logger.log(itr, **avg)

            if (itr % a.checkpoint_every == 0 or itr >= total) and main_rank:
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
            if itr % a.checkpoint_every == 0 or itr >= total:
                mesh.barrier()      # the other ranks wait for rank 0
            if itr >= total:
                break
    finally:
        it.close()
        logger.close()
    say("training done")
    return state


if __name__ == "__main__":
    main()
