"""Planner CLI: pseudo ground-truth action sequences for FiveK
(counterpart of `t2onet_tpu.cli.plan_fivek`): beam 3, ops
[0,1,2,3,5,6], err 1e-2, L1 or L2 pixel distance, every candidate's
parameters fitted by one batched Adam per step on the device.

  python -m t2onet_tpu_torch.cli.plan_fivek --data_dir data_real_h2h \\
      --img_size 128 --pair_batch 8 --manual_seed 10 \\
      --out_dir data_real_h2h_acts/actions_set_1
  python -m t2onet_tpu_torch.cli.plan_fivek --synthetic --limit 8 \\
      --device cpu --out_dir output/actions_set_1

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU. The learned
distance (`--dist_type seq2seqGAN-disc` with `--disc_run_dir` or
`--torch_gan_ckpt`) waits for the GAN port (ROADMAP A5), and
`--data_parallel` for multi-GPU (A6): the parser refuses them.
"""

from __future__ import annotations

import argparse
import os

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.planner.beam import normalize_dist_type
from t2onet_tpu_torch.planner.generate import (plan_dataset,
                                               plan_dataset_batched)


def refuse(flag: str, why: str):
    """An argparse action that refuses `flag` by name, saying why."""

    class Refuse(argparse.Action):
        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{flag} {why}")

    return Refuse


def dist_type(value: str) -> str:
    """--dist_type: l1 / l2 ('L1'/'L2' accepted); the learned distance
    is refused by name."""
    if value.lower() in ("seq2seqgan-disc", "disc"):
        raise argparse.ArgumentTypeError(
            f"{value} waits for the GAN port (ROADMAP A5)")
    try:
        return normalize_dist_type(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def add_plan_args(p: argparse.ArgumentParser):
    """The flags both planner CLIs share, with the JAX CLIs' defaults."""
    p.add_argument("--phase", default="train")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--start", type=int, default=0,
                   help="first pair index (for sharding the index range)")
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--n_starts", type=int, default=2)
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--pair_batch", type=int, default=1,
                   help=">1: lockstep-batch pairs into one device fit")
    p.add_argument("--dist_type", type=dist_type, default="l1",
                   help="l1 / l2 pixel distance (reference 'L1'/'L2')")
    return p


def plan_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    add_plan_args(p)
    p.add_argument("--out_dir", default="output/actions_set_1")
    p.add_argument("--err", type=float, default=1e-2)
    p.add_argument("--mode", default="plain",
                   choices=["plain", "eps", "fixed"])
    for flag in ("--disc_run_dir", "--torch_gan_ckpt"):
        p.add_argument(flag, action=refuse(
            flag, "(the learned planner distance) waits for the GAN port "
                  "(ROADMAP A5)"))
    p.add_argument("--data_parallel", action=refuse(
        "--data_parallel", "waits for the multi-GPU port (ROADMAP A6)"))
    return p


def main(argv=None):
    """Plan; returns the number of pairs written."""
    a = plan_parser().parse_args(argv)
    device = common.resolve_device(a.device)

    if a.synthetic:
        ds = common.build_dataset_and_vocab(a, a.phase)[0]

        def pairs():
            for i in range(a.start, len(ds)):
                img, imgs, _, _, _, req = ds.make_item(i)
                yield img[None], imgs[-1][None], req
    else:
        # planning comes before the actions exist: the plain pair reader,
        # every split at train_size, so that every fit has one shape
        from t2onet_tpu_torch.data.fivek import FiveK

        ds = FiveK(os.path.join(a.data_dir, "FiveK", "images"),
                   os.path.join(a.data_dir, "FiveK", "annotations"),
                   a.phase, a.session, a.img_size,
                   eval_img_mode="train_size")

        def pairs():
            for i in range(a.start, len(ds)):
                img_x, img_y, _, req = ds[i]
                yield img_x[None], img_y[None], req

    kw = dict(beam_size=a.beam_size, err=a.err, mode=a.mode,
              n_starts=a.n_starts, n_iters=a.n_iters, lr=a.lr,
              seed=a.manual_seed, dist_type=a.dist_type, device=device)
    if a.pair_batch > 1:
        return plan_dataset_batched(pairs(), a.out_dir, phase=a.phase,
                                    pair_batch=a.pair_batch, limit=a.limit,
                                    start_index=a.start, **kw)
    return plan_dataset(pairs(), a.out_dir, phase=a.phase, limit=a.limit,
                        start_index=a.start, **kw)


if __name__ == "__main__":
    main()
