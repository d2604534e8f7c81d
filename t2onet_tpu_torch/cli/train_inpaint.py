"""Train the first-party inpainting filler of the inpaint operator slot
(counterpart of `t2onet_tpu.cli.train_inpaint`): self-supervised
reconstruction of images through random free-form holes.

  python -m t2onet_tpu_torch.cli.train_inpaint --synthetic \\
      --num_iters 500 --batch_size 8 --img_size 64

The weights go to {run_dir}/inpaint_model (`models.inpaint.save_inpaint`)
every --checkpoint_every iterations and at the end; then the hole's L1
and PSNR on held-out images (the val split, fresh masks) with the filler
against the blanked hole. The held-out batches are four distinct ones,
drawn from one iterator: the JAX CLI draws its first batch four times.

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from t2onet_tpu_torch.cli import common

N_EVAL = 4


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    common.add_base_args(p)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_iters", type=int, default=2000)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--print_every", type=int, default=50)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--features", type=int, default=32)
    return p


def held_out_batches(eval_ds, batch_size: int, n: int = N_EVAL):
    """n distinct shuffled batches of eval_ds, from one iterator."""
    return list(eval_ds.batches(batch_size=batch_size, steps=n,
                                shuffle=True))


@torch.no_grad()
def hole_metrics(net, batches, rng, device) -> dict:
    """Mean over the batches of the hole's L1 and MSE per channel, the
    filled hole (composed) against the blanked one, and their PSNR."""
    from t2onet_tpu_torch.models.inpaint import (compose,
                                                 random_freeform_masks)

    net.eval()
    tot = {"l1_b": 0.0, "l1_a": 0.0, "mse_b": 0.0, "mse_a": 0.0}
    for b in batches:
        img = torch.from_numpy(np.asarray(b["img_x"], np.float32)).to(device)
        mask = torch.from_numpy(random_freeform_masks(
            rng, img.shape[0], img.shape[2], img.shape[3])).to(device)
        pred = compose(net(img, mask), img, mask)
        holed = img * (1.0 - mask)
        denom = mask.sum() * 3 + 1e-8
        tot["l1_b"] += float((torch.abs(holed - img) * mask).sum() / denom)
        tot["l1_a"] += float((torch.abs(pred - img) * mask).sum() / denom)
        tot["mse_b"] += float(((holed - img) ** 2 * mask).sum() / denom)
        tot["mse_a"] += float(((pred - img) ** 2 * mask).sum() / denom)
    n = len(batches)
    return {"hole_l1": tot["l1_a"] / n, "hole_l1_blank": tot["l1_b"] / n,
            "hole_psnr": float(10 * np.log10(
                1.0 / max(tot["mse_a"] / n, 1e-10))),
            "hole_psnr_blank": float(10 * np.log10(
                1.0 / max(tot["mse_b"] / n, 1e-10)))}


def main(argv=None):
    """Returns (the trained InpaintNet, the held-out metrics)."""
    a = build_parser().parse_args(argv)
    device = common.resolve_device(a.device)

    from t2onet_tpu_torch.models.inpaint import (InpaintNet,
                                                 make_train_step,
                                                 random_freeform_masks,
                                                 save_inpaint)

    run_dir = common.resolve_run_dir(a)
    ckpt_dir = os.path.join(run_dir, "inpaint_model")
    logger = common.ScalarLogger(run_dir, name="inpaint")

    ds, _, _, _ = common.build_dataset_and_vocab(a, phase="train")
    rng = np.random.default_rng(a.manual_seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(a.manual_seed)
        net = InpaintNet(features=a.features).to(device)
    opt = torch.optim.Adam(net.parameters(), lr=a.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(net, opt)

    t0, avg = time.time(), None
    for itr, b in enumerate(ds.batches(batch_size=a.batch_size,
                                       steps=a.num_iters, shuffle=True),
                            start=1):
        img = torch.from_numpy(np.asarray(b["img_x"], np.float32)).to(device)
        mask = torch.from_numpy(random_freeform_masks(
            rng, img.shape[0], img.shape[2], img.shape[3])).to(device)
        loss = float(step(img, mask))
        avg = loss if avg is None else 0.95 * avg + 0.05 * loss
        if itr % a.print_every == 0:
            dt = (time.time() - t0) / itr
            print(f"iter {itr}/{a.num_iters} loss {avg:.4f} "
                  f"({dt * 1e3:.0f} ms/it)", flush=True)
            logger.log(itr, inpaint_loss=avg)
        if itr % a.checkpoint_every == 0 or itr == a.num_iters:
            save_inpaint(ckpt_dir, net)

    try:
        eval_ds, _, _, _ = common.build_dataset_and_vocab(a, phase="val")
    except (FileNotFoundError, KeyError):
        eval_ds = ds                      # workspaces without a val split
    m = hole_metrics(net, held_out_batches(eval_ds, a.batch_size), rng,
                     device)
    print(f"hole L1: {m['hole_l1_blank']:.4f} (blanked) -> "
          f"{m['hole_l1']:.4f} (filled)  hole PSNR: "
          f"{m['hole_psnr_blank']:.2f} dB -> {m['hole_psnr']:.2f} dB  "
          f"({N_EVAL}x{a.batch_size} held-out images)")
    logger.log(a.num_iters, **m)
    logger.close()
    print(f"saved {ckpt_dir}")
    return net, m


if __name__ == "__main__":
    main()
