"""Train a filler of the inpaint operator slot: `--backend gated` (the
default) is the first-party gated-conv InpaintNet (counterpart of
`t2onet_tpu.cli.train_inpaint`), self-supervised reconstruction of images
through random free-form holes; `--backend edgeconnect` is EdgeConnect's
inpainting stage (its MODEL 3: the edge G as inference, the inpaint G and
its discriminator trained; `train.edgeconnect`).

  python -m t2onet_tpu_torch.cli.train_inpaint --synthetic \\
      --num_iters 500 --batch_size 8 --img_size 64
  python -m t2onet_tpu_torch train-inpaint --backend edgeconnect \\
      --dataset GIER --data_dir data_real_gier ... --vgg_ckpt vgg19.pth

Gated: the weights go to {run_dir}/inpaint_model
(`models.inpaint.save_inpaint`). EdgeConnect: EdgeConnect's
`EdgeModel_gen.pth`, `InpaintingModel_gen.pth` and
`InpaintingModel_dis.pth` go to {run_dir}/edgeconnect_model, the
directory `plan_gier --edgeconnect_dir` and `demo --edgeconnect_dir`
take. EdgeConnect's defaults: images resized to 256 (--img_size), batch
8, Adam lr 1e-4 with betas (0.0, 0.9), D at a tenth of it; masks are
EdgeConnect's MASK 4 drawn from --manual_seed, even odds of a random
block of half the side and an external mask, here one of 64 free-form
masks (`models.inpaint.random_freeform_masks`) standing in for its
irregular mask set. --edgeconnect_dir starts the edge G from that
directory's `EdgeModel_gen.pth`, --vgg_ckpt (a torchvision vgg19 .pth)
gives the perceptual and style losses their VGG19; without them the
networks are drawn with EdgeConnect's init (normal, std 0.02) from
--manual_seed. Batches are staged on the device by `Prefetcher`; the
edges are made in the step, on the card.

Either writes every --checkpoint_every iterations and at the end; then
the hole's L1 and PSNR on held-out images (the val split, fresh masks)
with the filler against the blanked hole. The held-out batches are four
distinct ones, drawn from one iterator: the JAX CLI draws its first batch
four times.

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
N_EXTERNAL_MASKS = 64
# (img_size, batch_size, learning_rate) when the flags leave them out
DEFAULTS = {"gated": (128, 16, 2e-4), "edgeconnect": (256, 8, 1e-4)}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    common.add_base_args(p)
    p.add_argument("--backend", choices=tuple(DEFAULTS), default="gated")
    p.add_argument("--batch_size", type=int, default=None,
                   help="default 16 (gated), 8 (edgeconnect)")
    p.add_argument("--num_iters", type=int, default=2000)
    p.add_argument("--learning_rate", type=float, default=None,
                   help="default 2e-4 (gated), 1e-4 (edgeconnect)")
    p.add_argument("--print_every", type=int, default=50)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--edgeconnect_dir", default=None,
                   help="edgeconnect: start the edge G from this "
                        "directory's EdgeModel_gen.pth")
    p.add_argument("--vgg_ckpt", default=None,
                   help="edgeconnect: torchvision vgg19 .pth for the "
                        "perceptual and style losses")
    p.set_defaults(img_size=None)
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


class _EdgeConnectFiller(torch.nn.Module):
    """net(img, mask) -> the inpaint G's fill, as `hole_metrics` calls a
    filler: EdgeConnect's test path, the nets in eval mode."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def forward(self, img, mask):
        from t2onet_tpu_torch.train.edgeconnect import composed_edges

        st = self.state
        for net in (st.edge_g, st.inpaint_g):
            net.eval()
        edges = composed_edges(st, img, mask)
        return st.inpaint_g(torch.cat([img * (1 - mask) + mask, edges], 1))


def train_edgeconnect(a, ds, device, run_dir, logger):
    """EdgeConnect's inpainting stage over `ds`' images; returns (the
    `EdgeConnectState`, the checkpoint directory)."""
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.models.inpaint import random_freeform_masks
    from t2onet_tpu_torch.models.vgg import torchvision_vgg19_features
    from t2onet_tpu_torch.train import edgeconnect as ec

    edge_g, inpaint_g, disc, vgg = ec.build_networks(a.manual_seed)
    if a.edgeconnect_dir:
        sd = torch.load(os.path.join(a.edgeconnect_dir, ec.CHECKPOINTS[0]),
                        map_location="cpu", weights_only=True)
        edge_g.load_state_dict(sd["generator"])
    if a.vgg_ckpt:
        vgg.load_state_dict(torchvision_vgg19_features(
            torch.load(a.vgg_ckpt, map_location="cpu", weights_only=True),
            ec.VGG_END))
    else:
        print("no --vgg_ckpt: the perceptual and style losses read a VGG19 "
              "drawn from the seed", flush=True)
    state = ec.EdgeConnectState(edge_g.to(device), inpaint_g.to(device),
                                disc.to(device), vgg.to(device),
                                lr=a.learning_rate)
    rng = np.random.default_rng(a.manual_seed)
    external = random_freeform_masks(rng, N_EXTERNAL_MASKS, a.img_size,
                                     a.img_size)[:, 0]

    def batches():
        for b in ds.batches(batch_size=a.batch_size, steps=a.num_iters,
                            shuffle=True):
            img = np.asarray(b["img_x"], np.float32)
            yield {"images": img, "masks": ec.mask4(rng, img.shape[0],
                                                    a.img_size, external)}

    ckpt_dir = os.path.join(run_dir, "edgeconnect_model")
    t0, avg = time.time(), None
    with Prefetcher(batches(), depth=2,
                    to_device=lambda b: device_put_batch(b, device)) as it:
        for itr, batch in enumerate(it, start=1):
            got = ec.edgeconnect_inpaint_step(state, batch)
            m = dict(zip(got, torch.stack(list(got.values())).tolist()))
            if not all(np.isfinite(v) for v in m.values()):
                raise FloatingPointError(f"iteration {itr}: losses {m}")
            avg = m if avg is None else {k: 0.95 * avg[k] + 0.05 * v
                                         for k, v in m.items()}
            if itr % a.print_every == 0:
                dt = (time.time() - t0) / itr
                print(f"iter {itr}/{a.num_iters} G {avg['G_loss']:.4f} "
                      f"(adv {avg['G_adv']:.4f} l1 {avg['G_l1']:.4f} content "
                      f"{avg['G_content']:.4g} style {avg['G_style']:.4g}) "
                      f"D {avg['D_loss']:.4f} ({dt * 1e3:.0f} ms/it)",
                      flush=True)
                logger.log(itr, **{f"edgeconnect_{k}": v
                                   for k, v in avg.items()})
            if itr % a.checkpoint_every == 0 or itr == a.num_iters:
                ec.save_edgeconnect(ckpt_dir, state, itr)
    return state, ckpt_dir


def parse_args(argv=None):
    """The flags, the backend's `DEFAULTS` where they are left out."""
    a = build_parser().parse_args(argv)
    size, batch, lr = DEFAULTS[a.backend]
    a.img_size = a.img_size or size
    a.batch_size = a.batch_size or batch
    a.learning_rate = a.learning_rate or lr
    return a


def main(argv=None):
    """Returns (the trained filler: an InpaintNet, or EdgeConnect's
    `EdgeConnectState`; the held-out metrics)."""
    a = parse_args(argv)
    device = common.resolve_device(a.device)
    if a.backend == "edgeconnect":
        return _main_edgeconnect(a, device)

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

    m = _held_out(a, ds, net, rng, device, logger)
    print(f"saved {ckpt_dir}")
    return net, m


def _held_out(a, ds, net, rng, device, logger):
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
    return m


def _main_edgeconnect(a, device):
    run_dir = common.resolve_run_dir(a)
    logger = common.ScalarLogger(run_dir, name="inpaint")
    ds, _, _, _ = common.build_dataset_and_vocab(a, phase="train")
    state, ckpt_dir = train_edgeconnect(a, ds, device, run_dir, logger)
    m = _held_out(a, ds, _EdgeConnectFiller(state),
                  np.random.default_rng(a.manual_seed + 1), device, logger)
    print(f"saved {ckpt_dir}")
    return state, m


if __name__ == "__main__":
    main()
