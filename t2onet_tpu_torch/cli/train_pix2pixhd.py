"""Train pix2pixHD on FiveK's image pairs: the LocalEnhancer G, the
multiscale instance-norm PatchGAN D and the VGG19 loss
(`train.pix2pixhd`), at pix2pixHD's 2048x1024 recipe
(NVIDIA/pix2pixHD `scripts/train_1024p_24G.sh`: `--netG local --ngf 32
--num_D 3`, every other option at its default; `train.pix2pixhd`'s
`G_OPTIONS` and `D_OPTIONS`, at `SIZE`).

  python -m t2onet_tpu_torch train-pix2pixhd --data_dir data_real_h2h \\
      --num_iters 2000 --vgg_ckpt vgg19.pth

The input is a FiveK photo and the target its expert's retouch (the
annotations' `input` and `output`), each resized by the FiveK reader to
2048x1024, one pair a batch, in an order drawn from --manual_seed, each
pair flipped horizontally with even odds. Batches are staged on the
device by `Prefetcher`. The networks are drawn with
pix2pixHD's init from --manual_seed; --vgg_ckpt (a torchvision vgg19
.pth) gives the VGG loss its VGG19, else it reads one drawn from the
seed. Adam: lr 2e-4, betas (0.5, 0.999), for G and for D.

The weights go to {run_dir}/pix2pixhd_model as pix2pixHD's
`latest_net_G.pth` and `latest_net_D.pth` every --checkpoint_every
iterations and at the end. Then the L1 of G's output against the target
on --eval_pairs held-out pairs (the val split), in [0, 1], beside the
input's own L1 against the target.

It runs on the card (`--device cuda`, the default, f32 with TF32 off)
and raises where PyTorch finds none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.train import pix2pixhd as P

SIZE = (1024, 2048)              # (height, width) of the 1024p recipe


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default), cuda:N or cpu")
    p.add_argument("--data_dir", default="data",
                   help="root holding FiveK/images and FiveK/annotations")
    p.add_argument("--session", type=int, default=1)
    p.add_argument("--run_dir", default="output/pix2pixhd")
    p.add_argument("--manual_seed", type=int, default=10)
    p.add_argument("--num_iters", type=int, default=2000)
    p.add_argument("--vgg_ckpt", default=None,
                   help="torchvision vgg19 .pth for the VGG loss")
    p.add_argument("--print_every", type=int, default=50)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--eval_pairs", type=int, default=4)
    return p


def load_pairs(a, phase: str, limit=None):
    """(inputs, targets) of a FiveK split, (N, 3, H, W) uint8, read by
    `data.fivek.load_train_img` at `SIZE`."""
    from t2onet_tpu_torch.data.fivek import load_train_img

    root = os.path.join(a.data_dir, "FiveK")
    with open(os.path.join(root, "annotations",
                           f"{phase}_sess_{a.session}.json")) as f:
        pairs = json.load(f)[:limit]

    def read(name):
        return load_train_img(os.path.join(root, "images", name), SIZE,
                              np.uint8)

    return (np.stack([read(d["input"]) for d in pairs]),
            np.stack([read(d["output"]) for d in pairs]))


@torch.no_grad()
def held_out_l1(state, inputs, targets, device) -> dict:
    """Mean L1 over the pairs, in [0, 1], of G's output against the target
    and of the input against the target."""
    state.gen.eval()
    out, base = 0.0, 0.0
    for x, y in zip(inputs, targets):
        x = torch.from_numpy(x[None]).to(device).float() / 255.0
        y = torch.from_numpy(y[None]).to(device).float() / 255.0
        fake = (state.gen(P.normalize(x)) + 1.0) / 2.0
        out += float((fake - y).abs().mean())
        base += float((x - y).abs().mean())
    n = len(inputs)
    return {"l1": out / n, "l1_input": base / n}


def main(argv=None):
    """Returns (the `Pix2PixHDState`, the held-out metrics)."""
    from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
    from t2onet_tpu_torch.models.vgg import torchvision_vgg19_features

    a = build_parser().parse_args(argv)
    device = common.resolve_device(a.device)
    run_dir = common.resolve_run_dir(a)
    logger = common.ScalarLogger(run_dir, name="pix2pixhd")
    gen, disc, vgg = P.build_networks(a.manual_seed)
    if a.vgg_ckpt:
        vgg.load_state_dict(torchvision_vgg19_features(
            torch.load(a.vgg_ckpt, map_location="cpu", weights_only=True)))
    else:
        print("no --vgg_ckpt: the VGG loss reads a VGG19 drawn from the "
              "seed", flush=True)
    state = P.Pix2PixHDState(gen.to(device), disc.to(device), vgg.to(device))
    inputs, targets = load_pairs(a, "train")
    print(f"{len(inputs)} training pairs at {SIZE[0]}x{SIZE[1]}",
          flush=True)
    rng = np.random.default_rng(a.manual_seed)

    def batches():
        pairs = P.pair_batches(inputs, targets, rng)
        for _ in range(a.num_iters):
            yield next(pairs)

    ckpt_dir = os.path.join(run_dir, "pix2pixhd_model")
    t0, avg = time.time(), None
    with Prefetcher(batches(), depth=2,
                    to_device=lambda b: device_put_batch(b, device)) as it:
        for itr, batch in enumerate(it, start=1):
            got = P.pix2pixhd_step(state, batch)
            m = dict(zip(got, torch.stack(list(got.values())).tolist()))
            if not all(np.isfinite(v) for v in m.values()):
                raise FloatingPointError(f"iteration {itr}: losses {m}")
            avg = m if avg is None else {k: 0.95 * avg[k] + 0.05 * v
                                         for k, v in m.items()}
            if itr % a.print_every == 0:
                dt = (time.time() - t0) / itr
                print(f"iter {itr}/{a.num_iters} G {avg['G_loss']:.4f} "
                      f"(GAN {avg['G_GAN']:.4f} feat {avg['G_GAN_Feat']:.4f} "
                      f"VGG {avg['G_VGG']:.4f}) D {avg['D_loss']:.4f} "
                      f"(real {avg['D_real']:.4f} fake {avg['D_fake']:.4f}) "
                      f"({dt * 1e3:.0f} ms/it)", flush=True)
                logger.log(itr, **{f"pix2pixhd_{k}": v
                                   for k, v in avg.items()})
            if itr % a.checkpoint_every == 0 or itr == a.num_iters:
                P.save_pix2pixhd(ckpt_dir, state)
    val_x, val_y = load_pairs(a, "val", a.eval_pairs)
    m = held_out_l1(state, val_x, val_y, device)
    print(f"held-out L1 ({len(val_x)} val pairs, [0, 1]): {m['l1']:.4f} "
          f"(the input's {m['l1_input']:.4f})")
    logger.log(a.num_iters, **{f"val_{k}": v for k, v in m.items()})
    logger.close()
    print(f"saved {ckpt_dir}")
    return state, m


if __name__ == "__main__":
    main()
