"""Per-operator parameter sweeps written as images (counterpart of
`t2onet_tpu.cli.op_sweep`): each operator's parameter range on one
image, the same sweeps, file names and directories.

  python -m t2onet_tpu_torch.cli.op_sweep --img photo.jpg \\
      --out_dir output/sweeps
  python -m t2onet_tpu_torch.cli.op_sweep --device cpu --img_size 64

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none. Without `--img` the input is a procedural gradient.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
import torch

from t2onet_tpu_torch.cli import common

# (executor fn key, sweep values)
SWEEPS = {
    "exposure": np.arange(-3.5, 3.6, 0.5),
    "contrast": np.linspace(-1, 1, 11),
    "brightness": np.linspace(-0.3, 0.3, 11),
    "saturation": np.linspace(-0.2, 0.8, 11),
    "bnw": [0.9],
    "sharpness": np.linspace(0, 2, 11),
    "blur": np.linspace(0, 1, 11),
    "hue": np.linspace(0, 1, 11),
    "white": [1.0],
}


def procedural_image(size: int) -> np.ndarray:
    """(1, 3, size, size) f32: the smooth gradient swept without --img."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    y, x = y / (size - 1), x / (size - 1)
    return np.clip(np.stack([0.25 + 0.5 * x, 0.3 + 0.4 * y,
                             0.35 + 0.3 * (x + y) / 2], 0), 0, 1)[None]


def sweep(img: torch.Tensor) -> List[Tuple[str, np.ndarray]]:
    """Every sweep of img (1, 3, H, W), on its device: [(path relative to
    the output directory, (3, H, W) f32 image)], in the order written."""
    from t2onet_tpu_torch.ops import operators as O
    from t2onet_tpu_torch.ops.color import tanh_range

    out = []

    def add(name, fname, edited):
        out.append((os.path.join(name, fname),
                    edited[0].detach().cpu().numpy()))

    with torch.no_grad():
        for name, values in SWEEPS.items():
            for v in values:
                p = img.new_tensor([[float(v)]])
                add(name, f"{float(v):.2f}.jpg",
                    O.mask_blend(O.OP_FNS[name](img, p), img))
        # the curve ops with random curves
        rng = np.random.default_rng(0)
        for name, k in (("tone", 8), ("color", 24)):
            for i in range(5):
                p = torch.as_tensor(rng.uniform(0.5, 2.0, (1, k))
                                    .astype(np.float32), device=img.device)
                add(name, f"{i}.jpg",
                    O.mask_blend(O.OP_FNS[name](img, p), img))
        # white-balance gains
        for i in range(5):
            feats = (rng.uniform(size=(1, 3)).astype(np.float32) - 0.5) * 3
            feats[:, 0] = 0.0
            gains = np.exp(tanh_range(-0.5, 0.5)(torch.as_tensor(
                feats, device=img.device)).cpu().numpy())
            lum = (1e-5 + 0.27 * gains[:, 0] + 0.67 * gains[:, 1]
                   + 0.06 * gains[:, 2])
            gains = torch.as_tensor(gains / lum[:, None], device=img.device)
            add("whitebalance", f"{i}.jpg",
                O.mask_blend(O.white_balance(img, gains), img))
    return out


def main(argv=None):
    """Write the sweeps; returns [(path written, image)]."""
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    p.add_argument("--out_dir", default="output/operator_analysis")
    p.add_argument("--img", default=None,
                   help="input image (procedural gradient if omitted)")
    a = p.parse_args(argv)
    device = common.resolve_device(a.device)

    from t2onet_tpu_torch.evals.visualize import save_img

    if a.img:
        from t2onet_tpu_torch.data.fivek import load_train_img

        img = load_train_img(a.img, a.img_size)[None]
    else:
        img = procedural_image(a.img_size)
    results = sweep(torch.as_tensor(img, device=device))
    written, counts = [], {}
    for rel, arr in results:
        path = os.path.join(a.out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_img(arr, path)
        written.append((path, arr))
        name = os.path.dirname(rel)
        counts[name] = counts.get(name, 0) + 1
    for name, n in counts.items():
        print(f"{name}: {n} sweeps -> {os.path.join(a.out_dir, name)}")
    return written


if __name__ == "__main__":
    main()
