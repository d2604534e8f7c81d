"""Shape buckets for variable-resolution images, as in
`t2onet_tpu.evals.bucketing`: each image is edge-padded up to a multiple
of `quantum` so that a batch of one bucket stacks into one tensor, and
metrics read back only the valid region (`crop_valid`, `masked_l1`).
An image larger than `max_side` is downscaled first (`fit_within`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bucket_shape(h: int, w: int, quantum: int = 64,
                 max_side: int = 1024) -> Tuple[int, int]:
    def up(x):
        return min(int(np.ceil(x / quantum)) * quantum, max_side)

    return up(h), up(w)


def pad_to_bucket(img_chw: np.ndarray, quantum: int = 64,
                  max_side: int = 1024):
    """(3, h, w) -> (3, H, W) edge-padded, and the valid (h, w).
    Raises on an image larger than max_side: resize it first."""
    _, h, w = img_chw.shape
    if h > max_side or w > max_side:
        raise ValueError(
            f"image {h}x{w} exceeds max_side={max_side}; resize it first "
            "instead of cropping")
    hb, wb = bucket_shape(h, w, quantum, max_side)
    out = np.pad(img_chw, ((0, 0), (0, hb - h), (0, wb - w)), mode="edge")
    return out, (h, w)


def fit_within(img_chw: np.ndarray, max_side: int = 1024) -> np.ndarray:
    """Downscale (3, h, w) f32 so that its long side fits max_side (aspect
    kept, cv2's bilinear INTER_LINEAR on f32); the input unchanged when it
    already fits."""
    _, h, w = img_chw.shape
    if max(h, w) <= max_side:
        return img_chw
    import cv2

    scale = max_side / max(h, w)
    oh, ow = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    hwc = np.ascontiguousarray(np.moveaxis(img_chw, 0, -1), np.float32)
    out = cv2.resize(hwc, (ow, oh), interpolation=cv2.INTER_LINEAR)
    return np.moveaxis(out, -1, 0)


def crop_valid(img, valid_hw):
    """The valid (h, w) corner of a padded (..., H, W) image."""
    h, w = valid_hw
    return img[..., :h, :w]


def masked_l1(a, b, valid_hw) -> float:
    """Mean |a - b| over the valid (h, w) corner, in f32."""
    a, b = (torch.as_tensor(crop_valid(v, valid_hw)) for v in (a, b))
    return float((a - b).abs().mean())
