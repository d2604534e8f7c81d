"""Shape buckets for variable-resolution images, as in
`t2onet_tpu.evals.bucketing`: each image is edge-padded up to a multiple
of `quantum` so that a batch of one bucket stacks into one tensor."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
