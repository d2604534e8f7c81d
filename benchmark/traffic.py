"""The benchmark's one traffic generator, read by every serving mix.

A mix is a JSON file under `benchmark/traffic/` (see `load_mix`). From it
and the run's seed this module makes:

- the images: a pool for each aspect ratio, each image a gradient plus
  uniform noise (the serving CLI's synthetic request image), quantised to
  8 bits, at the mix's long side;
- the requests: texts drawn uniformly from a committed annotation file;
- the schedule: for an open loop, the due time of every request. Every
  seed gets the same multiset of gaps (the quantiles of an exponential
  distribution at the mix's rate, scaled to fill the window exactly) and
  the same multiset of aspect ratios, each in its own order; a closed
  loop sends in the same way with no times.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np


def make_image(h: int, w: int, rng) -> np.ndarray:
    """(3, h, w) uint8: a gradient plus noise in [-0.2, 0.2], clipped,
    quantised to 8 bits."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y, x = y / max(h - 1, 1), x / max(w - 1, 1)
    base = np.stack([x, y, 0.5 * (x + y)], 0)
    img = np.clip(base + rng.uniform(-0.2, 0.2, (3, h, w))
                  .astype(np.float32), 0, 1)
    return np.round(img * 255.0).astype(np.uint8)


def aspect_shape(long_side: int, aspect) -> tuple:
    """(h, w) of an image whose width:height is aspect[0]:aspect[1] and
    whose long side is `long_side`."""
    aw, ah = aspect
    if aw >= ah:
        return int(round(long_side * ah / aw)), long_side
    return long_side, int(round(long_side * aw / ah))


def request_texts(path: str):
    with open(path) as f:
        return [d["request"] for d in json.load(f)]


class Traffic:
    """The requests of one run: `images[a]` the uint8 pool of aspect a,
    `images_f32[a]` the same /255 as the engine takes them, and
    `requests`: a list of (due_s or None, aspect, image index, text)."""

    def __init__(self, mix: dict, root: str, seed: int, seconds: float):
        rng = np.random.default_rng(seed)
        aspects = [tuple(a) for a in mix["aspects"]]
        n_pool = mix["images_per_aspect"]
        self.shapes = [aspect_shape(mix["long_side"], a) for a in aspects]
        self.images = [[make_image(h, w, rng) for _ in range(n_pool)]
                       for h, w in self.shapes]
        self.images_f32 = [[im.astype(np.float32) / np.float32(255.0)
                            for im in pool] for pool in self.images]
        texts = request_texts(os.path.join(root, mix["requests"]))
        if mix["loop"] == "open":
            n = int(round(mix["rate_per_s"] * seconds))
            gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate_per_s"]
            gaps = rng.permutation(gaps) * (seconds / gaps.sum())
            due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        else:
            n = mix["requests_per_run"]
            due = [None] * n
        which = rng.permutation(np.arange(n) % len(aspects))
        pick = rng.integers(0, n_pool, n)
        text = rng.integers(0, len(texts), n)
        self.requests = [(None if due[i] is None else float(due[i]),
                          int(which[i]), int(pick[i]), texts[int(text[i])])
                         for i in range(n)]

    def image(self, i: int) -> np.ndarray:
        _, a, k, _ = self.requests[i]
        return self.images[a][k]

    def image_f32(self, i: int) -> np.ndarray:
        _, a, k, _ = self.requests[i]
        return self.images_f32[a][k]


def quantile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation (inf stays
    inf)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]):
        return v[hi] if pos > lo else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
