"""COCO RLE masks and the nearest-neighbour resize that GIER's local-edit
masks go through (copies of `t2onet_tpu.data.rle` and of
`t2onet_tpu.native.resize_nearest`'s semantics, in numpy; held equal to
them by a test).

RLE counts alternate zeros and ones, starting with zeros, and unroll the
mask column-major. A string of counts is pycocotools' compressed form:
5 bits a character, offset 48, bit 5 the continuation, sign-extended, and
every count from the fourth on delta-encoded against the count two back.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _counts_from_string(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)      # sign extension
        if len(counts) > 2:
            x += counts[-2]             # delta against the count two back
        counts.append(x)
    return np.asarray(counts, np.int64)


def rle_decode(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|list} -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_from_string(counts)
    else:
        counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape((w, h)).T.copy()


def rle_encode(mask: np.ndarray) -> Dict:
    """(h, w) {0,1} mask -> uncompressed RLE dict (counts list)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def resize_nearest(mask: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(h, w) uint8 -> (oh, ow), cv2.INTER_NEAREST: the source index of
    output row y is int(y * (1 / (oh / h))) in double, capped at h - 1
    (1/(oh/h), not h/oh: at exact integer products the two land on
    different rows, e.g. 14 -> 18 row 9)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    ys = np.minimum((np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return np.ascontiguousarray(mask[ys[:, None], xs[None, :]])
