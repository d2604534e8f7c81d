"""The training pool held to a decode of the benchmark's own.

The system's readers fill the training cells' host pool, and both the
system and the reference are fed from it, so a fault in those readers
would show on both sides. Here a sample of the pool's items, drawn from
the seed, is decoded again without them: each image read by OpenCV and
resized to the training size as T2ONet's loaders resize it
(`cv2.resize`, bilinear), each GIER mask decoded from its COCO RLE by
`rle_mask` below, resized nearest by OpenCV and unioned over the op's
instances. `pool_off` counts the values that differ: images, planned
step images (zeros past the planned steps), and masks by op id.

Only the index (which files and mask ids make an item) comes from the
system's dataset object.
"""

from __future__ import annotations

import json
import os

import numpy as np

SAMPLE = 8                    # items checked, half with masks where any


def read_image(path: str, size: int) -> np.ndarray:
    """(3, size, size) uint8 RGB."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    return np.ascontiguousarray(img[:, :, ::-1].transpose(2, 0, 1))


def rle_counts(counts) -> list:
    """The run lengths of a COCO RLE: a list as it is, or pycocotools'
    string form (6-bit groups from '0', 5 value bits, bit 5 continues,
    the last group's bit 4 the sign; from the third count on, each is
    stored as its difference to the count two before)."""
    if not isinstance(counts, str):
        return [int(c) for c in counts]
    out, pos = [], 0
    while pos < len(counts):
        value, shift = 0, 0
        while True:
            group = ord(counts[pos]) - 48
            pos += 1
            value |= (group & 31) << shift
            shift += 5
            if not group & 32:
                if group & 16:
                    value -= 1 << shift
                break
        if len(out) > 2:
            value += out[-2]
        out.append(value)
    return out


def rle_mask(rle: dict) -> np.ndarray:
    """(h, w) uint8 of a COCO RLE (runs of 0, 1, 0, ... down the columns)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    at = 0
    for k, n in enumerate(rle_counts(rle["counts"])):
        if k % 2:
            flat[at:at + n] = 1
        at += n
    if at != h * w:
        raise ValueError(f"RLE covers {at} of {h * w} pixels")
    return flat.reshape(w, h).T


def union_mask(path: str, ids, size: int) -> np.ndarray:
    import cv2

    with open(path) as f:
        rles = json.load(f)
    out = np.zeros((size, size), np.uint8)
    for i in np.atleast_1d(np.asarray(ids, int)):
        m = cv2.resize(rle_mask(rles[int(i)]), (size, size),
                       interpolation=cv2.INTER_NEAREST)
        out |= (m > 0).astype(np.uint8)
    return out


def _steps(ops) -> int:
    """Planned steps of an op sequence [START, ops..., END, NONE...]."""
    n = 0
    for o in list(ops)[1:]:
        if int(o) < 3:
            break
        n += 1
    return n


def _gier_item(ds, item: int, size: int, root_act: str):
    g = ds.GIER
    d = g.op_data[g.ReqId2PairId[item]]
    stem = d["input"].split("_")[0]
    masks = {}
    for op, md in d["operator"].items():
        if op in g.op_vocab2id and md["local"]:
            masks[int(g.op_vocab2id[op])] = union_mask(
                os.path.join(g.mask_dir, f"{stem}_{stem}_mask.json"),
                md["ids"], size)
    return (read_image(os.path.join(g.img_dir, d["input"]), size),
            read_image(os.path.join(g.img_dir, d["output"]), size),
            os.path.join(root_act, stem), masks)


def _fivek_item(ds, item: int, size: int, root_act: str):
    d = ds.data[item]
    return (read_image(os.path.join(ds.img_dir, d["input"]), size),
            read_image(os.path.join(ds.img_dir, d["output"]), size),
            os.path.join(root_act, f"{ds.phase}{item}"), {})


def sample_items(pool, seed: int):
    rng = np.random.default_rng(seed + 2)
    masked = [i for i, it in enumerate(pool) if it[5]]
    picked = [int(i) for i in rng.permutation(masked)[:SAMPLE // 2]]
    rest = [int(i) for i in rng.permutation(len(pool)) if i not in picked]
    return sorted(picked + rest[:SAMPLE - len(picked)])


def pool_off(ds, pool, seed: int, size: int, act_dir: str) -> int:
    """Values of the sampled items that differ from the decode here."""
    gier = hasattr(ds, "GIER")
    off = 0
    for i in sample_items(pool, seed):
        x, y, _, ops, _, masks = pool[i]
        mine = (_gier_item if gier else _fivek_item)(ds, i, size, act_dir)
        inp, out, item_dir, my_masks = mine
        steps = np.zeros_like(y)
        for k in range(_steps(ops)):
            p = os.path.join(item_dir, f"edit{k}.jpg")
            if os.path.exists(p):
                steps[k] = read_image(p, size)
        steps[-1] = out
        off += int(np.count_nonzero(x != inp))
        off += int(np.count_nonzero(y != steps))
        masks = masks or {}
        for k in set(masks) | set(my_masks):
            if k not in masks or k not in my_masks:
                off += size * size
            else:
                off += int(np.count_nonzero(
                    (np.asarray(masks[k]) > 0) != (my_masks[k] > 0)))
    return off
