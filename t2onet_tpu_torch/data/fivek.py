"""FiveK readers (counterpart of `t2onet_tpu.data.fivek`): the square
training image and the short-side-600 eval image, the planner
trajectory's truncation, the planner JSON -> (ops, params) parse, the
image-pair dataset (`FiveK`), the train split's dataset with the
planner's actions (`FiveKAct`, read from
`{act_dir}/{phase}{i}/{i:05d}.json` and its per-step edit JPEGs), and
its whole-sequence views at inference resolution (`FiveKActVisualize`,
and `FiveKActDVisualize` for the disc planner's
`seq2seqGAN-disc_ops.json`).

Images are read as the reference reads them: cv2 (imported where it is
used), BGR -> RGB, CHW, resized with cv2's default bilinear resize on
uint8, then /255 (training images stay uint8 when the uint8 wire is
asked for).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from t2onet_tpu_torch.data.iteration import (epoch_index_batches,
                                             sequential_index_batches)
from t2onet_tpu_torch.data.text import END_ID, START_ID
from t2onet_tpu_torch.ops.bank import MAX_PARAM, VOCAB_OFFSET
from t2onet_tpu_torch.ops.operators import OP_NAMES

# planner op names, in executor order; ACT2PN: the parameters a planner
# JSON carries per op (inpaint and white carry none)
ACTIONS = list(OP_NAMES)
ACT2PN = dict(zip(OP_NAMES, (1, 1, 1, 24, 0, 8, 1, 0)))


def load_train_img(path: str, img_size: int, dtype=np.float32) -> np.ndarray:
    """(3, img_size, img_size) RGB: uint8 for dtype=np.uint8 (the wire
    format, divided by 255 on the device), else float32 in [0, 1]."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    img = cv2.resize(img, (img_size, img_size))
    img = img[:, :, ::-1].transpose(2, 0, 1)
    if np.dtype(dtype) == np.uint8:
        return np.ascontiguousarray(img)
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def load_infer_img_short_size_bounded(path: str, short_size: int = 600
                                      ) -> np.ndarray:
    """(3, h, w) f32 RGB in [0, 1], resized so that its short side is
    `short_size` (reference visual_utils.py:34-47)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    h, w, _ = img.shape
    ratio = short_size / min(h, w)
    img = cv2.resize(img, (int(np.round(w * ratio)), int(np.round(h * ratio))))
    img = img[:, :, ::-1].astype(np.float32)
    return img.transpose(2, 0, 1) / 255.0


def analyze_traj(dists: List[float]) -> int:
    """Steps to keep of a planner trajectory: up to where one step's gain
    drops to 1% of the initial distance or less (at least 1)."""
    seq = np.asarray(dists, np.float64)
    over = (seq[:-1] - seq[1:]) / seq[0]
    below = np.where(~(over > 0.01))[0]
    trunc = int(below[0]) if len(below) else len(over)
    return max(trunc, 1)


def parse_action_json(act: Dict, op_max_len: int, truncate: bool = True):
    """Planner JSON -> (op_seq (op_max_len + 2,) int64 [START, ops, END,
    NONE...], params (op_max_len, 24) f32, number of steps kept). Curve
    params are divided by their largest magnitude; a scalar fit above 5 in
    magnitude (a planner failure) becomes 0."""
    init_dist = act["init distance"]
    seq = act["operation sequence"][0]          # the top beam
    dists = [init_dist] + [v[2] for v in seq]
    trunc = min(analyze_traj(dists), op_max_len) if truncate else op_max_len
    seq = seq[:trunc]
    params = np.zeros((op_max_len, MAX_PARAM), np.float32)
    op_seq = np.zeros(op_max_len + 2, np.int64)
    i = -1
    for i, (name, vals, _dist) in enumerate([s[:3] for s in seq]):
        op_seq[i + 1] = ACTIONS.index(name) + VOCAB_OFFSET
        pn = ACT2PN[name]
        vals = np.asarray(vals, np.float32)
        if name in ("color", "tone"):
            params[i, :pn] = vals / max(np.abs(vals).max(), 1e-12)
        elif pn > 0:
            params[i, :pn] = 0.0 if abs(float(vals[0])) > 5 else vals[:pn]
    op_seq[0] = START_ID
    op_seq[i + 2] = END_ID
    return op_seq, params, len(seq)


class FiveK:
    """Image pairs and requests of one split (reference
    FiveKdataset.py:24-51); items are (input, output, request ids,
    request).

    eval_img_mode: 'native' loads val and test images short-side-600 at
    their own aspect ratio (the reference's batch-1 eval protocol), so
    that `batches` then needs batch size 1 unless every image has one
    shape; 'train_size' loads them square at train_img_size, so that
    in-training validation batches. The train split always loads at
    train_img_size. wire_dtype=np.uint8 keeps fixed-size images 8-bit
    (divided by 255 on the device); native images are f32 always.

    Fixed-size items (the train split, train_size eval) are decoded once
    and kept, read-only, up to a budget of T2ONET_CACHE_GB gigabytes
    (default 16; 0 caches nothing): the JPEG decode and resize on the
    host is the trainer's bottleneck, and the decoded items are small.
    Native-resolution items vary in size and are read once anyway.
    """

    def __init__(self, img_dir: str, anno_dir: str, phase: str,
                 session: int = 1, train_img_size: int = 128,
                 req_max_len: int = 15, eval_img_mode: str = "native",
                 wire_dtype=np.float32):
        self.img_dir = img_dir
        self.phase = phase
        self.train_img_size = train_img_size
        self.req_max_len = req_max_len
        self.eval_img_mode = eval_img_mode
        self.wire_dtype = np.dtype(wire_dtype)
        with open(os.path.join(anno_dir, f"{phase}_sess_{session}.json")) as f:
            self.data = json.load(f)
        self._cache: dict = {}
        self._cache_budget = float(
            os.environ.get("T2ONET_CACHE_GB", "16")) * 1e9
        self._cache_bytes = 0

    def __len__(self):
        return len(self.data)

    def _cache_get(self, item: int):
        return self._cache.get(item)

    def _cache_put(self, item: int, tup):
        """Keep a fixed-size item while the budget allows; returns it."""
        if not self._fixed_size():
            return tup
        size = sum(a.nbytes for a in tup if isinstance(a, np.ndarray))
        if self._cache_bytes + size > self._cache_budget:
            return tup
        for a in tup:
            if isinstance(a, np.ndarray):
                a.flags.writeable = False      # shared across epochs
        self._cache[item] = tup
        self._cache_bytes += size
        return tup

    def _fixed_size(self) -> bool:
        return self.phase == "train" or self.eval_img_mode == "train_size"

    def _load(self, name: str) -> np.ndarray:
        path = os.path.join(self.img_dir, name)
        if self._fixed_size():
            return load_train_img(path, self.train_img_size, self.wire_dtype)
        return load_infer_img_short_size_bounded(path, 600)

    def __getitem__(self, item: int):
        hit = self._cache_get(item)
        if hit is not None:
            return hit
        d = self.data[item]
        return self._cache_put(item, (
            self._load(d["input"]), self._load(d["output"]),
            np.asarray(d["request_idx"], np.int64), d["request"]))

    def batches(self, batch_size: int, steps: int, shuffle: bool = True,
                seed: int = 0, sequential: bool = False):
        """Eval batches: img_x, img_y with one step axis (img_y[:, -1] is
        the ground truth), x int32 and the request strings.
        sequential=True covers every item once, with a short tail batch
        (steps and shuffle ignored)."""
        if sequential:
            sels = sequential_index_batches(len(self), batch_size)
        else:
            sels = epoch_index_batches(len(self), batch_size, steps, shuffle,
                                       np.random.default_rng(seed))
        for sel in sels:
            items = [self[int(j)] for j in sel]
            yield {
                "img_x": np.stack([it[0] for it in items]),
                "img_y": np.stack([it[1] for it in items])[:, None],
                "x": np.stack([it[2] for it in items]).astype(np.int32),
                "req": [it[3] for it in items],
            }


class FiveKAct(FiveK):
    """Adds the planner's pseudo ground truth: items are (input, the
    planned steps' images then the output (op_max_len + 1, 3, S, S),
    request ids, ops, params, request). A step image missing on disk
    reads as zeros, as do the steps past the truncated trajectory."""

    def __init__(self, img_dir: str, anno_dir: str, act_dir: str, phase: str,
                 session: int = 1, train_img_size: int = 128,
                 op_max_len: int = 5, wire_dtype=np.float32):
        super().__init__(img_dir, anno_dir, phase, session, train_img_size,
                         wire_dtype=wire_dtype)
        self.act_dir = act_dir
        self.op_max_len = op_max_len

    def get_act(self, item: int):
        item_dir = os.path.join(self.act_dir, f"{self.phase}{item}")
        with open(os.path.join(item_dir, f"{item:05d}.json")) as f:
            act = json.load(f)
        op_seq, params, trunc = parse_action_json(act, self.op_max_len)
        imgs = np.zeros(
            (self.op_max_len, 3, self.train_img_size, self.train_img_size),
            self.wire_dtype)
        for i in range(trunc):
            p = os.path.join(item_dir, f"edit{i}.jpg")
            if os.path.exists(p):
                imgs[i] = load_train_img(p, self.train_img_size,
                                         self.wire_dtype)
        return op_seq, params, imgs

    def __getitem__(self, item: int):
        hit = self._cache_get(item)
        if hit is not None:
            return hit
        d = self.data[item]
        input_img = self._load(d["input"])
        output_img = self._load(d["output"])
        ops, params, imgs = self.get_act(item)
        output_imgs = np.concatenate([imgs, output_img[None]], axis=0)
        return self._cache_put(item, (
            input_img, output_imgs, np.asarray(d["request_idx"], np.int64),
            ops, params, d["request"]))

    def batches(self, batch_size: int, steps: int, shuffle: bool = True,
                seed: int = 0):
        """Training batches: img_x, img_y (B, op_max_len + 1, 3, S, S),
        x and y int32, gt_params, req."""
        for sel in epoch_index_batches(len(self), batch_size, steps,
                                       shuffle, np.random.default_rng(seed)):
            items = [self[int(j)] for j in sel]
            yield {
                "img_x": np.stack([it[0] for it in items]),
                "img_y": np.stack([it[1] for it in items]),
                "x": np.stack([it[2] for it in items]).astype(np.int32),
                "y": np.stack([it[3] for it in items]).astype(np.int32),
                "gt_params": np.stack([it[4] for it in items]),
                "req": [it[5] for it in items],
            }


class FiveKActVisualize(FiveKAct):
    """The inference-resolution variant without trajectory truncation
    (reference FiveKdataset.py:138-200): short-side-600 images, the top
    planner sequence kept whole (up to op_max_len), no step images.
    Items: (input, output, request ids, ops, params, request)."""

    act_json_name = None          # default: {item:05d}.json

    def get_act(self, item: int):
        item_dir = os.path.join(self.act_dir, f"{self.phase}{item}")
        name = self.act_json_name or f"{item:05d}.json"
        with open(os.path.join(item_dir, name)) as f:
            act = json.load(f)
        op_seq, params, _ = parse_action_json(act, self.op_max_len,
                                              truncate=False)
        return op_seq, params

    def __getitem__(self, item: int):
        d = self.data[item]
        input_img = load_infer_img_short_size_bounded(
            os.path.join(self.img_dir, d["input"]), 600)
        output_img = load_infer_img_short_size_bounded(
            os.path.join(self.img_dir, d["output"]), 600)
        ops, params = self.get_act(item)
        return (input_img, output_img,
                np.asarray(d["request_idx"], np.int64), ops, params,
                d["request"])


class FiveKActDVisualize(FiveKActVisualize):
    """The discriminator planner's variant: reads each item's
    `seq2seqGAN-disc_ops.json` (reference FiveKdataset.py:203-265)."""

    act_json_name = "seq2seqGAN-disc_ops.json"
