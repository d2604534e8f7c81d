"""The parts of the FiveK readers that the GIER datasets use (counterpart
of `t2onet_tpu.data.fivek`): the square training image, the planner
trajectory's truncation and the planner JSON -> (ops, params) parse.

Images are read as the reference reads them: cv2 (imported where it is
used), BGR -> RGB, CHW, resized to a square with cv2's default bilinear
resize on uint8, then /255 unless the uint8 wire is asked for.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

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
