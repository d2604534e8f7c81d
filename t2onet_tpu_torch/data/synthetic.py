"""Synthetic FiveK-like data: procedural images and known operator chains
(counterpart of `t2onet_tpu.data.synthetic`; for one seed it gives the
same items, images within f32 rounding).

Each item's target is its input pushed through a known op sequence, with a
request composed from templates chosen together with each op's parameter,
so the language carries the edit's direction and magnitude. The ops run
through the port's `ops.operators` on the host CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from t2onet_tpu_torch.data.iteration import (epoch_index_batches,
                                             sequential_index_batches)
from t2onet_tpu_torch.data.text import END_ID, START_ID, txt2idx
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops import operators as O

# op name -> list of (request templates, param sampler)
_TEMPLATES = {
    "brightness": [
        (["increase the brightness a lot", "brighten the image a lot"],
         lambda rng: rng.uniform(0.55, 0.9)),
        (["increase the brightness", "make the photo brighter"],
         lambda rng: rng.uniform(0.2, 0.55)),
        (["decrease the brightness", "darken the image"],
         lambda rng: rng.uniform(-0.55, -0.2)),
        (["darken the image a lot"], lambda rng: rng.uniform(-0.9, -0.55)),
    ],
    "contrast": [
        (["improve contrast", "increase the contrast",
          "add more contrast to the photo"],
         lambda rng: rng.uniform(0.2, 0.8)),
        (["reduce contrast", "decrease the contrast"],
         lambda rng: rng.uniform(-0.8, -0.2)),
    ],
    "saturation": [
        (["increase saturation", "enhance the color",
          "make colors more vivid"],
         lambda rng: rng.uniform(0.3, 0.8)),
        (["reduce saturation", "mute the colors"],
         lambda rng: rng.uniform(-0.2, -0.05)),
    ],
    "sharpness": [
        (["sharpen the image a lot"], lambda rng: rng.uniform(0.9, 1.5)),
        (["sharpen the image", "make it sharper", "increase sharpness"],
         lambda rng: rng.uniform(0.3, 0.9)),
    ],
    "tone": [
        (["fix the tone", "adjust the tones", "improve the tone"],
         lambda rng: rng.uniform(0.5, 2.0, size=8)),
    ],
    "color": [
        (["adjust the color balance", "fix the colors",
          "warm up the colors"],
         lambda rng: rng.uniform(0.9, 1.1, size=24)),
    ],
}

_VOCAB = ["<NONE>", "<START>", "<END>", "<UNK>"] + sorted(
    {w for groups in _TEMPLATES.values() for temps, _ in groups
     for t in temps for w in t.split() if len(w) > 1}
    | {"and"}   # multi-op requests join clauses with ' and '
)


def synthetic_vocab() -> Dict[str, int]:
    return {tok: i for i, tok in enumerate(_VOCAB)}


def _make_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth procedural RGB image in [0.05, 0.95], (3, size, size)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
    img = np.zeros((3, size, size), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.2, 0.4)
        base = rng.uniform(0.3, 0.6)
        img[c] = base + amp * np.sin(2 * np.pi * fx * x + px) * \
            np.cos(2 * np.pi * fy * y + py)
    return np.clip(img, 0.05, 0.95)


class SyntheticFiveK:
    """FiveKAct-style dataset of synthetic pairs. Each item: (input_img
    (3,S,S), output_imgs (T-1,3,S,S), req_idx (L,), ops (T,),
    params (T-2,24), request string)."""

    def __init__(self, n: int = 512, img_size: int = 64, seed: int = 0,
                 req_max_len: int = 17, op_max_len: int = 5,
                 max_ops_per_item: int = 2,
                 vocab2id: Optional[Dict[str, int]] = None):
        self.n = n
        self.img_size = img_size
        self.seed = seed
        self.req_max_len = req_max_len
        self.op_max_len = op_max_len
        self.max_ops = max_ops_per_item
        self.vocab2id = vocab2id or synthetic_vocab()
        self._cache = {}        # items are deterministic per index

    def __len__(self):
        return self.n

    @torch.no_grad()
    def make_item(self, idx: int):
        if idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        img = _make_image(rng, self.img_size)

        n_ops = int(rng.integers(1, self.max_ops + 1))
        names = list(rng.choice(list(_TEMPLATES), size=n_ops, replace=False))
        reqs, op_ids, params_rows, step_imgs = [], [], [], []
        cur = img[None]
        for name in names:
            temps, sampler = _TEMPLATES[name][
                int(rng.integers(len(_TEMPLATES[name])))]
            reqs.append(str(rng.choice(temps)))
            p = np.atleast_1d(np.asarray(sampler(rng), np.float32))
            exec_idx = O.OP_NAMES.index(name)
            cur = O.apply_op_by_index(torch.from_numpy(cur), exec_idx,
                                      torch.from_numpy(p[None])).numpy()
            op_ids.append(exec_idx + bank.VOCAB_OFFSET)
            row = np.zeros(bank.MAX_PARAM, np.float32)
            row[: len(p)] = p
            params_rows.append(row)
            step_imgs.append(cur[0])

        request = " and ".join(reqs)
        req_idx = txt2idx(request, self.vocab2id, self.req_max_len)[0]

        t = self.op_max_len + 2
        ops = np.zeros(t, np.int64)
        ops[0] = START_ID
        ops[1:1 + n_ops] = op_ids
        ops[1 + n_ops] = END_ID
        params = np.zeros((self.op_max_len, bank.MAX_PARAM), np.float32)
        params[:n_ops] = np.stack(params_rows)
        # teacher images: per-step edits, then gt at the end; pad with gt
        imgs = np.zeros((self.op_max_len + 1, 3, self.img_size, self.img_size),
                        np.float32)
        for i in range(self.op_max_len):
            imgs[i] = step_imgs[min(i, n_ops - 1)]
        imgs[-1] = step_imgs[-1]
        item = (img, imgs, req_idx, ops, params, request)
        self._cache[idx] = item
        return item

    def batches(self, batch_size: int, steps: int, shuffle: bool = True,
                seed: int = 0, sequential: bool = False):
        """Yield `steps` collated numpy batches; sequential=True covers
        every item once in order (short tail; steps/shuffle ignored)."""
        if sequential:
            sels = sequential_index_batches(self.n, batch_size)
        else:
            sels = epoch_index_batches(self.n, batch_size, steps, shuffle,
                                       np.random.default_rng(
                                           self.seed + 999 + seed))
        for sel in sels:
            items = [self.make_item(int(j)) for j in sel]
            yield {
                "img_x": np.stack([it[0] for it in items]),
                "img_y": np.stack([it[1] for it in items]),
                "x": np.stack([it[2] for it in items]).astype(np.int32),
                "y": np.stack([it[3] for it in items]).astype(np.int32),
                "gt_params": np.stack([it[4] for it in items]),
                "req": [it[5] for it in items],
            }
