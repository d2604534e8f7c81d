"""GIER datasets (counterpart of `t2onet_tpu.data.gier`): the index over
the annotations, the data-mode filters, the local-edit masks, and the
request-level datasets with and without the planner's actions. Host-side
numpy; items and batches equal the JAX package's key by key.

Layout under `data_dir` (the GIER directory):
  splits/{phase}_sess_{s}.json               annotation list
  splits/{phase}_{mode file}_sess_{s}.json   data-mode id lists
  images/ masks/                             JPEGs, RLE mask files
Planner actions: {act_dir}/{image id}/acts.json and edit{k}.jpg.
"""

from __future__ import annotations

import json
import os
from functools import reduce
from typing import Dict, List

import numpy as np

from t2onet_tpu_torch.data.fivek import (load_infer_img_short_size_bounded,
                                         load_train_img, parse_action_json)
from t2onet_tpu_torch.data.iteration import (epoch_index_batches,
                                             sequential_index_batches)
from t2onet_tpu_torch.data.rle import resize_nearest, rle_decode
from t2onet_tpu_torch.data.text import END_ID, START_ID, load_vocab, parse_sent

_MODE_FILES = {
    "valid": "{phase}_Ids_L1Thr_0.06_sess_{s}.json",
    "shapeAlign_nonCrop": "{phase}_shapeAlignNonCrop_sess_{s}.json",
    "shapeAlign": "{phase}_shapeAlign_sess_{s}.json",
    "global": "{phase}_global_sess_{s}.json",
}


class GIER:
    """Index over GIER annotations: pairs kept by the '+'-combined data
    modes, their requests and ops, and each local op's mask."""

    def __init__(self, data_dir: str, vocab_dir: str, phase: str,
                 data_mode: str = "global", is_load_mask: bool = False,
                 session: int = 3, train_img_size: int = 128,
                 eval_img_mode: str = "native", wire_dtype=np.float32):
        """eval_img_mode (val and test): 'native' loads each input
        short-side-600 at its own aspect ratio and its output at the
        input's size; 'train_size' loads both square at train_img_size.
        The train split always loads at train_img_size."""
        self.op_max_len = 10
        self.eval_img_mode = eval_img_mode
        self.req_max_len = 15
        self.wire_dtype = np.dtype(wire_dtype)   # uint8 images; masks f32
        self.session = session
        self.phase = phase
        self.img_dir = os.path.join(data_dir, "images")
        self.mask_dir = os.path.join(data_dir, "masks")
        self.split_dir = os.path.join(data_dir, "splits")
        self.train_img_size = train_img_size
        self.is_load_mask = is_load_mask
        self.op_data = self._load_ops(phase, data_mode, session)
        (self.vocab2id, self.id2vocab,
         self.op_vocab2id, self.id2op_vocab) = load_vocab(
            vocab_dir, "GIER", session)
        self._mask_file_cache = None
        self._create_index()

    def _load_ops(self, phase, data_mode, session) -> List[Dict]:
        """The annotations in the intersection of the data modes."""
        with open(os.path.join(self.split_dir,
                               f"{phase}_sess_{session}.json")) as f:
            op_data = json.load(f)
        idx_sets = []
        for mode in data_mode.split("+"):
            if mode == "full":
                idx = list(range(len(op_data)))
            else:
                fname = _MODE_FILES[mode].format(phase=phase, s=session)
                with open(os.path.join(self.split_dir, fname)) as f:
                    idx = json.load(f)
            idx_sets.append(set(idx))
        keep = sorted(reduce(lambda x, y: x & y, idx_sets))
        return [op_data[i] for i in keep]

    def req2idx(self, sent: str) -> np.ndarray:
        """Request ids, zero-padded to req_max_len (unknown words 3);
        START and END are added by the dataset."""
        ids = [self.vocab2id.get(t, 3) for t in parse_sent(sent)]
        out = np.zeros(self.req_max_len, np.int64)
        out[: min(len(ids), self.req_max_len)] = ids[: self.req_max_len]
        return out

    def filter_operator(self, op_dict) -> List[str]:
        return [op for op in op_dict if op in self.op_vocab2id]

    def _create_index(self):
        imgs = []
        for d in self.op_data:
            imgs += [d["input"], d["output"]]
        self.getImgId = {name: i for i, name in enumerate(np.unique(imgs))}
        self.getReq, self.getReqIdx, self.ReqId2PairId = {}, {}, {}
        req_id = 0
        for pair_i, d in enumerate(self.op_data):
            for req in d["expert_summary"] + d["amateur_summary"]:
                self.getReq[req_id] = req
                self.getReqIdx[req_id] = self.req2idx(req)
                self.ReqId2PairId[req_id] = pair_i
                req_id += 1
        self.PairId2ReqId: Dict[int, List[int]] = {}
        for rid, pid in self.ReqId2PairId.items():
            self.PairId2ReqId.setdefault(pid, []).append(rid)

    # ---- masks ----------------------------------------------------------
    def get_mask(self, pair_id: int, operator: str):
        md = self.op_data[pair_id]["operator"][operator]
        return md["local"], md["ids"]

    def resize_and_union_mask(self, mask_ids, name, size) -> np.ndarray:
        """Union of the selected RLE masks of '{name}_{name}_mask.json',
        each resized nearest to `size` (h, w): (h, w) uint8."""
        h, w = size
        if self._mask_file_cache is not None \
                and self._mask_file_cache[0] == name:
            rles = self._mask_file_cache[1]  # local ops of one item share it
        else:
            with open(os.path.join(self.mask_dir,
                                   f"{name}_{name}_mask.json")) as f:
                rles = json.load(f)
            self._mask_file_cache = (name, rles)
        masks = [resize_nearest(rle_decode(rles[int(i)]), h, w)
                 for i in np.atleast_1d(np.asarray(mask_ids, int))]
        return np.clip(np.asarray(masks, bool).sum(0), 0, 1).astype(np.uint8)

    # ---- items ----------------------------------------------------------
    def get_op_info(self, pair_id: int):
        """(op ids padded to op_max_len, is_local flags, {op id: mask ids}
        of the local ops)."""
        op_idx, is_local, mask_dict = [], [], {}
        for op in self.op_data[pair_id]["operator"]:
            if op in self.op_vocab2id:
                op_idx.append(self.op_vocab2id[op])
                local, mask_ids = self.get_mask(pair_id, op)
                is_local.append(int(local))
                if local:
                    mask_dict[int(self.op_vocab2id[op])] = mask_ids
        op_idx += [0] * (self.op_max_len - len(op_idx))
        is_local += [0] * (self.op_max_len - len(is_local))
        return op_idx, is_local, mask_dict

    def _load_img(self, name: str, like_hw=None):
        """A training-size image, or for native eval the input
        short-side-600 and, with `like_hw`, the output resized to the
        input's (h, w)."""
        path = os.path.join(self.img_dir, name)
        if self.phase == "train" or self.eval_img_mode == "train_size":
            return load_train_img(path, self.train_img_size, self.wire_dtype)
        if like_hw is None:
            return load_infer_img_short_size_bounded(path)
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read image {path}")
        img = cv2.resize(img, (like_hw[1], like_hw[0]))
        return img[:, :, ::-1].astype(np.float32).transpose(2, 0, 1) / 255.0

    def get_req_item(self, req_id: int) -> Dict:
        pair_id = self.ReqId2PairId[req_id]
        d = self.op_data[pair_id]
        op_idx, is_local, mask_dict = self.get_op_info(pair_id)
        input_img = self._load_img(d["input"])
        out = {"input": input_img,
               "output": self._load_img(d["output"], input_img.shape[1:]),
               "is_local": is_local, "op_idx": op_idx,
               "request": self.getReq[req_id],
               "request_idx": self.getReqIdx[req_id].tolist()}
        if self.is_load_mask:
            size = (self.train_img_size, self.train_img_size)
            out["mask_dict"] = {
                k: self.resize_and_union_mask(
                    v, d["input"].split("_")[0], size).astype(np.float32)
                for k, v in mask_dict.items()}
        return out

    def get_pair_item(self, pair_id: int) -> Dict:
        """One annotated pair at train_img_size whatever the split (the
        planner's item): images, op ids, is_local flags, the pair's
        requests (expert, then amateur) and, with is_load_mask, each
        local op's unioned mask."""
        d = self.op_data[pair_id]
        op_idx, is_local, mask_dict = self.get_op_info(pair_id)
        out = {"input": load_train_img(os.path.join(self.img_dir, d["input"]),
                                       self.train_img_size, self.wire_dtype),
               "output": load_train_img(
                   os.path.join(self.img_dir, d["output"]),
                   self.train_img_size, self.wire_dtype),
               "is_local": is_local, "op_idx": op_idx,
               "request": d["expert_summary"] + d["amateur_summary"]}
        if self.is_load_mask:
            size = (self.train_img_size, self.train_img_size)
            out["mask_dict"] = {
                k: self.resize_and_union_mask(
                    v, d["input"].split("_")[0], size).astype(np.float32)
                for k, v in mask_dict.items()}
        return out

    def __len__(self):
        return len(self.op_data)


def _pad_start_end(idx: List[int]) -> List[int]:
    """START before the ids, END at the first padding zero (or last)."""
    idx = list(idx)
    zeros = np.where(np.asarray(idx) == 0)[0]
    if len(zeros) > 0:
        idx.insert(int(zeros[0]), END_ID)
    else:
        idx.append(END_ID)
    idx.insert(0, START_ID)
    return idx


class GIERDataset:
    """Request-level dataset; `batches` yields eval-shaped batches."""

    def __init__(self, data_dir, vocab_dir, phase, data_mode="global",
                 is_load_mask=False, session=3, train_img_size=128,
                 eval_img_mode="native", wire_dtype=np.float32):
        self.op_max_len = 8
        self.is_load_mask = is_load_mask
        self.GIER = GIER(data_dir, vocab_dir, phase, data_mode,
                         is_load_mask, session, train_img_size,
                         eval_img_mode=eval_img_mode, wire_dtype=wire_dtype)
        self.vocab2id = self.GIER.vocab2id
        self.id2op_vocab = self.GIER.id2op_vocab
        self.op_vocab2id = self.GIER.op_vocab2id

    def __len__(self):
        return len(self.GIER.ReqId2PairId)

    def __getitem__(self, item: int) -> Dict:
        dic = self.GIER.get_req_item(item)
        dic["request_idx"] = np.asarray(_pad_start_end(dic["request_idx"]),
                                        np.int64)
        return dic

    def batches(self, batch_size: int, steps: int, shuffle: bool = True,
                seed: int = 0, sequential: bool = False):
        """img_x, img_y (one step axis: img_y[:, -1] is the ground truth),
        x int32 and the request strings. sequential=True covers every
        item once, with a short tail batch."""
        if sequential:
            sels = sequential_index_batches(len(self), batch_size)
        else:
            sels = epoch_index_batches(len(self), batch_size, steps, shuffle,
                                       np.random.default_rng(seed))
        for sel in sels:
            items = [self[int(j)] for j in sel]
            yield {
                "img_x": np.stack([it["input"] for it in items]),
                "img_y": np.stack([it["output"] for it in items])[:, None],
                "x": np.stack([it["request_idx"] for it in items]
                              ).astype(np.int32),
                "req": [it["request"] for it in items],
            }


class GIERDatasetAct(GIERDataset):
    """Adds the planner's pseudo ground truth: ops, params and the image
    after each planned step, read from {act_dir}/{image id}/."""

    def __init__(self, data_dir, vocab_dir, act_dir, phase,
                 data_mode="global", is_load_mask=False, session=3,
                 train_img_size=128, wire_dtype=np.float32):
        super().__init__(data_dir, vocab_dir, phase, data_mode,
                         is_load_mask, session, train_img_size,
                         wire_dtype=wire_dtype)
        self.act_dir = act_dir
        self.train_img_size = train_img_size
        self.wire_dtype = np.dtype(wire_dtype)

    def get_act(self, item: int):
        pair_id = self.GIER.ReqId2PairId[item]
        data_id = self.GIER.op_data[pair_id]["input"].split("_")[0]
        item_dir = os.path.join(self.act_dir, data_id)
        with open(os.path.join(item_dir, "acts.json")) as f:
            act = json.load(f)
        op_seq, params, trunc = parse_action_json(act, self.op_max_len)
        imgs = np.zeros((self.op_max_len, 3, self.train_img_size,
                         self.train_img_size), self.wire_dtype)
        for i in range(trunc):
            p = os.path.join(item_dir, f"edit{i}.jpg")
            if os.path.exists(p):
                imgs[i] = load_train_img(p, self.train_img_size,
                                         self.wire_dtype)
        return op_seq, params, imgs

    def __getitem__(self, item: int) -> Dict:
        dic = super().__getitem__(item)
        ops, params, imgs = self.get_act(item)
        dic["output"] = np.concatenate([imgs, dic["output"][None]], 0)
        dic["operations"] = ops
        dic["parameters"] = params
        return dic

    def batches(self, batch_size: int, steps: int, shuffle: bool = True,
                seed: int = 0):
        """Training batches: img_x, img_y (B, op_max_len + 1, 3, H, W) the
        planned steps' images then the ground truth, x, y, gt_params,
        req; with is_load_mask also the local-edit masks in two layouts:
        step_masks (B, op_max_len, 1, H, W) by the ground-truth op of each
        step, and masks_vocab (B, n_ops, 1, H, W) by op id, which the
        episode phase gathers by the predicted op. An op without a mask
        edits globally: its mask is ones."""
        for sel in epoch_index_batches(len(self), batch_size, steps,
                                       shuffle, np.random.default_rng(seed)):
            items = [self[int(j)] for j in sel]
            batch = {
                "img_x": np.stack([it["input"] for it in items]),
                "img_y": np.stack([it["output"] for it in items]),
                "x": np.stack([it["request_idx"] for it in items]
                              ).astype(np.int32),
                "y": np.stack([it["operations"] for it in items]
                              ).astype(np.int32),
                "gt_params": np.stack([it["parameters"] for it in items]),
                "req": [it["request"] for it in items],
            }
            if self.is_load_mask:
                size = self.train_img_size
                n_vocab = len(self.op_vocab2id)
                b = len(items)
                s = batch["y"].shape[1] - 2
                step_m = np.ones((b, s, 1, size, size), np.float32)
                vocab_m = np.ones((b, n_vocab, 1, size, size), np.float32)
                for bi, it in enumerate(items):
                    masks = it.get("mask_dict", {})
                    for op_id, m in masks.items():
                        vocab_m[bi, int(op_id), 0] = m
                    for si in range(s):
                        op_id = int(batch["y"][bi, si + 1])
                        if op_id in masks:
                            step_m[bi, si, 0] = masks[op_id]
                batch["step_masks"] = step_m
                batch["masks_vocab"] = vocab_m
            yield batch
