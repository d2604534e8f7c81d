"""Dataset preprocessing: splits, vocab building, request-index
precompute (counterpart of `t2onet_tpu.data.preprocess`, the same files
byte for byte).

The split is 70/10/20 by unique input image, shuffled by numpy's
RandomState(seed); the vocab puts the 4 special tokens first, then the
request tokens sorted; the request rows are START + ids + END, zero
padded.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List

import numpy as np

from t2onet_tpu_torch.data.text import parse_sent, txt2idx


def define_split(data_file: str, out_dir: str, session: int,
                 ratios=(0.7, 0.1, 0.2), seed: int = 0):
    """Split an annotation list by unique input image."""
    # all three phase files must exist for the skip — a run interrupted
    # between phase writes would otherwise be skipped forever with
    # val/test missing
    if all(os.path.exists(os.path.join(out_dir, f"{ph}_sess_{session}.json"))
           for ph in ("train", "val", "test")):
        print(f"split session {session} already exists in {out_dir}")
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(data_file) as f:
        data = json.load(f)
    inputs = np.unique([v["input"] for v in data])
    n = len(inputs)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    rng = np.random.RandomState(seed)
    rng.shuffle(inputs)
    splits = {
        "train": set(inputs[:n_train]),
        "val": set(inputs[n_train:n_train + n_val]),
        "test": set(inputs[n_train + n_val:]),
    }
    for phase, names in splits.items():
        split_data = [d for d in data if d["input"] in names]
        path = os.path.join(out_dir, f"{phase}_sess_{session}.json")
        with open(path, "w") as f:
            json.dump(split_data, f)
        print(f"saved {phase} split ({len(split_data)}) to {path}")


def build_vocab(requests: List[str], min_count: int = 1) -> Dict[str, int]:
    """Token -> id vocab with the 4 special tokens first."""
    counts = Counter()
    for req in requests:
        counts.update(parse_sent(req))
    vocab = ["<NONE>", "<START>", "<END>", "<UNK>"] + sorted(
        t for t, c in counts.items() if c >= min_count)
    return {tok: i for i, tok in enumerate(vocab)}


def save_txt2idx(split_dir: str, anno_dir: str, vocab2id: Dict[str, int],
                 session: int, max_len: int = 15):
    """Precompute padded request_idx rows into the annotations. max_len
    is the body length (START and END are added)."""
    os.makedirs(anno_dir, exist_ok=True)
    if all(os.path.exists(os.path.join(anno_dir, f"{ph}_sess_{session}.json"))
           for ph in ("train", "val", "test")):
        print(f"text-to-index already exists in {anno_dir}")
        return
    for phase in ("train", "val", "test"):
        path = os.path.join(split_dir, f"{phase}_sess_{session}.json")
        with open(path) as f:
            data = json.load(f)
        for dic in data:
            # txt2idx takes the TOTAL row length (body + START + END)
            dic["request_idx"] = txt2idx(
                dic["request"], vocab2id, max_len + 2)[0].tolist()
        save_path = os.path.join(anno_dir, f"{phase}_sess_{session}.json")
        with open(save_path, "w") as f:
            json.dump(data, f)
        print(f"saved request indices to {save_path}")
