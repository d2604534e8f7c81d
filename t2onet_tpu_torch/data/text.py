"""Request tokenizer, vocabularies and GloVe rows: the same rules and ids
as `t2onet_tpu.data.text`.

Strips punctuation, lowercases, drops length-1 and non-alpha tokens;
ids <NONE>=0 <START>=1 <END>=2 <UNK>=3.
"""

from __future__ import annotations

import json
import os
import string
from typing import Dict, Tuple

import numpy as np

NONE_ID, START_ID, END_ID, UNK_ID = 0, 1, 2, 3


def parse_sent(desc: str):
    table = str.maketrans("", "", string.punctuation)
    words = [w.lower().translate(table) for w in desc.split()]
    words = [w for w in words if len(w) > 1]
    return [w for w in words if w.isalpha()]


def txt2idx(sent: str, vocab2id: Dict[str, int], max_len: int) -> np.ndarray:
    """Request string -> (1, max_len) zero-padded id row with START/END."""
    body = max_len - 2
    ids = np.zeros(body, dtype=np.int64)
    valid = [vocab2id.get(t, UNK_ID) for t in parse_sent(sent)][:body]
    ids[: len(valid)] = valid
    out = ids.tolist()
    zeros = np.where(ids == 0)[0]
    if len(zeros) > 0:
        out.insert(int(zeros[0]), END_ID)
    else:
        out.append(END_ID)
    out.insert(0, START_ID)
    return np.asarray(out, dtype=np.int64)[None]


def load_vocab(vocab_dir: str, dataset: str, session: int
               ) -> Tuple[Dict[str, int], Dict[int, str],
                          Dict[str, int], Dict[int, str]]:
    """(vocab2id, id2vocab, op_vocab2id, id2op_vocab) from the request and
    operator vocabulary files, token -> id dicts in id order."""
    with open(os.path.join(vocab_dir,
                           f"{dataset}_vocabs_sess_{session}.json")) as f:
        vocab = json.load(f)
    with open(os.path.join(
            vocab_dir, f"{dataset}_operator_vocabs_sess_{session}.json")) as f:
        op_vocab = json.load(f)
    vocab2id = {tok: i for i, tok in enumerate(vocab)}
    id2vocab = {i: tok for i, tok in enumerate(vocab)}
    op2id = {tok: i for i, tok in enumerate(op_vocab)}
    id2op = {i: tok for i, tok in enumerate(op_vocab)}
    return vocab2id, id2vocab, op2id, id2op


def load_embedding(path: str) -> np.ndarray:
    """The GloVe word matrix (vocab - 4, 300) f32: the "glove" dataset of
    an .h5 file (h5py, imported here), or an .npy copy of it for hosts
    without h5py."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["glove"][()], np.float32)
