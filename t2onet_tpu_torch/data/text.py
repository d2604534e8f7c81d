"""Request tokenizer: the same rules and ids as `t2onet_tpu.data.text`.

Strips punctuation, lowercases, drops length-1 and non-alpha tokens;
ids <NONE>=0 <START>=1 <END>=2 <UNK>=3.
"""

from __future__ import annotations

import string
from typing import Dict

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
