"""The request tokenizer, frozen: punctuation stripped, lower case,
tokens of one letter or with a non-letter dropped; ids <NONE>=0
<START>=1 <END>=2 <UNK>=3; a row is <START>, the words cut to
max_len - 2, <END>, zeros.

This file imports nothing of the system under test."""

from __future__ import annotations

import string

import numpy as np

_TABLE = str.maketrans("", "", string.punctuation)


def parse_sent(desc: str):
    words = [w.lower().translate(_TABLE) for w in desc.split()]
    return [w for w in words if len(w) > 1 and w.isalpha()]


def tokenize(sent: str, vocab2id: dict, max_len: int) -> np.ndarray:
    ids = [vocab2id.get(t, 3) for t in parse_sent(sent)][:max_len - 2]
    row = np.zeros(max_len, np.int64)
    row[0] = 1
    row[1:1 + len(ids)] = ids
    row[1 + len(ids)] = 2
    return row
