"""Batch-index iteration for the datasets' ``batches()`` (a copy of
`t2onet_tpu.data.iteration`, held equal by a test).

- :func:`epoch_index_batches` -- training-shaped: exactly ``steps``
  batches of exactly ``batch_size`` indices (a batch may span an epoch
  boundary), a fresh permutation at every epoch boundary including the
  first.
- :func:`sequential_index_batches` -- eval-shaped: every index once, in
  order, with a short tail batch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_index_batches(n: int, batch_size: int, steps: int, shuffle: bool,
                        rng: np.random.Generator) -> Iterator[np.ndarray]:
    """Yield ``steps`` index arrays of exactly ``batch_size`` each.

    Indices cycle over epochs of ``n`` items; each epoch is a fresh
    permutation when ``shuffle`` (including the first epoch) or
    ``arange(n)`` otherwise. A batch may span an epoch boundary — batches
    are never short, so downstream jitted steps see one compiled shape.

    Raises ``ValueError`` when the dataset is empty or smaller than the
    requested batch (a short dataset would otherwise repeat items inside
    a single batch, silently corrupting loss statistics).
    """
    if n <= 0:
        raise ValueError("epoch_index_batches: empty dataset (n=0)")
    if batch_size <= 0:
        raise ValueError(f"epoch_index_batches: batch_size={batch_size}")
    if batch_size > n:
        raise ValueError(
            f"epoch_index_batches: batch_size {batch_size} exceeds dataset "
            f"size {n}; shrink the batch or grow the dataset")

    def epoch() -> np.ndarray:
        return rng.permutation(n) if shuffle else np.arange(n)

    buf = epoch()
    for _ in range(steps):
        while len(buf) < batch_size:
            buf = np.concatenate([buf, epoch()])
        sel, buf = buf[:batch_size], buf[batch_size:]
        yield sel


def sequential_index_batches(n: int, batch_size: int) -> Iterator[np.ndarray]:
    """Yield every index in [0, n) exactly once, in order, in slices of at
    most ``batch_size`` (the final batch may be short). The exhaustive-eval
    mode: the old ``len(ds) // bs`` loops dropped up to ``bs - 1`` tail
    items from reported L1/SSIM/FID."""
    if n <= 0:
        raise ValueError("sequential_index_batches: empty dataset (n=0)")
    if batch_size <= 0:
        raise ValueError(f"sequential_index_batches: batch_size={batch_size}")
    order = np.arange(n)
    for start in range(0, n, batch_size):
        yield order[start:start + batch_size]
