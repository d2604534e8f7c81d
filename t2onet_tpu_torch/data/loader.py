"""Background-prefetching batch loader (counterpart of
`t2onet_tpu.data.loader`).

A thread pumps collated numpy batches through a bounded queue and stages
them onto the device ahead of use, so the card does not wait on batch
preparation: on a CUDA device each array is copied into pinned host
memory and sent with a non-blocking copy on the current stream, and
uint8 images become float32 in [0, 1] on the device.

While spans are recorded (`utils.profiling`) the pump's work on each
batch (the iterator's `next()`, then `to_device`) is `data.stage` and the
consumer's wait for a batch `data.wait`.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from t2onet_tpu_torch.utils.profiling import span


class Prefetcher:
    """Wrap a batch iterator with an N-deep background prefetch queue.

    :param batches: iterator of dict batches (numpy arrays + aux lists).
    :param to_device: optional fn(batch) -> device batch, run on the
        prefetch thread so the host-to-device copy overlaps compute.
    :param depth: queue depth.

    Iteration past exhaustion keeps raising (StopIteration, or the pump's
    error) instead of blocking; `close()` stops the pump and drops the
    queued batches. Usable as a context manager.
    """

    _SENTINEL = object()

    def __init__(self, batches: Iterable, to_device: Optional[Callable] = None,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._to_device = to_device
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._pump, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self, it: Iterator):
        try:
            for number in itertools.count():
                with span("data.stage", batch=number):
                    batch = next(it, self._SENTINEL)
                    if batch is self._SENTINEL or self._stop.is_set():
                        return
                    if self._to_device is not None:
                        batch = self._to_device(batch)
                if not self._put(batch):
                    return
        except BaseException as e:          # raised on the consumer side
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        with span("data.wait"):
            item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the pump thread and drop the queued batches."""
        self._stop.set()
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


LENGTHS_KEY = "x_lengths"


def device_put_batch(batch: dict, device) -> dict:
    """numpy batch -> tensors on `device` (other values pass through).
    On a CUDA device the host side is pinned and the copy non-blocking;
    uint8 arrays become float32 / 255 on the device. A batch with
    request tokens `x` (B, L), zero-padded, also gets their lengths
    under `LENGTHS_KEY`: a (B,) int64 tensor on the host, counted from
    the same array, which the request encoder packs by without reading
    the device (`RNNEncoder.forward`'s `host_lengths`)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t.float() / 255.0 if v.dtype == np.uint8 else t
    x = batch.get("x")
    if isinstance(x, np.ndarray):
        out[LENGTHS_KEY] = torch.from_numpy((x != 0).sum(axis=1,
                                                         dtype=np.int64))
    return out
