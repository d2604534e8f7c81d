"""Tracing and step timing (counterpart of `t2onet_tpu.utils.profiling`).

- `trace(dir)`: a context manager around `torch.profiler` that writes a
  Chrome trace (`*.pt.trace.json`, which TensorBoard's profiler plugin
  and chrome://tracing read) into `dir`; the card's kernels are traced
  when CUDA is available.
- `PhaseTimer`: running per-phase step timing with the reference's
  running-average semantics (train_seq2seqL1.py:70-92), plus percentile
  summaries.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the host's operators and, with CUDA, the card's kernels into
    `log_dir`; yields the profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class PhaseTimer:
    # exact running mean over ALL samples; percentiles over a bounded
    # recent window so week-long runs don't accumulate unbounded floats
    _WINDOW = 4096

    def __init__(self):
        self._samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self._WINDOW))
        self._avg: Dict[str, float] = defaultdict(float)
        self._n: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._samples[name].append(dt)
            self._n[name] += 1
            n = self._n[name]
            self._avg[name] += (dt - self._avg[name]) / n

    def avg(self, name: str) -> float:
        return self._avg[name]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            xs_sorted = sorted(xs)
            k = len(xs_sorted)
            out[name] = {
                "mean": self._avg[name],
                "p50": xs_sorted[k // 2],
                "p90": xs_sorted[min(int(k * 0.9), k - 1)],
                "n": self._n[name],
            }
        return out

    def report(self) -> str:
        return "  ".join(
            f"{k}: {v['mean'] * 1e3:.1f}ms (p90 {v['p90'] * 1e3:.1f})"
            for k, v in self.summary().items())
