"""Tracing: host spans on the profiler's clock, and a profiler exporter.

- `span(name, **attrs)`: a context manager around a stretch of host
  work at a layer boundary. While spans are recorded it keeps the name,
  a span id, the id of the span open around it on the same thread, the
  thread's native id, its start and end in `time.time_ns()` (the clock
  of torch.profiler's event stamps, so a span and the operators it
  launched can be laid side by side) and `attrs` (a batch id, request
  ids, a step number, a bucket). Off, which is the default, it checks
  one module global and returns a shared no-op: it reads no clock and
  records nothing. Spans record nothing on the device and add no
  synchronisation. `set(**attrs)` on the span adds attributes learnt
  inside it.
- `start_spans()` starts recording into one bounded buffer;
  `take_spans()` stops and hands back the spans and the count of those
  the full buffer dropped. One recording runs at a time, across every
  thread of the process.
- `trace(dir)`: torch.profiler around a block, writing its Chrome trace
  (`*.pt.trace.json`, which TensorBoard's profiler plugin and
  chrome://tracing read) into `dir`, with the card's kernels when CUDA is
  available, and the spans recorded meanwhile beside it as `spans.json`
  (Chrome trace events, "ph": "X", on the profiler trace's time base).
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Tuple

CAPACITY = 1 << 20          # spans a recording keeps; the rest are counted


class Span(NamedTuple):
    name: str
    id: int
    parent: int             # 0: no span open around it on its thread
    tid: int                # threading.get_native_id()
    start_ns: int
    end_ns: int
    attrs: dict


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0
        self.open = True
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()      # .stack: open span ids

    def add(self, span: Span):
        with self.lock:
            if not self.open:
                return
            if len(self.spans) < self.capacity:
                self.spans.append(span)
            else:
                self.dropped += 1


_recorder = None            # the recording under way, or None: spans off


class _Off:
    """The span of a process that records none."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "start")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = getattr(self.rec.local, "stack", None)
        if stack is None:
            stack = self.rec.local.stack = []
        self.id = next(self.rec.ids)
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec.local.stack.pop()
        self.rec.add(Span(self.name, self.id, self.parent,
                          threading.get_native_id(), self.start, end,
                          self.attrs))
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A span around a `with` block (see the module's docstring)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _On(rec, name, attrs)


def start_spans(capacity: int = CAPACITY) -> None:
    """Record spans from now on, at most `capacity` of them."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = _Recorder(capacity)


def take_spans() -> Tuple[List[Span], int]:
    """Stop recording; (the spans ended since `start_spans`, in the order
    they ended, and how many more the full buffer dropped). A span still
    open is left out."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("spans are not being recorded")
    with rec.lock:
        rec.open = False
        return rec.spans, rec.dropped


def _chrome_events(spans, base_ns: int = 0) -> List[dict]:
    """Spans as Chrome trace events ("ph": "X"), in microseconds from
    `base_ns`."""
    pid = os.getpid()
    return [{"name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": dict(s.attrs, id=s.id, parent=s.parent)}
            for s in spans]


def _trace_base_ns(log_dir: str) -> int:
    """The time base of the newest profiler trace in `log_dir` (its
    events' "ts" count microseconds from it), 0 without one."""
    found = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                   key=os.path.getmtime)
    if not found:
        return 0
    with open(found[-1]) as f:
        return int(json.load(f).get("baseTimeNanoseconds", 0))


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the host's operators and, with CUDA, the card's kernels into
    `log_dir`, and the spans of every thread meanwhile into
    `log_dir/spans.json`; yields the profiler."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    start_spans()
    try:
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(log_dir)) \
                as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        spans, dropped = take_spans()
    base = _trace_base_ns(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": _chrome_events(spans, base),
                   "baseTimeNanoseconds": base,
                   "otherData": {"dropped_spans": dropped}}, f)
