"""The port's host spans (`t2onet_tpu_torch.utils.profiling`) and where
the serving and training paths record them, on the CPU at tiny widths:
off records nothing and reads no clock; nesting, parents and threads;
the shared clock with torch.profiler; one request id through a
MicroBatcher round with the engine's queue-wait counter; a training
step's phases; the Prefetcher's staging."""

import threading

import numpy as np
import pytest
import torch

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.serve import MicroBatcher, ServingEngine
from t2onet_tpu_torch.train.loop import (TrainState, episode_step,
                                         supervised_step)
from t2onet_tpu_torch.utils import profiling

torch.set_num_threads(2)

CFG = ModelConfig.tiny(encoder_max_len=17, decoder_max_len=5)


@pytest.fixture
def recording():
    """Spans recorded for the test; whatever it left open is taken."""
    profiling.start_spans()
    yield
    if profiling._recorder is not None:
        profiling.take_spans()


def _actor():
    return Actor(CFG, OperatorConfig(), len(synthetic_vocab()),
                 generator=torch.Generator().manual_seed(0))


def _children(spans, parent):
    return sorted(s.name for s in spans if s.parent == parent.id)


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    assert profiling._recorder is None
    with profiling.span("serve.launch", batch=1) as s:
        with profiling.span("serve.launch.stack") as inner:
            pass
    assert s is inner       # the one shared no-op
    with pytest.raises(RuntimeError):
        profiling.take_spans()


def test_spans_nest_by_thread(recording):
    def worker():
        with profiling.span("t.outer"):
            with profiling.span("t.inner", step=3):
                pass

    with profiling.span("outer", batch=7):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        with profiling.span("inner"):
            pass
    assert not t.is_alive()
    spans, dropped = profiling.take_spans()
    by = {s.name: s for s in spans}
    assert dropped == 0 and len(spans) == 4
    assert len({s.id for s in spans}) == 4
    assert by["outer"].parent == 0 and by["t.outer"].parent == 0
    assert by["inner"].parent == by["outer"].id
    assert by["t.inner"].parent == by["t.outer"].id
    assert by["outer"].tid == by["inner"].tid == threading.get_native_id()
    assert by["t.outer"].tid == by["t.inner"].tid != by["outer"].tid
    assert by["outer"].attrs == {"batch": 7}
    assert by["t.inner"].attrs == {"step": 3}
    for child, parent in (("inner", "outer"), ("t.inner", "t.outer")):
        assert by[parent].start_ns <= by[child].start_ns \
            <= by[child].end_ns <= by[parent].end_ns


def test_full_buffer_counts_what_it_drops():
    profiling.start_spans(capacity=2)
    for k in range(5):
        with profiling.span("s", k=k):
            pass
    spans, dropped = profiling.take_spans()
    assert [s.attrs["k"] for s in spans] == [0, 1] and dropped == 3


def test_a_profiled_operator_lies_inside_its_span(recording):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.mm(a, a)
    spans, _ = profiling.take_spans()
    (s,) = spans
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns


def test_request_ids_run_through_a_microbatcher(recording):
    vocab = synthetic_vocab()
    engine = ServingEngine(_actor(), vocab, device="cpu", decode_size=16,
                           quantum=16, max_batch=4, encoder_max_len=17,
                           io_threads=2)
    rng = np.random.default_rng(0)
    shapes = [(16, 16)] * 5 + [(16, 32)] * 2
    batcher = MicroBatcher(engine, linger_ms=5.0).start()
    try:
        handles = [engine.submit(rng.uniform(0.1, 0.9, (3,) + hw)
                                 .astype(np.float32), "increase the "
                                 "brightness") for hw in shapes]
        for h in handles:
            assert h.done.wait(60) and h.error is None
    finally:
        batcher.stop()
    spans, dropped = profiling.take_spans()
    launches = [s for s in spans if s.name == "serve.launch"]
    ids = [r for s in launches for r in s.attrs["requests"]]
    assert dropped == 0
    assert sorted(ids) == sorted(h.rid for h in handles)
    assert len(set(ids)) == len(handles)
    assert {s.attrs["bucket"] for s in launches} == {(16, 16), (16, 32)}
    assert sum(s.attrs["n"] for s in launches) == len(handles)
    for s in launches:
        assert _children(spans, s) == ["serve.launch.decode",
                                       "serve.launch.stack"]
    read = [b for s in spans if s.name == "serve.batcher.readback"
            for b in s.attrs["batches"]]
    assert sorted(read) == sorted(s.attrs["batch"] for s in launches)
    st = engine.stats_snapshot()
    assert st["requests"] == len(handles) and st["queue_wait_s"] > 0
    launch_s = sum(s.end_ns - s.start_ns for s in launches) / 1e9
    assert launch_s == pytest.approx(st["launch_s"], rel=0.05, abs=1e-3)


def test_training_steps_record_their_phases(recording):
    state = TrainState(_actor())
    ds = SyntheticFiveK(n=2, img_size=16, op_max_len=5)
    b = device_put_batch({k: v for k, v in next(ds.batches(2, 1)).items()
                          if k != "req"}, "cpu")
    supervised_step(state, b)
    episode_step(state, {"x": b["x"], "img_x": b["img_x"],
                         "gt_img": b["img_y"][:, -1]},
                 generator=torch.Generator().manual_seed(0), sample=True)
    spans, _ = profiling.take_spans()
    steps = [s for s in spans if s.name == "train.step"]
    assert [(s.attrs["kind"], s.attrs["step"]) for s in steps] == [
        ("supervised", 1), ("episode", 2)]
    for s in steps:
        assert s.parent == 0
        assert _children(spans, s) == ["train.backward", "train.forward",
                                       "train.optimizer"]


def test_prefetcher_stages_each_batch(recording):
    batches = [{"a": np.full(4, k, np.float32)} for k in range(3)]
    with Prefetcher(iter(batches), to_device=lambda b: b) as it:
        got = [int(b["a"][0]) for b in it]
    spans, _ = profiling.take_spans()
    staged = sorted(s.attrs["batch"] for s in spans
                    if s.name == "data.stage")
    assert got == [0, 1, 2]
    # one a batch, and the last the next() that found the iterator spent
    assert staged == [0, 1, 2, 3]
    assert sum(s.name == "data.wait" for s in spans) == 4
