"""The inpainting cell's own pieces: its driver rehearsed on the CPU
through the harness at 32 px and batch 2 (every width as configured) for
a `correct` line, traced and not; a program without the step counter
reporting no MFU; its control and planted faults failing the check (at
32 px here; on a card, at the cell's own size); EdgeConnect's FLOP count
against PyTorch's own counter; and the hysteresis kernel's roofline
reader on made-up readings.

The shared control test (`test_bench_control.py`) sends every kind but
serving to the trainers' control (`control.training_readings`), which
this cell's configuration does not fit: its control is tested here."""

import argparse
import time

import pytest
import torch

from benchmark import control_inpaint, flops_edgeconnect, harness
from benchmark.flops import least_seconds
from benchmark.tests._rehearse import drive, make_run

CELL = "gier_edgeconnect_b8"
SIZE = 32


def _run(trace=0):
    run = make_run(CELL, trace=trace)
    run.config["model"]["input_size"] = SIZE
    run.traffic.update(batch_size=2, warm_steps=3, trace_at=0.0)
    return run


@pytest.mark.parametrize("trace", [0, 1])
def test_inpaint_rehearsal_line(trace):
    run = _run(trace)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(run.cell["limits"])
    if trace:
        assert {"edgeconnect_mfu.inpaint", "data_wait_share.train",
                "device_idle.train"} <= set(line["metrics"])
        # no card: no device time to divide by span, no kernel launched
        assert "edge_ms.inpaint" not in line["metrics"]
        assert "hysteresis_roofline" not in line["metrics"]
        spans = run.readings["trace"]["span_device"]
        assert all(spans[s][1] > 0 for s in ("train.inpaint.edges",
                                             "train.inpaint.gen",
                                             "train.inpaint.disc"))
    else:
        assert {"setup_s", "train_img_per_s"} <= set(line["metrics"])
    per_step = flops_edgeconnect.step_flops(2, SIZE, SIZE)
    assert run.readings["edgeconnect_flops"] == \
        run.readings["steps"] * per_step


def test_a_program_without_the_counter_reports_no_mfu(monkeypatch):
    from t2onet_tpu_torch.train import edgeconnect

    init = edgeconnect.EdgeConnectState.__init__

    def init_without(self, *a, **kw):
        init(self, *a, **kw)
        self.kept = self.__dict__.pop("stats")

    step = edgeconnect.edgeconnect_inpaint_step

    def step_without(state, batch):
        state.stats = state.kept
        try:
            return step(state, batch)
        finally:
            del state.stats
    monkeypatch.setattr(edgeconnect.EdgeConnectState, "__init__",
                        init_without)
    monkeypatch.setattr(edgeconnect, "edgeconnect_inpaint_step",
                        step_without)
    run = _run(trace=1)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert "edgeconnect_mfu.inpaint" not in line["metrics"]


def _fails(out, limits, name):
    return any(out[name][k] > v for k, v in limits.items() if k in out[name])


def test_control_and_faults_fail_the_check():
    run = _run()
    out = control_inpaint.readings(run)
    limits = run.cell["limits"]
    for name in ("tf32", "half_batch", "no_style", "no_power"):
        assert _fails(out, limits, name), (name, out[name])
    assert not _fails(out, limits, "f32_again"), out["f32_again"]


@pytest.mark.card
def test_control_and_faults_fail_at_the_cells_size(card):
    """At the cell's own size: the control and each planted fault fail a
    limit, and the reference against itself passes every one, on three
    seeds."""
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        args = argparse.Namespace(workload=CELL, seed=seed, seconds=1.0,
                                  trace=0)
        run = harness.Run(args, time.time())
        out = control_inpaint.readings(run)
        limits = run.cell["limits"]
        for name in ("tf32", "half_batch", "no_style", "no_power"):
            assert _fails(out, limits, name), (seed, name, out[name])
        assert not _fails(out, limits, "f32_again"), (seed, out["f32_again"])


def _conv_flops(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return sum(v for op, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op) or "bmm" in str(op))


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_forward_flops_match_pytorchs_counter(size):
    from t2onet_tpu_torch.models import edgeconnect as E
    from t2onet_tpu_torch.models.vgg import Vgg19Features

    h, w = size
    with torch.no_grad():
        x3, x4 = torch.rand(1, 3, h, w), torch.rand(1, 4, h, w)
        assert _conv_flops(lambda: E.EdgeGenerator()(x3)) == sum(
            flops_edgeconnect.generator_layers(3, 1, h, w))
        assert _conv_flops(lambda: E.InpaintGenerator()(x4)) == sum(
            flops_edgeconnect.generator_layers(4, 3, h, w))
        assert _conv_flops(lambda: E.Discriminator().eval()(x3)) == sum(
            flops_edgeconnect.disc_layers(h, w))
        vgg = Vgg19Features(32)
        assert _conv_flops(lambda: vgg.taps(x3, ["relu5_2"])) == sum(
            flops_edgeconnect.vgg_layers(h, w))


def test_step_counts_at_the_cells_size():
    """The edge G's 733k multiply-adds a pixel, D's 6.29
    GFLOP an image, and the whole step's 5.85 TFLOP at b8 x 256^2."""
    assert sum(flops_edgeconnect.generator_layers(3, 1, 256, 256)) \
        == 2 * 733_440 * 256 * 256
    assert sum(flops_edgeconnect.disc_layers(256, 256)) == 6_293_618_688
    parts = flops_edgeconnect.step(8, 256, 256)
    assert sum(parts.values()) == 5_850_890_502_144
    assert flops_edgeconnect.hysteresis_call(8, 256, 256) == (1_048_576, 0)


def test_hysteresis_roofline_reader():
    from benchmark.metrics import hysteresis_roofline as reader

    call = flops_edgeconnect.hysteresis_call(8, 256, 256)
    trace = {"kernel_launches": {"hysteresis_init": 10, "hysteresis": 40},
             "kernel_s": {"hysteresis": 1e-3, "hysteresis_init": 1e-4}}
    got = reader.read({"trace": trace, "hysteresis_call": call})
    assert got == pytest.approx(100 * 10 * least_seconds(*call) / 1e-3)
    assert reader.read({"trace": trace}) is None
    assert reader.read({"trace": dict(trace, kernel_launches={}),
                        "hysteresis_call": call}) is None
