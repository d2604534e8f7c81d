"""The pix2pixHD cell's own pieces: its driver rehearsed on the CPU through
the harness at tiny widths (32 x 64, ngf 4, D ndf 8; VGG19 at its own
widths) for a `correct` line, traced and not; a program without the step
counter reporting no MFU; the reference against itself; its control and
planted faults failing the check (at the tiny size here; on a card, at
the cell's own size); pix2pixHD's FLOP count against a hand count of one
layer of each kind and against PyTorch's own counter; the MFU reader.

The shared control test (`test_bench_control.py`) sends every kind but
serving to the trainers' control (`control.training_readings`), which
this cell's configuration does not fit: its control is tested here."""

import argparse
import time

import pytest
import torch

from benchmark import control_p2p, flops_pix2pixhd, harness
from benchmark.flops import PEAK_F32_FLOPS, conv
from benchmark.tests._rehearse import drive, make_run

CELL = "fivek_pix2pixhd_1024p"
TINY = {"ngf": 4, "n_downsample_global": 2, "n_blocks_global": 1,
        "n_blocks_local": 1, "ndf": 8, "height": 32, "width": 64}
RECIPE = {"ngf": 32, "n_downsample_global": 4, "n_blocks_global": 9,
          "n_local_enhancers": 1, "n_blocks_local": 3, "ndf": 64,
          "n_layers_D": 3, "num_D": 3}


def _run(trace=0, seed=2 ** 31 + 12345):
    run = make_run(CELL, seed=seed, trace=trace)
    run.config["model"].update(TINY)
    run.traffic.update(batch_size=1, warm_steps=3, trace_at=0.0)
    return run


@pytest.mark.parametrize("trace", [0, 1])
def test_pix2pixhd_rehearsal_line(trace):
    run = _run(trace)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(run.cell["limits"])
    if trace:
        assert {"p2p_mfu.p2p", "data_wait_share.train",
                "device_idle.train"} <= set(line["metrics"])
        # no card: no device time to divide by span
        assert "p2p_gen_ms.p2p" not in line["metrics"]
        spans = run.readings["trace"]["span_device"]
        assert all(spans[s][1] > 0 for s in ("train.p2p.gen",
                                             "train.p2p.disc"))
    else:
        assert {"setup_s", "train_img_per_s"} <= set(line["metrics"])
    o = {**RECIPE, **TINY}
    assert run.readings["p2p_flops"] == run.readings["steps"] * \
        flops_pix2pixhd.step_flops(o, 1, 32, 64)
    assert run.readings["disc_flops"] == run.readings["steps"] * \
        flops_pix2pixhd.step(o, 1, 32, 64)["disc"]


def test_a_program_without_the_counter_reports_no_mfu(monkeypatch):
    from t2onet_tpu_torch.train import pix2pixhd

    init = pix2pixhd.Pix2PixHDState.__init__

    def init_without(self, *a, **kw):
        init(self, *a, **kw)
        self.kept = self.__dict__.pop("stats")

    step = pix2pixhd.pix2pixhd_step

    def step_without(state, batch):
        state.stats = state.kept
        try:
            return step(state, batch)
        finally:
            del state.stats
    monkeypatch.setattr(pix2pixhd.Pix2PixHDState, "__init__", init_without)
    monkeypatch.setattr(pix2pixhd, "pix2pixhd_step", step_without)
    run = _run(trace=1)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert "p2p_mfu.p2p" not in line["metrics"]


def _fails(out, limits, name):
    return any(out[name][k] > v for k, v in limits.items() if k in out[name])


def test_control_and_faults_fail_the_check():
    """TF32 and each planted fault fail a limit; the reference against
    itself passes every one and, on the CPU, reads 0 throughout."""
    run = _run()
    out = control_p2p.readings(run)
    limits = run.cell["limits"]
    for name in ("tf32", "half_pixels", "d_batchnorm", "no_global"):
        assert _fails(out, limits, name), (name, out[name])
    assert not _fails(out, limits, "f32_again"), out["f32_again"]
    assert all(v == 0 for v in out["f32_again"].values())
    # the changes over every entry are printed beside the compared ones
    assert {"change_gap.all", "d_change_gap.all"} <= set(out["tf32"])


@pytest.mark.card
def test_control_and_faults_fail_at_the_cells_size(card):
    """At the cell's own size: the control and each planted fault fail a
    limit, and the reference against itself passes every one, on three
    seeds."""
    for seed in (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303):
        args = argparse.Namespace(workload=CELL, seed=seed, seconds=1.0,
                                  trace=0)
        run = harness.Run(args, time.time())
        out = control_p2p.readings(run)
        limits = run.cell["limits"]
        for name in ("tf32", "half_pixels", "d_batchnorm", "no_global"):
            assert _fails(out, limits, name), (seed, name, out[name])
        assert not _fails(out, limits, "f32_again"), (seed, out["f32_again"])


def test_one_layer_of_each_kind_by_hand():
    """At 2048 x 1024: the local G's 7x7 head (3 -> 32 at full size), the
    global G's first downsample (64 -> 128, 3x3 stride 2 to 256 x 512), a
    bottleneck block's conv (1024 at 32 x 64), the local transposed conv
    (64 -> 32 over 512 x 1024 input pixels), D's first layer at full size
    (6 -> 64, 4x4 stride 2 padding 2 to 513 x 1025), VGG19's conv1_2 (64 at
    full size)."""
    g = flops_pix2pixhd.generator_layers(RECIPE, 1024, 2048)
    assert g[0] == (True, 2 * 3 * 64 * 49 * 512 * 1024)
    assert g[1] == (False, 2 * 64 * 128 * 9 * 256 * 512)
    assert g[5] == (False, 2 * 1024 * 1024 * 9 * 32 * 64)
    assert g[-10] == (True, 2 * 3 * 32 * 49 * 1024 * 2048)
    assert g[-2] == (False, 2 * 64 * 32 * 9 * 512 * 1024)
    assert g[-1] == (False, 2 * 32 * 3 * 49 * 1024 * 2048)
    d = flops_pix2pixhd.disc_layers(RECIPE, 1024, 2048)
    assert d[0] == (0, 2 * 6 * 64 * 16 * 513 * 1025)
    assert len(d) == 15 and [j for j, _ in d[:5]] == [0, 1, 2, 3, 4]
    v = flops_pix2pixhd.vgg_layers(1024, 2048)
    assert v[1] == conv(64, 64, 3, 1024, 2048)
    parts = flops_pix2pixhd.step(RECIPE, 1, 1024, 2048)
    assert sum(parts.values()) == flops_pix2pixhd.step_flops(
        RECIPE, 1, 1024, 2048)
    assert 10.2e12 < sum(parts.values()) < 10.4e12


def _counted(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("size", [(32, 64), (48, 40)])
def test_forward_flops_match_pytorchs_counter(size):
    from t2onet_tpu_torch.models.gan import MultiscaleDiscriminator
    from t2onet_tpu_torch.models.pix2pixhd import define_generator

    h, w = size
    o = {**RECIPE, **{k: TINY[k] for k in ("ngf", "n_downsample_global",
                                           "n_blocks_global",
                                           "n_blocks_local", "ndf")}}
    g = define_generator("local", **{k: o[k] for k in (
        "ngf", "n_downsample_global", "n_blocks_global",
        "n_local_enhancers", "n_blocks_local")})
    d = MultiscaleDiscriminator(6, 0, o["ndf"], o["n_layers_D"], o["num_D"],
                                norm="instance")
    with torch.no_grad():
        x3, x6 = torch.rand(1, 3, h, w), torch.rand(1, 6, h, w)
        assert _counted(lambda: g(x3)) == sum(
            f for _, f in flops_pix2pixhd.generator_layers(o, h, w))
        assert _counted(lambda: d(x6)) == sum(
            f for _, f in flops_pix2pixhd.disc_layers(o, h, w))


def test_mfu_reader():
    from benchmark.metrics import p2p_mfu

    assert p2p_mfu.read({"window_s": 2.0}) is None
    got = p2p_mfu.read({"window_s": 2.0, "p2p_flops": 67e12})
    assert got == pytest.approx(100 * 67e12 / (2.0 * PEAK_F32_FLOPS))
