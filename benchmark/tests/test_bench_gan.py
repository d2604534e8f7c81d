"""The GAN cell's own pieces: its driver rehearsed on the CPU through the
harness with the tests' tiny actor (`_rehearse`; the discriminator keeps
the configuration's widths) for a `correct` line, traced and not; its
control and planted faults failing the check (a tiny discriminator too;
on a card, at the cell's own size); the discriminator's FLOP count
against PyTorch's own counter; and the reduction that divides the
card's time by the program's spans, on a made-up event list."""

import argparse
import time

import pytest
import torch

from benchmark import control_gan, flops_gan, harness
from benchmark.span_trace import per_span_ms, span_device_seconds
from benchmark.tests._rehearse import drive, make_run

TINY_GAN = {"ndf": 8, "cond_nc": 16}


def _run(trace=0, gan=None):
    run = make_run("fivek_gan_b64", trace=trace)
    run.config["gan"].update(gan or {})
    return run


@pytest.mark.parametrize("trace", [0, 1])
def test_gan_rehearsal_line(trace):
    run = _run(trace)
    # a GAN iteration with the full discriminator takes seconds here:
    # trace from the window's start
    run.traffic["trace_at"] = 0.0
    line = drive(run)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(run.cell["limits"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert {"train_mfu", "disc_mfu.gan", "data_wait_share.train"} \
            <= set(line["metrics"])
        # no card: no device time to divide by span
        assert "gen_update_ms.gan" not in line["metrics"]
        spans = run.readings["trace"]["span_device"]
        assert spans["train.gan.gen"][1] > 0
    else:
        assert {"setup_s", "train_img_per_s"} <= set(line["metrics"])
    # each GAN iteration's discriminator FLOPs, from the program's counts
    assert run.readings["disc_flops"] > 0


def test_a_program_without_counters_reports_no_disc_mfu(monkeypatch):
    """A program whose `GANState` keeps no `stats` (the parent of the
    counters): the metric that reads them is absent, and the run is
    still correct."""
    from t2onet_tpu_torch.cli import train_gan

    init, step = train_gan.GANState.__init__, train_gan.gan_step

    def init_without(self, *a, **kw):
        init(self, *a, **kw)
        self.kept = self.__dict__.pop("stats")

    def step_without(state, gan, *a, **kw):
        gan.stats = gan.kept
        try:
            return step(state, gan, *a, **kw)
        finally:
            del gan.stats
    monkeypatch.setattr(train_gan.GANState, "__init__", init_without)
    monkeypatch.setattr(train_gan, "gan_step", step_without)
    run = _run(trace=1)
    run.traffic["trace_at"] = 0.0
    line = drive(run)
    assert line["correct"], line["checks"]
    assert "disc_mfu.gan" not in line["metrics"]
    assert "disc_flops" not in run.readings


def test_control_and_faults_fail_the_check():
    run = _run(gan=TINY_GAN)
    out = control_gan.readings(run)
    limits = run.cell["limits"]
    for name in ("tf32", "half_batch", "no_cond", "bn_running"):
        assert any(out[name][k] > v for k, v in limits.items()
                   if k in out[name]), name
    assert all(out["f32_again"][k] <= v for k, v in limits.items()
               if k in out["f32_again"])


@pytest.mark.card
def test_control_and_faults_fail_at_the_cells_size(card):
    """At the cell's own widths and batch: the control and each planted
    fault fail a limit, and the reference against itself passes every
    one, on three seeds."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        args = argparse.Namespace(workload="fivek_gan_b64", seed=seed,
                                  seconds=1.0, trace=0)
        run = harness.Run(args, time.time())
        out = control_gan.readings(run)
        limits = run.cell["limits"]
        for name in ("tf32", "half_batch", "no_cond", "bn_running"):
            assert any(out[name][k] > v for k, v in limits.items()
                       if k in out[name]), (seed, name, out[name])
        assert all(out["f32_again"][k] <= v for k, v in limits.items()
                   if k in out["f32_again"]), (seed, out["f32_again"])


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
def test_disc_forward_flops_match_pytorchs_counter(size):
    from torch.utils.flop_counter import FlopCounterMode

    from t2onet_tpu_torch.models.gan import MultiscaleDiscriminator

    gan = {"ndf": 8, "n_layers_D": 3, "num_D": 2, "cond_nc": 16}
    d = MultiscaleDiscriminator(6, gan["cond_nc"], gan["ndf"],
                                gan["n_layers_D"], gan["num_D"])
    x = torch.rand((2, 6) + size)
    cond = torch.rand((2, gan["cond_nc"]))
    with FlopCounterMode(display=False) as counter:
        d(x, cond)
    assert counter.get_total_flops() == 2 * flops_gan.disc_forward(
        gan, *size)


def test_updates_count_ten_forwards_less_two_first_layers():
    gan = {"ndf": 64, "n_layers_D": 3, "num_D": 2, "cond_nc": 512}
    fwd = flops_gan.disc_forward(gan, 128, 128)
    first = sum(f for _, j, f in flops_gan.disc_layers(gan, 128, 128)
                if j == 0)
    cond = 2 * 1024 * 512
    parts = flops_gan.updates(gan, 64, 128, 128, 1024)
    assert parts == {"g_update": 64 * (3 * fwd + cond),
                     "d_update": 64 * (6 * fwd - 2 * first + 2 * cond),
                     "stat_update": 64 * (fwd + cond)}
    # layer 3 at 18 x 18 (768 -> 512) is the largest, 2.0 GMAC
    layers = flops_gan.disc_layers(gan, 128, 128)
    assert max(layers, key=lambda t: t[2])[:2] == (0, 3)
    assert layers[3][2] == 2 * 768 * 512 * 16 * 18 * 18


def test_span_attribution_on_made_up_events():
    """Device activity is put down to the span open when its launch was
    made, whatever thread made it; host-to-device copies and activity
    launched outside every span are not; spans started before the
    stretch are not counted."""
    ms = 1_000_000
    spans = [("train.gan.gen", 10 * ms, 20 * ms),
             ("train.gan.disc", 20 * ms, 40 * ms),
             ("train.gan.gen", 50 * ms, 60 * ms),
             ("train.gan.gen", 0, 5 * ms)]       # before the stretch
    launches = {1: 12 * ms, 2: 19 * ms, 3: 25 * ms, 4: 45 * ms,
                5: 55 * ms, 6: 30 * ms, 7: 3 * ms}
    dev = [(13 * ms, 15 * ms, "sm90_xmma_fprop", 1),
           (21 * ms, 24 * ms, "wgrad_engine", 2),       # launched in gen
           (26 * ms, 30 * ms, "dgrad_engine", 3),
           (46 * ms, 47 * ms, "elementwise", 4),       # in no span
           (56 * ms, 57 * ms, "Memcpy HtoD (Pinned -> Device)", 5),
           (31 * ms, 33 * ms, "bn_bw", 6),
           (4 * ms, 9 * ms, "before", 7),
           (70 * ms, 71 * ms, "unmatched", 99)]
    got = span_device_seconds(dev, launches, spans,
                              ("train.gan.gen", "train.gan.disc"),
                              t0_ns=8 * ms)
    assert got["train.gan.gen"][1] == 2
    assert got["train.gan.gen"][0] == pytest.approx(0.005)
    assert got["train.gan.disc"] == [pytest.approx(0.006), 1]
    readings = {"trace": {"span_device": got}}
    assert per_span_ms(readings, "train.gan.gen") == pytest.approx(2.5)
    assert per_span_ms(readings, "train.gan.disc") == pytest.approx(6.0)
    assert per_span_ms({"trace": {"span_device": {
        "train.gan.gen": [0.0, 3]}}}, "train.gan.gen") is None
    assert per_span_ms({}, "train.gan.gen") is None
