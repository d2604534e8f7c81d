"""pix2pixHD's training in the port (`train.pix2pixhd`, `models.pix2pixhd`,
`models.gan` without a sentence code, `models.vgg`'s raw slices,
`cli.train_pix2pixhd`) against the benchmark's plain reference
(`benchmark/reference/pix2pixhd.py`), on the CPU at tiny widths (ngf 4
around an 8-ngf global G of 2 downsamples and 1 block, 1 local block, D
ndf 8 over 3 scales of 3 layers; VGG19 at its own widths) on 32 x 64
images, from one dict of weights made from a seed
(`benchmark.weights_pix2pixhd`).

Tolerances: G's output, D's features and each loss term within 1e-5
relatively; each network's first gradient within 1e-4 of its norm (f32 on
the CPU in two orders of summation: the reference writes instance norm
out); after two Adam steps each network's change within 1e-3 of its
norm, over every parameter but the biases that an instance norm cancels
(their gradient is 0 up to rounding, so Adam moves them by about the
learning rate either way). T2ONet+D's discriminator, which the same
layers make, keeps its names and its outputs (the plain reference of
the GAN cell, `benchmark/reference/gan.py`, within 1e-5)."""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import gan as RG
from benchmark.reference import pix2pixhd as R
from benchmark.weights_gan import make_disc_weights
from benchmark.weights_pix2pixhd import copy, make_pix2pixhd_weights
from t2onet_tpu_torch.data.fivek import load_train_img
from t2onet_tpu_torch.models.gan import DiscBundle, MultiscaleDiscriminator
from t2onet_tpu_torch.models.pix2pixhd import define_generator
from t2onet_tpu_torch.models.vgg import Vgg19Features
from t2onet_tpu_torch.train import pix2pixhd as T
from t2onet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data_real_h2h")
SEED, H, W = 2 ** 31 + 77, 32, 64
G_OPTS = {"ngf": 4, "n_downsample_global": 2, "n_blocks_global": 1,
          "n_local_enhancers": 1, "n_blocks_local": 1}
D_OPTS = {"ndf": 8, "n_layers_D": 3, "num_D": 3}
OPTS = {**G_OPTS, **D_OPTS}
CFG = {**OPTS, "lr": T.LR, "beta1": T.BETAS[0], "beta2": T.BETAS[1]}
RTOL = 1e-5
TERMS = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _gap(a, b):
    return float((a - b).norm() / b.norm())


def _nets(weights):
    g = define_generator("local", **G_OPTS)
    d = MultiscaleDiscriminator(6, 0, D_OPTS["ndf"], D_OPTS["n_layers_D"],
                                D_OPTS["num_D"], norm="instance")
    v = Vgg19Features()
    for net, part in ((g, "gen"), (d, "disc"), (v, "vgg")):
        net.load_state_dict(weights[part], strict=True)
    return g, d, v


def _batches():
    """Two committed FiveK pairs at 32 x 64 in [0, 1], the second flipped
    as the trainer's batches flip one."""
    import json

    with open(os.path.join(DATA, "FiveK", "annotations",
                           "train_sess_1.json")) as f:
        pairs = json.load(f)[:2]
    out = []
    for i, d in enumerate(pairs):
        lab, img = (load_train_img(os.path.join(DATA, "FiveK", "images",
                                                d[k]), (H, W))
                    for k in ("input", "output"))
        if i:
            lab, img = lab[..., ::-1], img[..., ::-1]
        out.append({"label": torch.from_numpy(lab.copy())[None],
                    "image": torch.from_numpy(img.copy())[None]})
    return out


@pytest.fixture(scope="module")
def weights():
    return make_pix2pixhd_weights(SEED, "cpu", OPTS)


@pytest.fixture(scope="module")
def run(weights):
    """The port's two steps (spans recorded) and the reference's two
    iterations from the same weights and batches."""
    torch.set_num_threads(2)
    batches = _batches()
    st = T.Pix2PixHDState(*_nets(copy(weights)))
    profiling.start_spans()
    try:
        port = {"losses": [{k: float(v) for k, v in
                            T.pix2pixhd_step(st, batches[0]).items()}]}
        port["g_grad"] = {n: st.g_opt.state[p]["exp_avg"] / (1 - T.BETAS[0])
                          for n, p in st.gen.named_parameters()}
        port["d_grad"] = {n: st.d_opt.state[p]["exp_avg"] / (1 - T.BETAS[0])
                          for n, p in st.disc.named_parameters()}
        port["losses"].append({k: float(v) for k, v in
                               T.pix2pixhd_step(st, batches[1]).items()})
    finally:
        spans, _ = profiling.take_spans()
    port.update(spans=spans, steps=st.stats["steps"],
                gen=dict(st.gen.named_parameters()),
                disc=dict(st.disc.named_parameters()))
    R.set_precision("f32", "cpu")
    P = copy(weights)
    adam_g, adam_d = {}, {}
    ref = {"losses": []}
    for i, b in enumerate(batches):
        got = R.iteration(P["gen"], P["disc"], P["vgg"], b["label"],
                          b["image"], adam_g, adam_d, CFG)
        ref["losses"].append(got["terms"])
        if i == 0:
            ref.update(g_grad=got["g_grads"], d_grad=got["d_grads"])
    ref.update(gen=P["gen"], disc=P["disc"])
    return port, ref


def test_generator_and_discriminator_forwards(weights):
    """G's output, and every layer's output of every scale of D on the
    pair with it, on the reference's initial weights."""
    g, d, _ = _nets(weights)
    b = _batches()[1]
    x, y = T.normalize(b["label"]), T.normalize(b["image"])
    with torch.no_grad():
        fake = g(x)
        want = R.generator(weights["gen"], x, OPTS)
        assert fake.shape == (1, 3, H, W)
        assert _gap(fake, want) < RTOL
        for pair in (torch.cat([x, fake], 1), torch.cat([x, y], 1)):
            got = d(pair)
            ref = R.discriminate(weights["disc"], pair, OPTS)
            assert [len(s) for s in got] == [5, 5, 5]
            for gs, rs in zip(got, ref):
                for a, r in zip(gs, rs):
                    assert a.shape == r.shape
                    assert _gap(a, r) < RTOL


def test_losses_of_two_steps(run):
    port, ref = run
    for p, r in zip(port["losses"], ref["losses"]):
        for k in TERMS:
            assert _rel(p[k], r[k]) < RTOL, (k, p[k], r[k])
        assert _rel(p["G_loss"], r["G_GAN"] + r["G_GAN_Feat"]
                    + r["G_VGG"]) < RTOL
        assert _rel(p["D_loss"], 0.5 * (r["D_real"] + r["D_fake"])) < RTOL


@pytest.mark.parametrize("net", ["g_grad", "d_grad"])
def test_first_gradients(run, net):
    """Each network's first gradient, as its Adam holds it (the first
    moment over 1 - beta1)."""
    port, ref = run
    names = sorted(ref[net])
    assert sorted(port[net]) == names
    got = torch.cat([port[net][n].reshape(-1) for n in names])
    want = torch.cat([ref[net][n].reshape(-1) for n in names])
    assert _gap(got, want) < 1e-4


@pytest.mark.parametrize("part", ["gen", "disc"])
def test_two_adam_steps(run, weights, part):
    port, ref = run
    skip = R.normed_biases(OPTS)
    names = [n for n in sorted(ref[part]) if n not in skip]
    moved = torch.cat([(port[part][n] - weights[part][n]).reshape(-1)
                       for n in names]).detach()
    want = torch.cat([(ref[part][n] - weights[part][n]).reshape(-1)
                      for n in names])
    assert float(moved.abs().min()) > 0
    assert _gap(moved, want) < 1e-3


def test_spans_and_counter(run):
    port, _ = run
    assert port["steps"] == 2
    spans = port["spans"]
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.attrs["kind"] for s in steps] == ["pix2pixhd"] * 2
    parts = [s for s in spans if s.parent in {x.id for x in steps}]
    assert [s.name for s in parts] == ["train.p2p.gen",
                                       "train.p2p.disc"] * 2
    for part in parts[:2]:
        inner = [s.name for s in spans if s.parent == part.id]
        assert inner == ["train.forward", "train.backward",
                         "train.optimizer"], (part.name, inner)


def test_cli_trains_two_iterations(tmp_path, monkeypatch):
    """`python -m t2onet_tpu_torch train-pix2pixhd` on the committed pairs,
    its recipe's widths and size shrunk to the tiny ones: two iterations,
    pix2pixHD's checkpoint files, which load back into the trained
    networks' modules, and a finite held-out L1."""
    from t2onet_tpu_torch.__main__ import main
    from t2onet_tpu_torch.cli import train_pix2pixhd

    monkeypatch.setattr(T, "G_OPTIONS", G_OPTS)
    monkeypatch.setattr(T, "D_OPTIONS", D_OPTS)
    monkeypatch.setattr(train_pix2pixhd, "SIZE", (H, W))
    argv = ["--device", "cpu", "--data_dir", DATA, "--num_iters", "2",
            "--print_every", "1", "--eval_pairs", "2",
            "--run_dir", str(tmp_path)]
    assert main(["train-pix2pixhd"] + argv) == 0
    state, m = train_pix2pixhd.main(argv)
    assert state.stats["steps"] == 2
    assert np.isfinite(m["l1"]) and np.isfinite(m["l1_input"])
    d = tmp_path / "pix2pixhd_model"
    g, disc, _ = T.build_networks(0)
    for net, f, want in ((g, T.CHECKPOINTS[0], state.gen),
                         (disc, T.CHECKPOINTS[1], state.disc)):
        net.load_state_dict(torch.load(d / f, weights_only=True))
        for (n, a), b in zip(net.state_dict().items(),
                             want.state_dict().values()):
            assert torch.equal(a, b), n


def test_pix2pixhd_discriminator_layout():
    """pix2pixHD's D: n_layers + 2 layers a scale, instance norms without
    parameters on the middle ones, its checkpoint names; at the recipe's
    widths 2.77 M parameters a scale."""
    d = MultiscaleDiscriminator(6, 0, 64, 3, 3, norm="instance")
    names = list(d.state_dict())
    assert names == [f"scale{i}_layer{j}.0.{p}" for i in range(3)
                     for j in range(5) for p in ("weight", "bias")]
    norms = [type(m[1]).__name__ for m in d.scale_layers(0)[1:4]]
    assert norms == ["InstanceNorm2d"] * 3
    assert sum(p.numel() for p in d.parameters()) == 3 * 2_767_809


def test_t2onet_d_discriminator_unchanged():
    """T2ONet+D's DiscBundle, made of the same layers: the reference
    checkpoint's names (`reference.gan.disc_specs`) in its order, and its
    outputs on the plain reference's."""
    gan = {"ndf": 8, "n_layers_D": 3, "num_D": 2, "cond_nc": 16,
           "lambda_feat": 10.0}
    hidden = 12
    w = make_disc_weights(gan, hidden, SEED, "cpu")
    bundle = DiscBundle(hidden, cond_nc=16, ndf=8, n_layers=3, num_D=2)
    assert list(bundle.state_dict()) == [
        n for n, _, _ in RG.disc_specs(gan, hidden)]
    bundle.load_state_dict(w, strict=True)
    bundle.train()
    g = torch.Generator().manual_seed(3)
    x6 = torch.rand(2, 6, 32, 32, generator=g)
    hid = torch.randn(2, 2, 6, generator=g)
    with torch.no_grad():
        got = bundle(x6, hid)
        cond = RG.condition(w, hid.transpose(0, 1).reshape(2, -1))
        want = RG.discriminate(w, gan, x6, cond)
    assert [len(s) for s in got] == [6, 6]
    for gs, rs in zip(got, want):
        for a, r in zip(gs, rs):
            assert _gap(a, r) < RTOL
