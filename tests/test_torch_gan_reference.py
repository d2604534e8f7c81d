"""T2ONet+D in the port against the benchmark's plain reference
(`benchmark/reference/gan.py`), on the CPU at tiny widths, from one dict
of weights made from a seed (`benchmark.weights`, `benchmark.weights_gan`):
the discriminator bundle layer by layer with its losses and gradients, a
whole `gan_step` against the reference's GAN iteration with the same
Gumbel draws, a bfloat16 discriminator outside the tolerances, the GAN
iteration's spans and counters, and a reference that imports nothing of
the port or of JAX."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import gan as RG
from benchmark.reference import model as RM
from benchmark.weights import make_weights
from benchmark.weights_gan import make_disc_weights
from t2onet_tpu_torch.cli.train_gan import GANState, gan_step
from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses
from t2onet_tpu_torch.train.loop import TrainState
from t2onet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                     "t2onet_d_fivek.json")))
MODEL = dict(CONFIG["model"], resnet_widths=[4, 4, 8, 8], hidden_size=8,
             word_vec_dim=8, operator_fc_dim=8, vis_feat_dim=8)
OPS = CONFIG["operators"]
GAN = dict(CONFIG["gan"], ndf=8, cond_nc=16)
V, B, SIZE, SEED = 30, 4, 32, 2 ** 31 + 77
HIDDEN = MODEL["n_layers"] * 2 * MODEL["hidden_size"]
LR, BETA1 = 2e-4, 0.5
# f32 on the CPU in two orders of summation: ~1e-7 relative apart
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(3, MODEL["encoder_max_len"] + 1, (B,),
                            generator=g)
    x = torch.randint(4, V, (B, MODEL["encoder_max_len"]), generator=g)
    x = torch.where(torch.arange(x.shape[1])[None] < lengths[:, None], x, 0)
    img = torch.rand((2, B, 3, SIZE, SIZE), generator=g)
    return {"x": x, "img_x": img[0], "gt_img": img[1]}


def _bundle(WD, dtype=torch.float32):
    bundle = DiscBundle(HIDDEN, cond_nc=GAN["cond_nc"], ndf=GAN["ndf"],
                        n_layers=GAN["n_layers_D"], num_D=GAN["num_D"])
    bundle.load_state_dict(WD, strict=True)
    return bundle.to(dtype).train()


def _close(got, want, rtol, what, floor=1e-30):
    """||got - want|| within rtol of ||want||, or of `floor` where that is
    larger."""
    got, want = got.detach().double(), want.detach().double()
    gap = float((got - want).norm()) / max(float(want.norm()), floor)
    assert gap <= rtol, f"{what}: {gap:.3g} of the norm"


def _leaves_close(got: dict, want: dict, rtol, what):
    """Each leaf within rtol of the larger of its norm and the median
    leaf's: a bias under a BatchNorm has a true gradient of 0, and both
    sides' are rounding noise."""
    assert set(got) == set(want), what
    med = float(np.median([float(v.norm()) for v in want.values()]))
    for n, v in want.items():
        _close(got[n], v, rtol, f"{what} {n}", med)


def _disc_pass(dtype):
    """The port's and the reference's feature lists, loss terms and
    gradients (D's, the condition encoder's, the fake image's) for one
    G-side and one D-side evaluation on the same pair and hidden state."""
    WD = make_disc_weights(GAN, HIDDEN, SEED, "cpu")
    b = _batch(1)
    hidden = torch.randn((MODEL["n_layers"], B, 2 * MODEL["hidden_size"]),
                         generator=torch.Generator().manual_seed(2))
    flat = hidden.transpose(0, 1).reshape(B, -1)
    bundle = _bundle(WD, dtype)
    losses = Seq2SeqGANLosses(n_layers=GAN["n_layers_D"], num_D=GAN["num_D"],
                              lambda_feat=GAN["lambda_feat"])
    src, gt = b["img_x"].to(dtype), b["gt_img"].to(dtype)
    fake = (0.5 * (b["img_x"] + b["gt_img"])).to(dtype).requires_grad_(True)
    cond = bundle.cond_encoder(hidden.to(dtype))
    port = {"feats": bundle.netD(torch.cat([src, fake], 1), cond)}
    parts = losses(bundle.netD, src, fake, gt, cond)
    g_loss = parts["G_GAN"] + parts["G_GAN_Feat"]
    d_loss = 0.5 * (parts["D_fake"] + parts["D_real"])
    port["g_loss"], port["d_loss"] = g_loss, d_loss
    port["d_fake_grad"] = torch.autograd.grad(g_loss, fake,
                                              retain_graph=True)[0]
    named = dict(bundle.named_parameters())
    port["d_grads"] = dict(zip(named, torch.autograd.grad(
        d_loss, list(named.values()))))

    D = {n: t.clone() for n, t in WD.items()}
    names = RG.trainable_names(RG.disc_specs(GAN, HIDDEN))
    for n in names:
        D[n].requires_grad_(True)
    fake_r = (0.5 * (b["img_x"] + b["gt_img"])).requires_grad_(True)
    cond_r = RG.condition(D, flat)
    real = RG.discriminate(D, GAN, torch.cat([b["img_x"], b["gt_img"]], 1),
                           cond_r)
    fake_f = RG.discriminate(D, GAN, torch.cat([b["img_x"], fake_r], 1),
                             cond_r)
    ref = {"feats": fake_f}
    g_ref = RG.lsgan(fake_f, True) + RG.feature_matching(fake_f, real, GAN)
    d_ref = 0.5 * (RG.lsgan(RG.discriminate(
        D, GAN, torch.cat([b["img_x"], fake_r.detach()], 1), cond_r), False)
        + RG.lsgan(real, True))
    ref["g_loss"], ref["d_loss"] = g_ref, d_ref
    ref["d_fake_grad"] = torch.autograd.grad(g_ref, fake_r,
                                             retain_graph=True)[0]
    ref["d_grads"] = dict(zip(names, torch.autograd.grad(
        d_ref, [D[n] for n in names])))
    return port, ref


def _gaps_within(port, ref, rtol):
    for i, (ps, rs) in enumerate(zip(port["feats"], ref["feats"])):
        assert len(ps) == len(rs) == GAN["n_layers_D"] + 3
        for j, (p, r) in enumerate(zip(ps, rs)):
            assert p.shape == r.shape, (i, j)
            _close(p, r, rtol, f"scale {i} layer {j}")
    for k in ("g_loss", "d_loss", "d_fake_grad"):
        _close(port[k], ref[k], rtol, k)
    _leaves_close(port["d_grads"], ref["d_grads"], rtol, "D grad")


def test_discriminator_matches_the_reference():
    """Every scale's every layer, G's and D's loss terms, D's and the
    condition encoder's gradients and the fake image's gradient."""
    port, ref = _disc_pass(torch.float32)
    _gaps_within(port, ref, RTOL)


def test_a_bfloat16_discriminator_fails_the_tolerances():
    port, ref = _disc_pass(torch.bfloat16)
    with pytest.raises(AssertionError):
        _gaps_within(port, ref, RTOL)


def _draws(seed):
    def gumbel(k, shape):
        g = torch.Generator().manual_seed(seed * 101 + k)
        u = torch.rand(shape, generator=g).clamp_min(
            torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))
    return gumbel


def _gan_states():
    W = make_weights(MODEL, V, SEED, "cpu")
    WD = make_disc_weights(GAN, HIDDEN, SEED, "cpu")
    actor = Actor(ModelConfig(**MODEL), OperatorConfig(**OPS), V,
                  generator=torch.Generator().manual_seed(0),
                  explore_prob=CONFIG["explore_prob"])
    actor.load_state_dict(W, strict=True)
    state = TrainState(actor)
    gan = GANState(_bundle(WD), state.params, LR, BETA1)
    return W, WD, state, gan


def _port_gan_step(state, gan, batch, gumbel):
    k = [0]

    def noise_fn(shape):
        k[0] += 1
        return gumbel(k[0] - 1, shape)

    losses = Seq2SeqGANLosses(n_layers=GAN["n_layers_D"], num_D=GAN["num_D"],
                              lambda_feat=GAN["lambda_feat"])
    return gan_step(state, gan, batch, losses, fused_exec=True,
                    noise_fn=noise_fn)


def test_gan_step_matches_the_reference_iteration():
    """One `gan_step` (the rollout through the fused step's plain
    versions) against `reference.gan.gan_iteration` with the same draws:
    both losses, G's Adam moments over the actor, D's over the bundle,
    and the running averages (the running means less the share of the
    bias before them, `check_gan.bias_free`). G's gradient comes back
    through D, the <END> image and the sampled rollout's train-mode
    BatchNorm over 4 images of 4 channels, and is held to 2e-3 of its
    norm as the port's GAN step is held to JAX's (tests/test_torch_gan.py);
    the leaves in the mean over all are held to 1e-4."""
    from benchmark.check_gan import bias_free, stat_keys

    W, WD, state, gan = _gan_states()
    batch = _batch(3)
    gumbel = _draws(5)
    m = _port_gan_step(state, gan, batch, gumbel)

    names = RM.trainable_names(RM.param_specs(MODEL, V))
    d_names = RG.trainable_names(RG.disc_specs(GAN, HIDDEN))
    P = {n: t.clone() for n, t in W.items()}
    D = {n: t.clone() for n, t in WD.items()}
    adam_g, adam_d = {}, {}
    g_loss, d_loss, g_grads, d_grads = RG.gan_iteration(
        P, names, D, d_names, MODEL, OPS, GAN, batch, gumbel,
        CONFIG["explore_prob"], adam_g, adam_d, LR, BETA1)
    _close(m["G_loss"], g_loss, RTOL, "G loss")
    _close(m["D_loss"], d_loss, RTOL, "D loss")
    actor_params = dict(state.actor.named_parameters())
    assert {n for n, p in actor_params.items() if p.requires_grad} \
        == set(names)
    for opt, params, adam, tol in (
            (gan.g_opt, actor_params, adam_g, 2e-3),
            (gan.d_opt, dict(gan.bundle.named_parameters()), adam_d, 1e-4)):
        mine = {n: p for n, p in params.items() if p.requires_grad}
        assert set(mine) == {k[1] for k in adam if k[0] == "m"}
        for k, sq in (("exp_avg", "m"), ("exp_avg_sq", "v")):
            _leaves_close({n: opt.state[p][k] for n, p in mine.items()},
                          {n: adam[(sq, n)] for n in mine}, tol, k)
    # G's first moment over every leaf at once
    every = [(gan.g_opt.state[actor_params[n]]["exp_avg"].flatten(),
              adam_g[("m", n)].flatten()) for n in names]
    _close(torch.cat([a for a, _ in every]), torch.cat([b for _, b in every]),
           1e-4, "G m, every leaf")
    _leaves_close({n: adam_d[("m", n)] / (1 - BETA1) for n in d_names},
                  d_grads, 1e-6, "the reference's D moment")
    sd = gan.bundle.state_dict()
    keys = stat_keys(WD)
    initial = {n: WD[n] for n in keys}
    port = bias_free({n: sd[n] for n in keys}, initial)
    ref = bias_free({n: D[n] for n in keys}, initial)
    assert port and set(port) == set(ref)
    for n in ref:
        _close(port[n], ref[n], 1e-4, n)
    assert state.step == 1


def test_gan_step_records_its_spans_and_counts_its_updates():
    _, _, state, gan = _gan_states()
    assert gan.stats == {"g_updates": 0, "d_updates": 0, "stat_updates": 0}
    profiling.start_spans()
    try:
        for k in range(2):
            _port_gan_step(state, gan, _batch(k), _draws(k))
            assert gan.stats == {"g_updates": k + 1, "d_updates": k + 1,
                                 "stat_updates": k + 1}
    finally:
        spans, dropped = profiling.take_spans()
    assert dropped == 0
    steps = [s for s in spans if s.name == "train.step"]
    assert [(s.attrs["kind"], s.attrs["step"]) for s in steps] == [
        ("gan", 1), ("gan", 2)]
    for step in steps:
        kids = sorted((s for s in spans if s.parent == step.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["train.gan.gen", "train.gan.disc"]
        for kid in kids:
            inner = sorted((s for s in spans if s.parent == kid.id),
                           key=lambda s: s.start_ns)
            assert [s.name for s in inner] == [
                "train.forward", "train.backward", "train.optimizer"]
            assert step.start_ns <= kid.start_ns <= kid.end_ns \
                <= step.end_ns


def test_reference_imports_neither_the_port_nor_jax():
    for name in ("gan.py", "model.py", "ops.py"):
        path = os.path.join(ROOT, "benchmark", "reference", name)
        tree = ast.parse(open(path).read(), path)
        found = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found.add((node.module or "").split(".")[0])
        assert not found & {"t2onet_tpu_torch", "t2onet_tpu", "jax", "flax",
                            "jaxlib"}, (name, found)
