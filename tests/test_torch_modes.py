"""The actor's and the bank's other modes in the port against the JAX
package, at tiny widths (ResNet widths 4,4,8,8, one LSTM layer, 16 px):
the bank's parameter noise and discrete bins with JAX's draws fed in; the
Bottleneck ResNet (depth 50) through the weights bridge; the bf16 ResNet;
`supervised` with per-step BatchNorm, executed images, masks and the
discrete mode's bin log-probs; `discrete_param_loss` and one discrete
supervised step; an episode step decoded at a probe resolution; and a
sampled episode with discrete bins and parameter noise on JAX's draws.

Tolerances: f32 paths within 1e-5 (outputs), training steps as
tests/test_torch_train.py (`check_train_step`). The bf16 ResNet is held
to JAX's bf16, and to the same encoder in f64, within BF16_RTOL of the
features' largest magnitude: both round every convolution and
activation to bf16 (8 bits of mantissa, a relative step of 2^-8 =
3.9e-3), and XLA and oneDNN sum the convolutions in other orders, so
single roundings land one bf16 step apart and carry through the blocks.
Measured on 8 uniform 128 px images: eval BN 1.1e-3 apart (2.3e-3 and
2.1e-3 from f64), train BN 1.34e-2 (1.40e-2 and 1.16e-2 from f64),
running statistics 4e-4. Train BN over few images amplifies those
roundings: on the synthetic batch's 16 px images (1 x 1 maps in the
last stages, 6 distinct images of 16) both bf16 encoders sit 5-9% from
f64, which tests their rounding, not the casts."""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.config import OperatorConfig as JOperatorConfig
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.models.actor import Actor as JActor
from t2onet_tpu.models.resnet import ResNet as JResNet
from t2onet_tpu.ops import bank as jbank
from t2onet_tpu.train import loop as jloop
from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.train import loop
from tests._torch_port import (assert_grads_and_stats_match, bridged,
                               check_train_step_bridged, draw_sequence, fed,
                               jax_actor, jax_train_state, port_actor)

torch.set_num_threads(2)

L = 12
B = 4
LR = 1e-3
V = len(synthetic_vocab())
OPCFG = OperatorConfig()
CFG = JModelConfig(encoder_max_len=L, decoder_max_len=3, n_layers=1,
                   hidden_size=8, word_vec_dim=8, operator_fc_dim=8,
                   vis_feat_dim=8, resnet_widths=(4, 4, 8, 8))
DISCRETE = dataclasses.replace(CFG, discrete_param=True)
BF16_RTOL = {False: 1e-2, True: 3e-2}          # by train BN
BF16_STATS_ATOL = 2e-3
BF16_IMAGES = np.random.default_rng(0).uniform(
    0, 1, (8, 3, 128, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    ds = JSyntheticFiveK(n=8, img_size=16, seed=0, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    out = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    out["gt_img"] = nb["img_y"][:, -1]
    return out


def _actors(cfg, batch, seed=6):
    ja, params, stats = jax_actor(cfg, V, batch["x"], batch["img_x"],
                                  seed=seed, knots_near_one=True)
    return ja, params, stats, port_actor(cfg, V, params, stats)


def _t(batch, keys):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in keys}


def _j(batch, keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample", [False, True])
def test_bank_param_modes_match_jax(sample):
    """param_ranges, the valid mask, the discrete grid, the ground-truth
    bins, parameter noise on JAX's normal draw and the discrete selection
    (argmax, or a draw on JAX's Gumbel noise) equal JAX's."""
    jcfg = JOperatorConfig()
    for got, want in zip(bank.param_ranges(OPCFG), jbank.param_ranges(jcfg)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bank._param_valid_mask(),
                                  jbank._param_valid_mask())
    for num in (10, 6):
        for got, want in zip(bank.discrete_param_grid(OPCFG, num),
                             jbank.discrete_param_grid(jcfg, num)):
            np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(3)
    gt = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    gt[0, 0] = 0.2                                  # between two bins
    ops = rng.integers(-3, 8, (5, 3))
    for got, want in zip(
            bank.gt_param_bins(torch.from_numpy(gt), torch.from_numpy(ops),
                               OPCFG),
            jax.jit(lambda g, o: jbank.gt_param_bins(g, o, jcfg))(
                jnp.asarray(gt), jnp.asarray(ops))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    raw = rng.normal(size=(6, 8, 24)).astype(np.float32)
    cont = rng.normal(size=(6, 8, 24)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    gumbel = np.asarray(jax.random.gumbel(key, (6, 8, 10)))
    # jitted: one compile each, where eager JAX compiles every primitive
    jp, jlp = jax.jit(lambda r, c, k: jbank.select_discrete_params(
        r, c, k, sample, 0.3, jcfg))(jnp.asarray(raw), jnp.asarray(cont), key)
    pp, plp = bank.select_discrete_params(
        torch.from_numpy(raw), torch.from_numpy(cont), sample, 0.3, OPCFG,
        gumbel=torch.from_numpy(gumbel) if sample else None)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))

    params = np.array(jax.jit(lambda r: jbank.squash_params(r, jcfg))(
        jnp.asarray(raw)))
    normal = np.asarray(jax.random.normal(key, params.shape))
    want = np.asarray(jax.jit(lambda p, k: jbank.add_param_noise(
        p, k, jcfg, 0.6))(jnp.asarray(params), key))
    got = bank.add_param_noise(torch.from_numpy(params), OPCFG, 0.6,
                               normal=torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got != params).any()
    with pytest.raises(ValueError, match="generator"):
        bank.add_param_noise(torch.from_numpy(params), OPCFG)


def test_draws_from_a_generator():
    """Without fed draws: parameter noise two-sided and in range, padding
    untouched; sampled bins on each supported op's grid."""
    params = torch.zeros(64, 8, 24)
    out = bank.add_param_noise(params, OPCFG, 0.6,
                               generator=torch.Generator().manual_seed(0))
    ub, lb, _ = bank.param_ranges(OPCFG)
    valid = torch.from_numpy(bank._param_valid_mask()) > 0
    assert (out[:, ~valid] == 0).all()
    for i in range(8):
        col = out[:, i][:, valid[i]]
        assert (col >= float(lb[i])).all() and (col <= float(ub[i])).all()
    assert out[:, 0, 0].max() > 1e-3 and out[:, 0, 0].min() < -1e-3
    raw = torch.randn(64, 8, 24, generator=torch.Generator().manual_seed(1))
    picked, _ = bank.select_discrete_params(
        raw, params, True, 0.3, OPCFG,
        generator=torch.Generator().manual_seed(2))
    grid, supported = bank.discrete_param_grid(OPCFG)
    for i in np.flatnonzero(supported):
        assert np.isin(picked[:, i, 0].numpy(), grid[i]).all()
        assert len(np.unique(picked[:, i, 0].numpy())) > 1
    with pytest.raises(ValueError, match="generator"):
        bank.select_discrete_params(raw, params, True, 0.3, OPCFG)


# ---------------------------------------------------------------------------
# the ResNet: Bottleneck and bf16
# ---------------------------------------------------------------------------

def _resnet_case(cfg, batch, img, f64):
    """The ResNet of one seeded actor on `img` in both BatchNorm modes:
    ({train: (port features, JAX features, {name: (port, JAX) running
    statistics})}, the port actor). One jit computes JAX's two modes;
    with `f64` both sides compute in float64 (JAX under enable_x64, its
    ResNet at dtype float64, the port's encoder `.double()`)."""
    _, params, stats, actor = _actors(cfg, batch, seed=2)
    dtype = (jnp.bfloat16 if cfg.vis_bf16 else
             jnp.float64 if f64 else jnp.float32)
    jres = JResNet(depth=cfg.resnet_depth, num_outputs=cfg.vis_feat_dim,
                   stage_widths=cfg.resnet_widths, dtype=dtype)

    def both(p, s, x):
        v = {"params": p, "batch_stats": s}
        return (jres.apply(v, x, train=False),
                jres.apply(v, x, train=True, mutable=["batch_stats"]))

    with jax.enable_x64(f64):
        cast = (lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64 if f64 else jnp.float32),
            t))
        ev, (tr, upd) = jax.jit(both)(cast(params["vis_encoder"]),
                                      cast(stats["vis_encoder"]), cast(img))
        refs = {False: bridged(params, stats, cfg),
                True: bridged(params, {**stats, "vis_encoder":
                                       upd["batch_stats"]}, cfg)}
        wants = {False: np.asarray(ev), True: np.asarray(tr)}
    out = {}
    for train in (False, True):
        enc = copy.deepcopy(actor.vis_encoder).train(train)
        if f64:
            enc.double()
        with torch.no_grad():
            got = enc(torch.from_numpy(img).to(enc.fc.weight.dtype))
        running = {k: (v.numpy(), refs[train][f"vis_encoder.{k}"])
                   for k, v in enc.state_dict().items() if "running" in k}
        out[train] = (got.numpy(), wants[train], running)
    return out, actor


@pytest.fixture(scope="module")
def bottleneck(batch):
    cfg = dataclasses.replace(CFG, resnet_depth=50)
    img = batch["img_y"].reshape((-1, 3, 16, 16))
    return _resnet_case(cfg, batch, img, f64=True)


@pytest.mark.parametrize("train", [False, True])
def test_bottleneck_resnet_matches_jax(bottleneck, train):
    """Depth 50 through the weights bridge (flax Conv_0..2 and
    BatchNorm_0..2 per block, Conv_3 the conv-only shortcut; fc from
    4 x the last width): features within 1e-5 in eval and train BN, and
    the running statistics a train forward leaves. Both compare in
    float64: in train BN in f32, flax's one-pass variance (E[x^2] -
    E[x]^2) drifts 3.6e-3 from f64 through 16 blocks whose late stages
    normalise 1 x 1 maps over 16 images, and the port's two-pass variance
    2.9e-3 (measured), so f32 would test their rounding, not the
    blocks."""
    cases, actor = bottleneck
    got, want, running = cases[train]
    enc = actor.vis_encoder
    assert enc.fc.in_features == 4 * CFG.resnet_widths[-1]
    assert "layer3.5.conv3.weight" in enc.state_dict()
    assert len(enc.layer1[0].shortcut) == 1
    assert not len(enc.layer1[1].shortcut)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for k, (v, w) in running.items():
        np.testing.assert_allclose(v, w, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def bf16(batch):
    """The bf16 case, and the same encoder in f64 on the port (the
    features' reference) in both BN modes."""
    cases, actor = _resnet_case(dataclasses.replace(CFG, vis_bf16=True),
                                batch, BF16_IMAGES, f64=False)
    f64 = {}
    for train in (False, True):
        enc = copy.deepcopy(actor.vis_encoder).train(train)
        enc.bf16 = False
        with torch.no_grad():
            f64[train] = enc.double()(
                torch.from_numpy(BF16_IMAGES).double()).numpy()
    return cases, actor, f64


@pytest.mark.parametrize("train", [False, True])
def test_bf16_resnet_matches_jax(bf16, train):
    """ResNet-18 in bf16 against JAX's ResNet(dtype=bfloat16), on 8
    uniform images at 128 px (BF16_IMAGES): features within BF16_RTOL of
    their largest magnitude, in f32, and no farther from the same
    encoder in f64; parameters and running statistics f32, and a train
    forward's statistics within BF16_STATS_ATOL of JAX's (module
    docstring)."""
    cases, actor, f64 = bf16
    got, want, running = cases[train]
    assert all(p.dtype == torch.float32
               for p in actor.vis_encoder.parameters())
    assert got.dtype == np.float32
    scale = np.abs(f64[train]).max()
    assert np.abs(got - want).max() <= BF16_RTOL[train] * scale
    assert np.abs(got - f64[train]).max() <= BF16_RTOL[train] * scale
    # bf16 is really on: the f64 encoder of the same weights differs
    assert np.abs(f64[train] - got).max() > 1e-4 * scale
    for k, (v, w) in running.items():
        assert v.dtype == np.float32
        np.testing.assert_allclose(v, w, atol=BF16_STATS_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# supervised: per-step BN, images, masks, discrete bins
# ---------------------------------------------------------------------------

SUP_KEYS = ("x", "y", "img_x", "img_y")


@pytest.fixture(scope="module")
def discrete_sup(batch):
    """One JAX computation of a train-mode discrete supervised pass with
    per-step BatchNorm, executed images and per-step masks: the trainer's
    loss (op NLL + param MSE + bin cross-entropy, as
    `make_supervised_step` builds it), its gradients, the pass's outputs
    and the BN statistics, in one jitted value_and_grad. Returns (JAX
    actor, params, stats, masks, loss, outputs, new stats, gradients)."""
    ja, params, stats = jax_actor(DISCRETE, V, batch["x"], batch["img_x"],
                                  seed=6, knots_near_one=True)
    n = batch["y"].shape[1] - 2
    masks = np.random.default_rng(1).uniform(
        0, 1, (B, n, 1, 16, 16)).astype(np.float32)

    def loss(p):
        out, upd = ja.apply({"params": p, "batch_stats": stats},
                            *(jnp.asarray(batch[k]) for k in SUP_KEYS),
                            train=True, with_images=True, per_step_bn=True,
                            step_masks=jnp.asarray(masks),
                            mutable=["batch_stats"],
                            method=JActor.supervised)
        y, gp = jnp.asarray(batch["y"]), jnp.asarray(batch["gt_params"])
        op_loss, param_loss = jloop.supervised_losses(out[2], out[1], y, gp)
        param_loss = param_loss + jloop.discrete_param_loss(
            out[3], y, gp, JOperatorConfig(), DISCRETE.discrete_step)
        return op_loss + param_loss, (out, upd["batch_stats"])

    (jl, (out, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return ja, params, stats, masks, jl, out, new_stats, grads


@pytest.mark.parametrize("masks", ["step_masks", "mask"])
def test_supervised_modes_match_jax(batch, discrete_sup, masks):
    """`supervised(per_step_bn=True, with_images=True)` in the discrete
    mode and train BN, against JAX with per-step masks: the executed
    images, params, op log-probs, the 4th output (bin log-probs) and the
    running statistics the per-step forwards chain, within 1e-5. One mask
    for every step (`mask=`) gives exactly what per-step masks that all
    equal it give."""
    _, params, stats, m, _, out, new_stats, _ = discrete_sup
    actor = port_actor(DISCRETE, V, params, stats).train()
    args = [torch.from_numpy(batch[k]) for k in SUP_KEYS]
    with torch.no_grad():
        got = actor.supervised(*args, with_images=True, per_step_bn=True,
                               step_masks=torch.from_numpy(m))
        if masks == "mask":
            one = torch.from_numpy(m[:, 0])
            got1 = actor.supervised(*args, with_images=True, mask=one)
            every = actor.supervised(*args, with_images=True,
                                     step_masks=one[:, None].expand_as(
                                         torch.from_numpy(m)))
            for g1, ge in zip(got1, every):
                torch.testing.assert_close(g1, ge, rtol=0, atol=0)
            return
    assert len(got) == len(out) == 4
    assert got[3].shape == (B, m.shape[1], 8, DISCRETE.discrete_step)
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    ref = bridged(params, new_stats, DISCRETE)
    for k, v in actor.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), ref[k], atol=1e-5,
                                       err_msg=k)


def test_discrete_supervised_step_matches_jax(batch, discrete_sup):
    """`discrete_param_loss` on given bin log-probs, and one supervised
    step in the discrete mode with per-step BatchNorm: the loss and every
    gradient (the bin logits' columns of fc2 among them) against the
    trainer's loss in JAX, with `check_train_step`'s tolerances."""
    lp = np.random.default_rng(4).normal(size=(B, 3, 8, 10))
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(lp, jnp.float32)))
    y = batch["y"][:, :5]
    gp = batch["gt_params"][:, :3]
    want = jloop.discrete_param_loss(jnp.asarray(lp), jnp.asarray(y),
                                     jnp.asarray(gp), JOperatorConfig())
    got = loop.discrete_param_loss(torch.from_numpy(lp), torch.from_numpy(y),
                                   torch.from_numpy(gp), OPCFG)
    assert float(want) != 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    _, params, stats, _, jl, _, new_stats, grads = discrete_sup
    actor = port_actor(DISCRETE, V, params, stats)
    pm = loop.supervised_step(loop.TrainState(actor, learning_rate=LR),
                              _t(batch, SUP_KEYS + ("gt_params",)),
                              per_step_bn=True)
    np.testing.assert_allclose(float(pm["loss"]), float(jl), rtol=1e-5)
    # the bins of contrast and sharpness (the batch's discrete-capable ops)
    for op in (actor.executor.contrast_op, actor.executor.sharpness_op):
        assert op.fc2.weight.grad[1:].abs().max() > 0
    assert_grads_and_stats_match(actor, bridged(grads, stats, DISCRETE),
                                 bridged(params, new_stats, DISCRETE))


# ---------------------------------------------------------------------------
# episodes: probe resolution, sampled bins, parameter noise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rollout():
    """One train-mode episode of a discrete actor at 32 px, decoded at a
    16 px probe (an antialiased bilinear view), with sampled ops, sampled
    bins and parameter noise 0.6, and its L1's gradients: JAX's in one
    jitted value_and_grad of its trainer's loss, the port's on JAX's
    draws (per step: op Gumbel, bin Gumbel, normal). Returns the port
    actor (gradients in `.grad`), its rollout and L1, JAX's (loss, outputs,
    new stats, gradients, params, stats) and the batch.

    At 32 px, not the other tests' 16: a probe of 8 px leaves 1 x 1 maps
    from the second stage on, where flax's one-pass variance in train BN
    puts JAX's f32 conv1 gradient 7.8e-3 from f64 and the port's 2.7e-4
    (measured); at 16 px of 32 both sit within 1.1e-4 of f64."""
    ds = JSyntheticFiveK(n=8, img_size=32, seed=0, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    batch = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1]}
    ja, params, stats, actor = _actors(DISCRETE, batch, seed=9)
    key = jax.random.PRNGKey(12)

    def loss(p):
        out, upd = ja.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(batch["x"]),
                            jnp.asarray(batch["img_x"]), rng=key,
                            sample=True, param_noise=0.6, probe_size=16,
                            train=True, mutable=["batch_stats"],
                            method=JActor.episode)
        l1 = jloop.episode_l1_loss(out["imgs"], out["ops"],
                                   jnp.asarray(batch["gt_img"]))
        return l1, (out, upd["batch_stats"])

    (jl, (jout, jstats)), jg = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    gumbels, normals = draw_sequence(
        key, DISCRETE.decoder_max_len, B, DISCRETE.op_vocab_size,
        discrete_step=DISCRETE.discrete_step, noise_shape=(B, 8, 24))
    pout = actor.train().episode(
        torch.from_numpy(batch["x"]), torch.from_numpy(batch["img_x"]),
        sample=True, param_noise=0.6, probe_size=16, noise_fn=fed(gumbels),
        normal_fn=fed(normals))
    pl = loop.episode_l1_loss(pout["imgs"], pout["ops"],
                              torch.from_numpy(batch["gt_img"]))
    pl.backward()
    return actor, pout, pl, (jl, jout, jstats, jg, params, stats), batch


def test_probe_episode_step_matches_jax(rollout):
    """The probe rollout (`rollout`): images at the full 32 px within
    1e-5, the L1, every gradient (through the resize into the ops'
    inputs, and past the sampled bins and the noise) and the BatchNorm
    statistics, with `check_train_step`'s tolerances."""
    actor, pout, pl, (jl, jout, jstats, jg, params, stats), _ = rollout
    assert pout["imgs"].shape[-1] == 32
    np.testing.assert_allclose(pout["imgs"].detach().numpy(),
                               np.asarray(jout["imgs"]), atol=1e-5)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    assert_grads_and_stats_match(actor, bridged(jg, stats, DISCRETE),
                                 bridged(params, jstats, DISCRETE))


def test_probe_resize_is_jax_bilinear():
    """The episode's probe view equals jax.image.resize(bilinear) when it
    shrinks (antialiased) and when it grows, and passes gradients."""
    img = np.random.default_rng(0).uniform(size=(2, 3, 16, 16)) \
        .astype(np.float32)
    actor = Actor(ModelConfig(**dataclasses.asdict(CFG)), OPCFG, V,
                  generator=torch.Generator().manual_seed(0))
    for size in (8, 5, 12, 24):
        t = torch.from_numpy(img).requires_grad_()
        got = actor._probe(t, size)
        want = jax.image.resize(jnp.asarray(img), (2, 3, size, size),
                                "bilinear")
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6)
        got.sum().backward()
        jg = jax.grad(lambda x: jax.image.resize(
            x, (2, 3, size, size), "bilinear").sum())(jnp.asarray(img))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5)
    assert actor._probe(torch.from_numpy(img), 16) is not None


def test_sampled_discrete_noisy_episode_matches_jax(rollout):
    """The same rollout's draws: the ops JAX sampled, the chosen params
    (sampled bins on their grid, noise added) and the log-probs within
    1e-5; and without a generator or fed draws the rollout refuses to
    sample."""
    actor, pout, _, (_, jout, _, _, _, _), batch = rollout
    np.testing.assert_array_equal(pout["ops"].numpy(),
                                  np.asarray(jout["ops"]))
    assert (pout["ops"] >= 3).any()
    for k in ("params", "logprobs"):
        np.testing.assert_allclose(pout[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=1e-5,
                                   err_msg=k)
    with pytest.raises(ValueError, match="generator"):
        actor.episode(torch.from_numpy(batch["x"]),
                      torch.from_numpy(batch["img_x"]), param_noise=0.6)


@pytest.mark.parametrize("depth", [50, 101, 152])
def test_actor_runs_each_mode(depth):
    """Actor(cfg) builds and runs at every Bottleneck depth with bf16,
    discrete params, per-step BN, a probe and parameter noise (port
    only; JAX parity is above)."""
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        CFG, resnet_depth=depth, vis_bf16=True, discrete_param=True)))
    actor = Actor(cfg, OPCFG, V, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(4, V, (2, L)))
    img = torch.from_numpy(rng.uniform(size=(2, 3, 16, 16))
                           .astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    out = actor.train().episode(x, img, sample=True, generator=gen,
                                param_noise=0.6, probe_size=8)
    assert out["imgs"].shape == (2, 3, 3, 16, 16)
    assert torch.isfinite(out["imgs"]).all()
    y = torch.tensor([[1, 3, 4, 2, 0]] * 2)
    sup = actor.supervised(x, y, img, img[:, None].expand(2, 4, 3, 16, 16),
                           per_step_bn=True)
    assert len(sup) == 4 and torch.isfinite(sup[1]).all()
