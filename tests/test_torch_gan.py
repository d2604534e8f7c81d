"""The GAN half of the port (t2onet_tpu_torch.models.gan, cli/train_gan,
the GAN weights bridges) against the JAX package, at tiny widths.

One JAX `DiscBundle` init (its BatchNorms given non-trivial scales,
biases and statistics) is carried into the port by
`convert.load_jax_disc`; the reference checkpoint's key map is checked
through JAX's own `convert_gan_state_dict`. Compared: the multiscale
discriminator in train and eval mode, the losses (LSGAN and BCE, feature
matching, every `parts` of `Seq2SeqGANLosses` with a pseudo-real) and
their gradients, the once-an-iteration BatchNorm update, one whole GAN
iteration against JAX's jitted `make_gan_step` (the rollout through the
bank, and through the fused step against JAX's Pallas step in interpret
mode), and `last_valid_teacher`.

Tolerances: forwards and losses 1e-5 (relative for losses, absolute on
unit-scale maps); gradients within 1e-4 of their tensor's norm (the
actor's in the whole GAN iteration: 2e-3, see its test); BatchNorm
statistics 1e-5; updated parameters 1e-6 where the gradient stands clear
of Adam's eps.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2onet_tpu.cli import train_gan as jtg
from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.convert.torch_checkpoint import convert_gan_state_dict
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.models import gan as jgan
from t2onet_tpu.models.actor import Actor as JActor
from t2onet_tpu_torch.cli import train_gan
from t2onet_tpu_torch.config import ModelConfig as PModelConfig
from t2onet_tpu_torch.config import OperatorConfig as POperatorConfig
from t2onet_tpu_torch.convert import (disc_variables_to_state_dict,
                                      load_jax_disc, load_torch_gan_checkpoint)
from t2onet_tpu_torch.models import gan
from t2onet_tpu_torch.models.actor import Actor as PActor
from t2onet_tpu_torch.train.loop import TrainState
from tests._torch_port import (flat, gumbel_draws, jax_actor, jax_disc,
                               jax_train_state, plain as _plain,
                               port_actor, port_trees)

torch.set_num_threads(2)

B, H = 4, 16
CN, NDF = 16, 8                 # sentence code width, D's first width
L = 12
LR = 1e-3
CFG = JModelConfig.tiny(encoder_max_len=L, decoder_max_len=3)
V = len(synthetic_vocab())
HID = CFG.n_layers * 2 * CFG.hidden_size


@pytest.fixture(scope="module")
def disc_init():
    return jax_disc(CN, NDF, B, H, CFG.n_layers, HID // CFG.n_layers)


def _port_bundle(params, stats):
    bundle = gan.DiscBundle(HID, cond_nc=CN, ndf=NDF, n_layers=3, num_D=2)
    load_jax_disc(bundle, params, stats)
    return bundle


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x6 = rng.uniform(0, 1, (B, 6, H, H)).astype(np.float32)
    hid = rng.normal(0, 0.5, (CFG.n_layers, B, HID // CFG.n_layers)) \
        .astype(np.float32)
    return x6, hid


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _norm_close(got, want, rel, name="", floor=1e-5):
    """|got - want| <= rel |want| + floor in the 2-norm. The floor is for
    a bias that a BatchNorm follows: its true gradient is 0, and f32
    leaves rounding noise of up to ~4e-6 there (f64: pass 1e-9)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= rel * np.linalg.norm(want) + floor, (
        name, err, np.linalg.norm(want))


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(disc_init, train):
    """Every scale's every feature map, the full resolution first, from
    the condition encoder's code, in train (batch statistics) and eval
    (running averages) mode."""
    jb, params, stats = disc_init
    x6, hid = _inputs()
    cond, _ = jb.apply(params, stats, None, jnp.asarray(hid), train=train)
    want = jb.disc_apply(params, stats, train=train)(jnp.asarray(x6), cond)
    bundle = _port_bundle(params, stats).train(train)
    with torch.no_grad():
        pc = bundle.cond_encoder(torch.from_numpy(hid))
        got = bundle.netD(torch.from_numpy(x6), pc)
    _close(pc, cond)
    assert [len(s) for s in got] == [len(s) for s in want] == [6, 6]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert tuple(g.shape) == (w.shape[0], w.shape[3], w.shape[1],
                                      w.shape[2])
            _close(g, np.transpose(np.asarray(w), (0, 3, 1, 2)))
    assert got[1][-1].shape[-1] < got[0][-1].shape[-1]
    # a train-mode loss pass leaves the running averages as they were
    sd = _port_bundle(params, stats).state_dict()
    for k, v in bundle.state_dict().items():
        if "running" in k:
            assert torch.equal(v, sd[k]), k


def test_update_stats_matches_jax(disc_init):
    jb, params, stats = disc_init
    x6, hid = _inputs(1)
    want = jb.update_stats(params, stats, jnp.asarray(x6), jnp.asarray(hid))
    bundle = _port_bundle(params, stats)
    bundle.update_stats(torch.from_numpy(x6), torch.from_numpy(hid))
    wsd = disc_variables_to_state_dict(params, _plain(want))
    for k, v in bundle.state_dict().items():
        if "running" in k:
            _close(v, wsd[k], 1e-6)
        elif not k.endswith("num_batches_tracked"):
            assert np.array_equal(v.numpy(), wsd[k]), k


def test_avg_pool_counts_only_real_pixels():
    x = np.random.default_rng(2).uniform(0, 1, (2, 6, 9, 8)) \
        .astype(np.float32)
    _close(gan.avg_pool_3s2(torch.from_numpy(x)),
           jgan._avg_pool_3s2(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("lsgan", [True, False])
def test_gan_and_feature_losses_match_jax(disc_init, lsgan):
    jb, params, stats = disc_init
    x6, hid = _inputs(2)
    cond, _ = jb.apply(params, stats, None, jnp.asarray(hid), train=False)
    jd = jb.disc_apply(params, stats, train=False)
    a = jd(jnp.asarray(x6), cond)
    b = jd(jnp.asarray(x6[::-1].copy()), cond)
    bundle = _port_bundle(params, stats).eval()
    with torch.no_grad():
        pc = bundle.cond_encoder(torch.from_numpy(hid))
        pa = bundle.netD(torch.from_numpy(x6), pc)
        pb = bundle.netD(torch.from_numpy(x6[::-1].copy()), pc)
    for real in (True, False):
        _close(float(gan.gan_loss(pa, real, lsgan)),
               float(jgan.gan_loss(a, real, lsgan)))
    _close(float(gan.feature_matching_loss(pa, pb)),
           float(jgan.feature_matching_loss(a, b)))
    with torch.no_grad():
        dists = gan.disc_dists(bundle.netD, torch.from_numpy(x6[:, :3]),
                               torch.from_numpy(x6[:, 3:]), pc)
        score = gan.disc_score(bundle.netD, torch.from_numpy(x6[:, :3]),
                               torch.from_numpy(x6[:, 3:]), pc)
    _close(dists, jgan.disc_dists(jd, jnp.asarray(x6[:, :3]),
                                  jnp.asarray(x6[:, 3:]), cond))
    _close(float(score), float(jgan.disc_score(jd, jnp.asarray(x6[:, :3]),
                                               jnp.asarray(x6[:, 3:]), cond)))


def _part_total(ld, parts):
    if parts == "g":
        return ld["G_GAN"] + ld["G_GAN_Feat"]
    if parts == "d":
        return ld["D_fake"] + ld["D_real"]
    return sum(ld.values())


def _port_losses(bundle, arrays, hid, parts, dtype):
    """The port's loss terms for `parts` in `dtype`, backpropagated:
    (terms, the fake image's gradient, each weight's gradient)."""
    src, fake, trg, pseudo = (torch.from_numpy(a).to(dtype) for a in arrays)
    bundle = bundle.to(dtype).train()
    fake.requires_grad_(True)
    ld = gan.Seq2SeqGANLosses(n_layers=3, num_D=2)(
        bundle.netD, src, fake, trg,
        bundle.cond_encoder(torch.from_numpy(hid).to(dtype)),
        pseudo_real=pseudo, parts=parts)
    _part_total(ld, parts).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .double().numpy() for n, p in bundle.named_parameters()}
    return ({k: float(v.detach()) for k, v in ld.items()},
            None if fake.grad is None else fake.grad.double().numpy(), grads)


@pytest.mark.parametrize("parts", ["all", "g", "d"])
def test_seq2seq_gan_losses_and_grads_match_jax(disc_init, parts):
    """Each loss term, and the gradient of the part's total: to the fake
    image for G ('g', 'all'), to every discriminator weight for D ('d'),
    with train-mode BatchNorm and a pseudo-real. The semantics are held
    in f64, JAX's (under jax.enable_x64) against the port's, to 1e-6 of
    each gradient's norm; the port's f32 is held to its f64 to 1e-4.
    (JAX's own f32 sits up to 1.5e-3 from f64 on the half-resolution
    scale: flax's BatchNorm takes the variance as E[x^2] - E[x]^2.)"""
    jb, params, stats = disc_init
    rng = np.random.default_rng(3)
    arrays = [rng.uniform(0, 1, (B, 3, H, H)).astype(np.float32)
              for _ in range(4)]
    _, hid = _inputs(3)
    jl = jgan.Seq2SeqGANLosses(n_layers=3, num_D=2)

    with jax.enable_x64(True):
        d64 = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64),
                                     (params, stats, arrays, hid))
        p64, s64, (src, fake, trg, pseudo), h64 = d64

        def jtotal(dparams, fk):
            cond, _ = jb.apply(dparams, s64, None, h64)
            ld = jl(jb.disc_apply(dparams, s64), src, fk, trg, cond,
                    pseudo_real=pseudo, parts=parts)
            return _part_total(ld, parts), ld

        (_, jld), (jgd, jgf) = jax.jit(jax.value_and_grad(
            jtotal, argnums=(0, 1), has_aux=True))(p64, fake)
        jld = {k: float(v) for k, v in jld.items()}
        jgf = np.asarray(jgf)
        # in the port's names (the bridge rounds them to f32: 6e-8)
        jsd = disc_variables_to_state_dict(_plain(jgd), stats)

    l64, f64, g64 = _port_losses(_port_bundle(params, stats), arrays, hid,
                                 parts, torch.float64)
    l32, f32, g32 = _port_losses(_port_bundle(params, stats), arrays, hid,
                                 parts, torch.float32)
    for k in jld:
        np.testing.assert_allclose(l64[k], jld[k], rtol=1e-9, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(l32[k], l64[k], rtol=1e-5, err_msg=k)
    if parts != "d":
        _norm_close(f64, jgf, 1e-6, "fake", floor=1e-9)
        _norm_close(f32, f64, 1e-4, "fake")
    for n in g64:
        _norm_close(g64[n], jsd[n], 1e-6, n, floor=1e-9)
        _norm_close(g32[n], g64[n], 1e-4, n)


def test_reference_gan_checkpoint_loads_by_name(disc_init, tmp_path):
    """A reference seq2seqGAN model.pth (actor.*, netD.*, cond_encoder.*;
    the LSTMs with both biases) made from the port's modules: JAX's key
    map reads it into the same discriminator, and the port's loader into
    an actor whose rollout matches JAX's converted actor."""
    jb, params, stats = disc_init
    bundle = _port_bundle(params, stats)
    x = np.zeros((B, L), np.int32)
    x[:, :4] = [1, 5, 9, 2]
    img = np.random.default_rng(4).uniform(0, 1, (B, 3, H, H)) \
        .astype(np.float32)
    ja, ap, ast_ = jax_actor(CFG, V, x, img, seed=5, knots_near_one=True)
    actor = port_actor(CFG, V, ap, ast_)
    sd = {f"actor.{k}": v.clone() for k, v in actor.state_dict().items()}
    for k in sd:
        if ".rnn.bias_hh_" in k:            # the reference's second bias
            sd[k] = torch.full_like(sd[k], 0.02)
            ih = k.replace("bias_hh_", "bias_ih_")
            sd[ih] = sd[ih] - 0.02
    sd.update({k: v.clone() for k, v in bundle.state_dict().items()})
    path = str(tmp_path / "model.pth")
    torch.save(sd, path)

    j_actor, (dp, ds) = convert_gan_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_D=2, n_layers_D=3,
        n_layers=CFG.n_layers)
    back = disc_variables_to_state_dict(dp, ds)
    for k, v in bundle.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(back[k], v.numpy()), k

    fresh = PActor(PModelConfig(**dataclasses.asdict(CFG)),
                   POperatorConfig(), V,
                   generator=torch.Generator().manual_seed(9))
    fresh_bundle = gan.DiscBundle(HID, cond_nc=CN, ndf=NDF)
    load_torch_gan_checkpoint(path, actor=fresh, bundle=fresh_bundle)
    for k, v in fresh_bundle.state_dict().items():
        assert torch.equal(v, bundle.state_dict()[k]), k
    want = jax.jit(lambda v, xx, im: ja.apply(v, xx, im,
                                              method=JActor.episode))(
        {"params": j_actor[0], "batch_stats": j_actor[1]}, jnp.asarray(x),
        jnp.asarray(img))
    with torch.no_grad():
        got = fresh.eval().episode(torch.from_numpy(x), torch.from_numpy(img))
    np.testing.assert_array_equal(got["ops"].numpy(), np.asarray(want["ops"]))
    _close(got["imgs"], want["imgs"])


def test_last_valid_teacher_matches_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (4, 5, 3, 4, 4)).astype(np.uint8)
    y[0, 2:4] = 0                  # truncated after step 2
    y[1, :4] = 0                   # no valid step: the first slot
    y[2, 1] = 0                    # a black step inside the trajectory
    for arr in (y, y.astype(np.float32) / 255.0):
        got = train_gan.last_valid_teacher(arr)
        want = jtg.last_valid_teacher(arr)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one whole GAN iteration against JAX's jitted step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_init(disc_init):
    ds_ = JSyntheticFiveK(n=8, img_size=H, seed=0, req_max_len=L,
                          op_max_len=CFG.decoder_max_len)
    nb = next(ds_.batches(B, 1, shuffle=False))
    batch = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1]}
    ja, params, stats = jax_actor(CFG, V, batch["x"], batch["img_x"], seed=6,
                                  knots_near_one=True)
    return ja, params, stats, batch


def _jax_gan_step(ja, jb, params, stats, dparams, dstats, batch, key):
    tx_g = optax.adam(2e-4, b1=0.5, b2=0.999)
    tx_d = optax.adam(2e-4, b1=0.5, b2=0.999)
    jstate = jax_train_state(params, stats, LR)
    g = jtg.GANState(d_params=dparams, d_batch_stats=dstats,
                     d_opt=tx_d.init(dparams), g_opt=tx_g.init(jstate.params))
    step = jtg.make_gan_step(ja, jb, jgan.Seq2SeqGANLosses(n_layers=3,
                                                           num_D=2),
                             tx_g, tx_d)
    return step(jstate, g, {k: jnp.asarray(v) for k, v in batch.items()},
                key)


@pytest.mark.parametrize("mode", ["bank", "fused"])
def test_gan_step_matches_jax(disc_init, step_init, monkeypatch, mode):
    """`gan_step` from one init and JAX's Gumbel draws: the six losses,
    the actor's gradients (G's Adam first moment, mu = 0.5 g), every
    discriminator gradient, the updated weights and both sides' BatchNorm
    statistics. 'bank' runs the rollout through the one-hot bank (JAX's
    trainer as it is); 'fused' through the fused step (`--fused_exec 1`)
    against JAX's rollout with `pallas_exec=True`, Pallas in interpret
    mode.

    The actor's gradients are held to 2e-3 of their norm: they come
    back through D, the <END> image and three sampled rollout steps of
    train-mode BatchNorm over 4 images of 8 channels. The FiveK episode
    step alone (tests/test_torch_train.py, sampled through the bank)
    sits up to 1.15e-3 of the norm from JAX on the same tensors, and the
    GAN step measured 1.26e-3; a one-ulp nudge of the ResNet's kernels
    moves the port's own by 8e-5. D's gradients are held to 1e-4."""
    jb, dparams, dstats = disc_init
    ja, params, stats, batch = step_init
    if mode == "fused":
        class _Fused:
            @staticmethod
            def episode(m, *args, **kw):
                return JActor.episode(m, *args, pallas_exec=True, **kw)
        monkeypatch.setattr(jtg, "Actor", _Fused)
    key = jax.random.PRNGKey(3)
    jstate1, jgan1, jm = _jax_gan_step(ja, jb, params, stats, dparams,
                                       dstats, batch, key)
    draws = iter(gumbel_draws(key, (B, CFG.op_vocab_size),
                              CFG.decoder_max_len))

    def noise_fn(shape):
        return torch.from_numpy(next(draws).copy())

    pcfg_actor = port_actor(CFG, V, params, stats)
    pstate = TrainState(pcfg_actor, learning_rate=LR)
    g = train_gan.GANState(_port_bundle(dparams, dstats), pstate.params)
    pm = train_gan.gan_step(
        pstate, g, {k: torch.from_numpy(np.asarray(v))
                    for k, v in batch.items()},
        gan.Seq2SeqGANLosses(n_layers=3, num_D=2),
        fused_exec=mode == "fused", noise_fn=noise_fn)
    assert pstate.step == int(jstate1.step) == 1
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the actor: gradients, updated weights, BatchNorm statistics
    jg = flat(jax.tree_util.tree_map(lambda m: m / 0.5, jgan1.g_opt[0].mu))
    pg, _ = port_trees(pstate.actor, CFG.n_layers, grads=True)
    new_p, new_s = port_trees(pstate.actor, CFG.n_layers)
    jp, js = flat(jstate1.params), flat(jstate1.batch_stats)
    for k in jg:
        _norm_close(pg[k], jg[k], 2e-3, k)
        clear = np.abs(jg[k]) > max(1e-2 * np.abs(jg[k]).max(), 1e-6)
        np.testing.assert_allclose(new_p[k][clear], jp[k][clear], atol=1e-6,
                                   rtol=0, err_msg=k)
    for k in js:
        np.testing.assert_allclose(new_s[k], js[k], atol=1e-5, err_msg=k)
    # the discriminator: gradients, weights, the once-an-iteration stats
    jdg = disc_variables_to_state_dict(
        _plain(jax.tree_util.tree_map(lambda m: m / 0.5, jgan1.d_opt[0].mu)),
        dstats)
    jnew = disc_variables_to_state_dict(_plain(jgan1.d_params),
                                        _plain(jgan1.d_batch_stats))
    for n, p in g.bundle.named_parameters():
        _norm_close(p.grad, jdg[n], 1e-4, n)
        clear = np.abs(jdg[n]) > max(1e-2 * np.abs(jdg[n]).max(), 1e-5)
        np.testing.assert_allclose(p.detach().numpy()[clear], jnew[n][clear],
                                   atol=1e-6, rtol=0, err_msg=n)
    # the conv bias before each BatchNorm has a true gradient of 0, so its
    # first Adam step (+-lr) follows rounding noise; the running mean
    # takes 0.1 of that shift, at most 0.1 * 2 * lr = 4e-5 apart
    for n, v in g.bundle.state_dict().items():
        if "running" in n:
            tol = 1e-5 + (4e-5 if "running_mean" in n else 0.0)
            np.testing.assert_allclose(v.numpy(), jnew[n], atol=tol,
                                       err_msg=n)


def test_port_sources_import_no_jax():
    """No module of t2onet_tpu_torch, nor chip_smoke.py, imports jax or
    the JAX package (every import statement, at any depth)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "t2onet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "t2onet_tpu"):
                    bad.append(f"{path}:{node.lineno} {m}")
    assert not bad, bad
