"""One supervised and one episode training step of the port
(t2onet_tpu_torch.train.loop) against the JAX package's jitted steps,
from one init carried across by the weights bridge, at tiny widths.

Compared after each step: the loss; every gradient (the port's `.grad`
through `convert_state_dict`, JAX's recovered from Adam's first moment
after one step, mu = 0.1 g); the BatchNorm running statistics; and the
Adam-updated parameters. Episode variants: greedy through the bank,
greedy through the fused step (`fused_exec` against JAX's
`pallas_exec`, Pallas in interpret mode), and sampled with JAX's own
Gumbel draws fed to the port. The four repairs of the port's training
semantics each have a test of their own here: the one trainable LSTM
bias, flax's BatchNorm statistics, and Adam stepping parameters that got
no gradient (the tie-gradient repair is in test_torch_step.py).

Tolerances: gradients within 2e-3 of the largest gradient of their
tensor plus 1e-8, plus rtol 1e-3 (measured up to 1.2e-4 in the
supervised step and ~1e-3 in the episode step: f32 convolutions summed
in other orders, through train-mode BatchNorm over as few as 4 images of
8 channels, back through three rollout steps; a bias whose true
gradient is 0 carries rounding noise of ~1e-11); BN statistics 1e-5;
updated parameters 1e-6 wherever the gradient stands clear of that
tolerance and of Adam's eps (|g| above ten times it and above 1e-6). Adam's first step moves every parameter by
lr * g / (|g| + eps), so where g is rounding noise (a bias before a
BatchNorm, whose true gradient is 0) or near eps, the step follows the
noise, and there only its size, at most lr, is checked."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.models.actor import Actor as JActor
from t2onet_tpu.train import loop as jloop
from t2onet_tpu_torch.train import loop
from tests._torch_port import (check_train_step, flat as _flat,
                               gumbel_draws as _gumbel_draws, jax_actor,
                               jax_train_state, port_actor, port_trees)

torch.set_num_threads(2)

L = 12
B = 4
LR = 1e-3
CFG = JModelConfig.tiny(encoder_max_len=L, decoder_max_len=3)
V = len(synthetic_vocab())


@pytest.fixture(scope="module")
def init():
    ds = JSyntheticFiveK(n=8, img_size=16, seed=0, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    batch = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    batch["gt_img"] = nb["img_y"][:, -1]
    ja, params, stats = jax_actor(CFG, V, batch["x"], batch["img_x"], seed=6,
                                  knots_near_one=True)
    return ja, params, stats, batch


@pytest.fixture(scope="module")
def jax_steps(init):
    """JAX's jitted steps, each built (and so compiled) once per module:
    "sup", and ("epi", sample, pallas_exec)."""
    ja = init[0]
    cache = {}

    def get(name, sample=False, fused=False):
        key = name if name == "sup" else (name, sample, fused)
        if key not in cache:
            cache[key] = (
                jloop.make_supervised_step(ja, donate=False) if name == "sup"
                else jloop.make_episode_step(ja, sample=sample, donate=False,
                                             pallas_exec=fused))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def sup_once(init, jax_steps):
    """One supervised step from the init in both frameworks."""
    _, params, stats, batch = init
    jstate1, jm = jax_steps("sup")(_jax_state(params, stats),
                                   _j(batch, SUP))
    pstate = _port_state(params, stats)
    pm = loop.supervised_step(pstate, _t(batch, SUP))
    return jstate1, jm, pstate, pm


def _jax_state(params, stats):
    return jax_train_state(params, stats, LR)


def _port_trees(actor, grads=False):
    return port_trees(actor, CFG.n_layers, grads)


def _check(pstate, jstate1, p_loss, j_loss, params0):
    check_train_step(pstate, jstate1, p_loss, j_loss, params0,
                     CFG.n_layers, LR)


def _port_state(params, stats):
    return loop.TrainState(port_actor(CFG, V, params, stats),
                           learning_rate=LR)


def _t(batch, keys):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in keys}


def _j(batch, keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


SUP = ("x", "y", "img_x", "img_y", "gt_params")
EPI = ("x", "img_x", "gt_img")


def test_supervised_step_matches_jax(init, sup_once):
    params = init[1]
    jstate1, jm, pstate, pm = sup_once
    for k in ("op_loss", "param_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    _check(pstate, jstate1, pm["loss"], jm["loss"], params)
    assert pstate.step == int(jstate1.step) == 1


@pytest.mark.parametrize("mode", ["greedy_bank", "greedy_fused",
                                  "sampled_bank"])
def test_episode_step_matches_jax(init, jax_steps, mode):
    _, params, stats, batch = init
    sample = mode.startswith("sampled")
    fused = mode.endswith("fused")
    key = jax.random.PRNGKey(3)
    jstate1, jm = jax_steps("epi", sample, fused)(
        _jax_state(params, stats), _j(batch, EPI), key)
    noise_fn = None
    if sample:
        draws = iter(_gumbel_draws(key, (B, CFG.op_vocab_size),
                                   CFG.decoder_max_len))

        def noise_fn(shape):
            return torch.from_numpy(next(draws).copy())

    pstate = _port_state(params, stats)
    pm = loop.episode_step(pstate, _t(batch, EPI), sample=sample,
                           fused_exec=fused, noise_fn=noise_fn)
    _check(pstate, jstate1, pm["L1_loss"], jm["L1_loss"], params)


def test_adam_steps_parameters_without_gradient(init, jax_steps, sup_once):
    """Supervised, then episode: the episode phase gives decoder.out_linear
    no gradient (ops are picked by argmax), and optax still applies the
    supervised step's momentum to it. The port fills a zero gradient."""
    _, params, stats, batch = init
    jstate, _ = jax_steps("epi")(sup_once[0], _j(batch, EPI),
                                 jax.random.PRNGKey(0))
    pstate = _port_state(params, stats)
    loop.supervised_step(pstate, _t(batch, SUP))
    loop.episode_step(pstate, _t(batch, EPI), sample=False)
    assert not pstate.actor.decoder.out_linear.weight.grad.any()
    got, _ = _port_trees(pstate.actor)
    want = _flat(jstate.params)
    for k in want:
        if "out_linear" in k:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=k)


def test_lstm_has_one_trainable_bias(sup_once):
    """An Adam step moves JAX's one LSTM bias by at most lr; the port's
    bias_hh stays 0 and out of training, so bias_ih moves as JAX's b."""
    jstate1, _, pstate, _ = sup_once
    rnns = {"decoder.rnn": jstate1.params["decoder"],
            "lang_encoder.rnn": jstate1.params["lang_encoder"]}
    for name, p in pstate.actor.named_parameters():
        if ".rnn.bias_hh" in name:
            assert not p.requires_grad and not p.any(), name
    for k in range(CFG.n_layers):
        got = pstate.actor.decoder.rnn.__getattr__(f"bias_ih_l{k}")
        want = np.asarray(rnns["decoder.rnn"][f"lstm_l{k}"]["b"])
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
        got = pstate.actor.lang_encoder.rnn.__getattr__(
            f"bias_ih_l{k}_reverse")
        want = np.asarray(rnns["lang_encoder.rnn"][f"lstm_l{k}_bwd"]["b"])
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)


@pytest.mark.parametrize("ndim", [2, 4])
def test_batchnorm_running_stats_match_flax(ndim):
    """One train-mode forward updates the running mean and variance as
    flax.linen.BatchNorm(momentum=0.9) does: biased variance, 0.9 of the
    old value kept. The output is the batch-normalised input."""
    import flax.linen as fnn

    from t2onet_tpu_torch.models.common import (FlaxBatchNorm1d,
                                                FlaxBatchNorm2d)

    rng = np.random.default_rng(5)
    shape = (6, 5) if ndim == 2 else (6, 5, 3, 4)            # torch layout
    x = (rng.normal(0.3, 1.5, shape)).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    xf = x if ndim == 2 else x.transpose(0, 2, 3, 1)         # flax: NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = {"params": {"scale": np.ones(5, np.float32),
                            "bias": np.zeros(5, np.float32)},
                 "batch_stats": {"mean": mean0, "var": var0}}
    yf, upd = bn.apply(variables, jnp.asarray(xf), mutable=["batch_stats"])
    port = (FlaxBatchNorm1d if ndim == 2 else FlaxBatchNorm2d)(
        5, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
        y = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=0)
    yf = np.asarray(yf) if ndim == 2 else np.asarray(yf).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(y, yf, atol=1e-5, rtol=0)
    port.eval()                         # eval mode reads the running stats
    with torch.no_grad():
        ye = port(torch.from_numpy(x)).numpy()
    rm = port.running_mean.numpy().reshape((1, 5) + (1,) * (ndim - 2))
    rv = port.running_var.numpy().reshape((1, 5) + (1,) * (ndim - 2))
    np.testing.assert_allclose(ye, (x - rm) / np.sqrt(rv + 1e-5), atol=1e-5)


def test_supervised_losses_position_mask():
    """Positions past the batch's longest op sequence are left out of the
    op NLL, as in the JAX package."""
    rng = np.random.default_rng(0)
    lp = np.log(rng.dirichlet(np.ones(11), (3, 6))).astype(np.float32)
    y = np.array([[1, 3, 2, 0, 0, 0, 0], [1, 4, 5, 2, 0, 0, 0],
                  [1, 2, 0, 0, 0, 0, 0]], np.int32)
    pp = rng.normal(size=(3, 5, 24)).astype(np.float32)
    gp = np.where(rng.uniform(size=(3, 5, 24)) > 0.7, 1.0, 0.0).astype(
        np.float32)
    want = jloop.supervised_losses(jnp.asarray(lp), jnp.asarray(pp),
                                   jnp.asarray(y), jnp.asarray(gp))
    got = loop.supervised_losses(*(torch.from_numpy(a) for a in
                                   (lp, pp, y, gp)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# -- the loader's host lengths through the steps ------------------------------

def _loader_batch(rows=B, seed=0):
    """A synthetic FiveK batch through `device_put_batch` on the CPU, its
    requests cut to a full-length, a one-token and two tied rows."""
    from t2onet_tpu_torch.data.loader import device_put_batch
    from t2onet_tpu_torch.data.synthetic import SyntheticFiveK

    ds = SyntheticFiveK(n=8, img_size=16, seed=seed, req_max_len=L,
                        op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(rows, 1, shuffle=False))
    x = nb["x"].copy()
    x[0] = np.where(x[0] == 0, x[0, 0], x[0])          # full length
    x[1, 1:] = 0                                        # one token
    x[3, 3:], x[2, 3:] = 0, 0                           # a tie at 3
    keys = ("y", "img_x", "img_y", "gt_params")
    host = {"x": x, **{k: nb[k] for k in keys},
            "gt_img": nb["img_y"][:, -1]}
    return device_put_batch(host, "cpu")


def test_device_put_batch_ships_host_lengths():
    from t2onet_tpu_torch.data.loader import LENGTHS_KEY, device_put_batch

    b = _loader_batch()
    lengths = b[LENGTHS_KEY]
    assert lengths.device.type == "cpu" and lengths.dtype == torch.int64
    assert torch.equal(lengths, (b["x"] != 0).sum(1))
    assert lengths.tolist()[:4] == [L, 1, 3, 3]
    assert LENGTHS_KEY not in device_put_batch(
        {"img_x": np.zeros((2, 3, 4, 4), np.uint8)}, "cpu")


def _run_step(kind, batch):
    """One step of `kind` from a fixed init: (its metrics, the actor's and
    (GAN) the discriminator's state, the request encoder's stats)."""
    from t2onet_tpu_torch.cli import train_gan
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.models import gan
    from t2onet_tpu_torch.models.actor import Actor

    cfg = ModelConfig.tiny(encoder_max_len=L, decoder_max_len=3)
    actor = Actor(cfg, OperatorConfig(), V,
                  generator=torch.Generator().manual_seed(5))
    state = loop.TrainState(actor, learning_rate=LR)
    gen = torch.Generator().manual_seed(9)
    bundle = None
    if kind == "supervised":
        m = loop.supervised_step(state, batch)
    elif kind == "episode":
        m = loop.episode_step(state, batch, generator=gen)
    else:
        torch.manual_seed(11)
        bundle = gan.DiscBundle(cfg.n_layers * 2 * cfg.hidden_size,
                                cond_nc=16, ndf=8)
        m = train_gan.gan_step(state, train_gan.GANState(bundle,
                                                         state.params),
                               batch, gan.Seq2SeqGANLosses(), generator=gen)
    tensors = dict(actor.state_dict())
    if bundle is not None:
        tensors.update({"D." + k: v for k, v in
                        bundle.state_dict().items()})
    return m, tensors, dict(actor.lang_encoder.stats)


@pytest.mark.parametrize("kind", ["supervised", "episode", "gan"])
def test_steps_with_host_lengths_equal_steps_without(kind):
    """A loader batch with its host lengths and the same batch without
    them give the same metrics and parameters, bit for bit; with them
    every encoder call packed from the host."""
    from t2onet_tpu_torch.data.loader import LENGTHS_KEY

    batch = _loader_batch()
    without = {k: v for k, v in batch.items() if k != LENGTHS_KEY}
    m1, t1, s1 = _run_step(kind, batch)
    m0, t0, s0 = _run_step(kind, without)
    assert sorted(m1) == sorted(m0)
    for k in m0:
        assert torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m0[k])), k
    assert sorted(t1) == sorted(t0)
    for k in t0:
        assert torch.equal(t1[k], t0[k]), k
    calls = 2 if kind == "gan" else 1
    assert s1 == {"calls": calls, "host_packed": calls}
    assert s0 == {"calls": calls, "host_packed": 0}
