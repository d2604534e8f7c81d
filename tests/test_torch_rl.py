"""RL fine-tuning in the port against the JAX package at tiny widths
(ResNet widths 4,4,8,8, one LSTM layer, 16 px): `rl_losses` and their
gradients, `get_entropy_penalty`, two chained `Actor.rl_step` calls and
one RL training step (sampled ops, parameter noise 0.6, through the
bank) on JAX's draws; then a tiny `cli.train_rl` run that checkpoints
and resumes. Tolerances as tests/test_torch_train.py."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.models import actor as jactor
from t2onet_tpu.train import rl as jrl
from t2onet_tpu_torch.cli import common, train_rl
from t2onet_tpu_torch.models import actor as pactor
from t2onet_tpu_torch.train import loop, rl
from t2onet_tpu_torch.train.checkpoint import CheckpointManager
from tests._torch_port import (check_train_step_bridged, draw_sequence, fed,
                               jax_actor, jax_train_state, port_actor)

torch.set_num_threads(2)

L = 12
B = 4
LR = 1e-3
V = len(synthetic_vocab())
CFG = JModelConfig(encoder_max_len=L, decoder_max_len=3, n_layers=1,
                   hidden_size=8, word_vec_dim=8, operator_fc_dim=8,
                   vis_feat_dim=8, resnet_widths=(4, 4, 8, 8))
ENTROPY = 0.01


@pytest.fixture(scope="module")
def batch():
    ds = JSyntheticFiveK(n=8, img_size=16, seed=0, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    return {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1]}


def _rollout(seed=0, b=5, s=4, n_cls=11, hw=6):
    """A rollout dict: ops with <END> first at step 0, 2, never, and
    twice; images equal to the ground truth at some pixels (|.| at 0)."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(3, n_cls, (b, s))
    ops[0, 0] = ops[1, 2] = ops[3, 1] = ops[3, 3] = ops[4, 3] = 2
    imgs = rng.uniform(0, 1, (b, s, 3, hw, hw)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, 3, hw, hw)).astype(np.float32)
    gt[:, :, :2] = imgs[:, -1, :, :2]
    gt[0, :, :3] = imgs[0, 0, :, :3]
    logits = rng.normal(size=(b, s, n_cls)).astype(np.float32)
    logprobs = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    return imgs, ops, logprobs, gt


@pytest.mark.parametrize("pg_weight", [0.1, 1.0])
def test_rl_losses_and_grads_match_jax(pg_weight):
    """The total, each metric, and the gradients to the images and the
    log-probs (the REINFORCE and entropy terms) within 1e-5."""
    imgs, ops, logprobs, gt = _rollout()

    def jtotal(i, lp):
        return jrl.rl_losses({"imgs": i, "ops": jnp.asarray(ops),
                              "logprobs": lp}, jnp.asarray(gt),
                             entropy_factor=ENTROPY, pg_weight=pg_weight)

    (jt, jm), (jgi, jglp) = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(imgs),
                                              jnp.asarray(logprobs))
    ti = torch.from_numpy(imgs).requires_grad_()
    tlp = torch.from_numpy(logprobs).requires_grad_()
    pt, pm = rl.rl_losses({"imgs": ti, "ops": torch.from_numpy(ops),
                           "logprobs": tlp}, torch.from_numpy(gt),
                          entropy_factor=ENTROPY, pg_weight=pg_weight)
    pt.backward()
    np.testing.assert_allclose(pt.item(), float(jt), rtol=1e-6)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=1e-8)
    np.testing.assert_allclose(tlp.grad.numpy(), np.asarray(jglp),
                               atol=1e-6)
    assert rl.ENTROPY_FACTOR == 0.01


def test_entropy_penalty_matches_jax():
    logprobs = _rollout()[2]
    got = pactor.get_entropy_penalty(torch.from_numpy(logprobs))
    want = jactor.get_entropy_penalty(jnp.asarray(logprobs))
    assert got.shape == want.shape == logprobs.shape[:-1] + (1,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _jax_two_rl_steps(mdl, x, img, k1, k2, masks):
    """Two chained `rl_step` calls from the <START> op."""
    _, hidden, _ = mdl.lang_encoder(x)
    carry = mdl.decoder.init_carry(hidden)
    op = jnp.full((x.shape[0],), mdl.cfg.start_id, jnp.int32)
    first = mdl.rl_step(x, img, carry, op, k1, param_noise=0.6, masks=masks)
    second = mdl.rl_step(x, first[0], first[5], first[6], k2,
                         param_noise=0.6, masks=masks, op_mask=first[7])
    return first, second


@pytest.fixture(scope="module")
def two_rl_steps(batch):
    """JAX's two chained RL steps of a discrete actor, one jit for both
    cases of the test below: per-op masks, or all-ones masks (which blend
    to exactly the unmasked result). Returns (cfg, params, stats, keys,
    masks, {case: outputs})."""
    cfg = dataclasses.replace(CFG, discrete_param=True)
    ja, params, stats = jax_actor(cfg, V, batch["x"], batch["img_x"],
                                  seed=3, knots_near_one=True)
    masks = np.random.default_rng(2).uniform(
        0, 1, (B, cfg.op_vocab_size, 1, 16, 16)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(21))
    run = jax.jit(lambda v, x, img, k, m: ja.apply(
        v, x, img, k[0], k[1], m, method=_jax_two_rl_steps))
    v = {"params": params, "batch_stats": stats}
    x, img = jnp.asarray(batch["x"]), jnp.asarray(batch["img_x"])
    want = {"masked": run(v, x, img, keys, jnp.asarray(masks)),
            "unmasked": run(v, x, img, keys, jnp.ones_like(masks))}
    return cfg, params, stats, keys, masks, want


@pytest.mark.parametrize("case", ["unmasked", "masked"])
def test_actor_rl_step_matches_jax(batch, two_rl_steps, case):
    """Two chained RL steps of a discrete actor (sampled bins, parameter
    noise 0.6; without masks, or with per-op masks), each with its key's
    draws fed in JAX's order (op, bins, noise): images, log-probs,
    entropy penalty, both contexts, the carry, the ops and the op
    mask."""
    cfg, params, stats, keys, masks, want = two_rl_steps
    actor = port_actor(cfg, V, params, stats)
    pmasks = torch.from_numpy(masks) if case == "masked" else None
    x = torch.from_numpy(batch["x"])
    with torch.no_grad():
        carry = actor.decoder.init_carry(actor.lang_encoder(x)[1])
    img = torch.from_numpy(batch["img_x"])
    op = torch.full((B,), cfg.start_id, dtype=torch.long)
    op_mask = None
    for k, w in zip(keys, want[case]):
        gumbels, normals = draw_sequence(
            k, 1, B, cfg.op_vocab_size, discrete_step=cfg.discrete_step,
            noise_shape=(B, 8, 24))
        with torch.no_grad():
            got = actor.rl_step(x, img, carry, op, noise_fn=fed(gumbels),
                                normal_fn=fed(normals), param_noise=0.6,
                                masks=pmasks, op_mask=op_mask)
        img, carry, op, op_mask = got[0], got[5], got[6], got[7]
        for i, (g, jw) in enumerate(zip(got, w)):
            if i == 5:
                g = [t for hc in g for t in hc]
                jw = [t for hc in jw for t in hc]
            else:
                g, jw = [g], [jw]
            for a, b in zip(g, jw):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5, err_msg=str(i))


def test_rl_step_matches_jax(batch):
    """One RL training step, sampled ops and parameter noise 0.6 on
    JAX's draws, through the bank, entropy factor 0.01: the loss and its
    terms, every gradient, the updated parameters and the BatchNorm
    statistics."""
    ja, params, stats = jax_actor(CFG, V, batch["x"], batch["img_x"],
                                  seed=6, knots_near_one=True)
    key = jax.random.PRNGKey(4)
    jstate1, jm = jrl.make_rl_step(ja, entropy_factor=ENTROPY, donate=False,
                                   param_noise=0.6)(
        jax_train_state(params, stats, LR),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    gumbels, normals = draw_sequence(key, CFG.decoder_max_len, B,
                                     CFG.op_vocab_size, noise_shape=(B, 8, 24))
    pstate = loop.TrainState(port_actor(CFG, V, params, stats),
                             learning_rate=LR)
    pm = rl.rl_step(pstate, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, entropy_factor=ENTROPY,
                    param_noise=0.6, noise_fn=fed(gumbels),
                    normal_fn=fed(normals))
    assert sorted(pm) == sorted(jm)
    # the entropy term sums log(11) - H over the steps, with H within 1%
    # of log(11) = 2.398: f32 holds each difference to a few ulp of 2.4
    # (2.4e-7 each), so it is compared absolutely
    for k in ("rl_l1", "rl_pg", "rl_entropy", "rl_reward"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    check_train_step_bridged(pstate, jstate1, pm["rl_loss"], jm["rl_loss"],
                             params, stats, CFG, LR)


TINY = ["--synthetic", "--device", "cpu", "--synthetic_n", "16",
        "--batch_size", "4", "--img_size", "16", "--encoder_max_len", "12",
        "--decoder_max_len", "3", "--hidden_size", "8", "--word_vec_dim",
        "8", "--operator_fc_dim", "8", "--resnet_widths", "4,4,8,8",
        "--vis_feat_dim", "8", "--print_every", "2", "--checkpoint_every",
        "2", "--val_batches", "1", "--warmup", "2", "--param_noise", "0.6"]


def test_train_rl_runs_checkpoints_and_resumes(tmp_path):
    """A supervised warmup of 2 iterations, then RL; checkpoints under
    seq2seqRL_model with the sampling generator's state, which --resume
    restores; on policy (explore_prob 0) with entropy factor 0.01 by
    default."""
    run = tmp_path / "run"
    argv = TINY + ["--run_dir", str(run)]
    a = train_rl.train_parser().parse_args(argv)
    assert a.explore_prob == 0.0 and a.entropy_factor == 0.01
    state = train_rl.main(argv + ["--num_iters", "2"])
    assert state.step == 4
    ckdir = run / "seq2seqRL_model"
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "checkpoint_best.pt", "checkpoint_iter00000002.pt",
        "checkpoint_iter00000004.pt", "stats.json"]
    recs = [json.loads(line) for line in open(run / "rl_metrics.jsonl")]
    assert "loss" in recs[0] and "rl_pg" in recs[-2]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    blob = torch.load(ckdir / "checkpoint_iter00000004.pt",
                      weights_only=True)
    assert blob["step"] == 4 and "generator" in blob
    # a fresh state restored from the latest checkpoint equals the run's
    actor, _ = common.build_actor(a, V)
    fresh = loop.TrainState(actor)
    gen = torch.Generator()
    CheckpointManager(str(ckdir)).restore(fresh, "latest", generator=gen)
    for (n, p), (_, q) in zip(fresh.actor.state_dict().items(),
                              state.actor.state_dict().items()):
        assert torch.equal(p, q), n
    assert torch.equal(gen.get_state(), blob["generator"])
    resumed = train_rl.main(argv + ["--num_iters", "4", "--resume"])
    assert resumed.step == 6
    assert (ckdir / "checkpoint_iter00000006.pt").exists()
