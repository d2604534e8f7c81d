"""The reference held to the port at a tiny width on the CPU: the same
weights from `weights.make_weights`, the same inputs. The reference
imports nothing of the port; this test imports both."""

import numpy as np
import pytest
import torch

from benchmark.reference import model as RM
from benchmark.reference import ops as RO
from benchmark.weights import make_weights
from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.ops.chain import fused_chain_reference
from t2onet_tpu_torch.train.loop import (TrainState, episode_step,
                                         supervised_step)

MC = ModelConfig.tiny(decoder_max_len=5)
CFG = dict(resnet_widths=list(MC.resnet_widths), vis_feat_dim=MC.vis_feat_dim,
           word_vec_dim=MC.word_vec_dim, hidden_size=MC.hidden_size,
           n_layers=2, op_vocab_size=11, operator_fc_dim=MC.operator_fc_dim,
           decoder_max_len=5, encoder_max_len=17)
OPC = dict(brightness_range=2.0, saturation_range=[-0.2, 0.8],
           sharpness_range=1.5)
V, B, H = 40, 6, 32


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    RM.set_precision("f32", "cpu")
    W = make_weights(CFG, V, 123, "cpu")
    g = np.random.default_rng(0)
    x = np.zeros((B, 17), np.int64)
    for i in range(B):
        n = int(g.integers(3, 15))
        x[i, 0] = 1
        x[i, 1:n] = g.integers(4, V, n - 1)
        x[i, n] = 2
    img = torch.from_numpy(g.random((B, 3, H, H)).astype(np.float32))
    return W, torch.from_numpy(x), img, g


def port_actor(W):
    actor = Actor(MC, OperatorConfig(), V,
                  generator=torch.Generator().manual_seed(0))
    actor.load_state_dict(W, strict=True)
    return actor


def test_names_and_trainable_leaves_match(setup):
    W = setup[0]
    actor = port_actor(W)
    names = RM.trainable_names(RM.param_specs(CFG, V))
    assert names == [n for n, p in actor.named_parameters()
                     if p.requires_grad]


def test_decode(setup):
    W, x, img, _ = setup
    actor = port_actor(W).eval()
    with torch.no_grad():
        out = actor.episode(x, img)
    ops, params = out["ops"], out["params"]
    after = (torch.cumsum((ops == 2).int(), 1) - (ops == 2).int()) > 0
    served = torch.where(after, torch.full_like(ops, -1), ops)
    gaps, ref = RM.decode(W, CFG, OPC, x, img, served_ops=served)
    assert float(gaps.max()) < 1e-5
    assert float((ref - params)[~after].abs().max()) < 1e-5
    own_ops, own = RM.decode(W, CFG, OPC, x, img)
    assert torch.equal(own_ops, ops)


def test_chain_forward_equals_the_port(setup):
    _, _, img, g = setup
    slots = torch.from_numpy(g.integers(0, 9, (B, 4))).int()
    params = torch.from_numpy(g.random((B, 4, 24)).astype(np.float32))
    mask = torch.from_numpy((g.random((B, 1, H, H)) > 0.5)
                            .astype(np.float32))
    for m in (None, mask):
        assert torch.equal(RO.chain_forward(img, slots.long(), params, m),
                           fused_chain_reference(img, slots, params, m))


def _grad_gap(state, P):
    worst = 0.0
    norms = {n: float(P[n].grad.norm()) if P[n].grad is not None else 0.0
             for n in P if P[n].requires_grad}
    med = float(np.median(list(norms.values())))
    for n, p in state.actor.named_parameters():
        if not p.requires_grad or norms[n] < 1e-3 * med:
            continue
        prog = float(state.opt.state[p]["exp_avg"].norm()) / 0.1
        worst = max(worst, abs(prog - norms[n]) / max(norms[n], med))
    return worst


def test_supervised_step(setup):
    W, x, img, g = setup
    T = 7
    y = np.zeros((B, T), np.int64)
    y[:, 0] = 1
    for i in range(B):
        n = int(g.integers(1, 5))
        y[i, 1:n + 1] = g.choice([3, 4, 5, 6, 8, 9], n, replace=False)
        y[i, n + 1] = 2
    gt = torch.zeros((B, T - 2, 24))
    gt[:, :, :3] = torch.from_numpy(g.random((B, T - 2, 3))
                                    .astype(np.float32))
    gt[torch.from_numpy(y[:, 1:T - 1] < 3)] = 0.0
    batch = dict(x=x.int(), y=torch.from_numpy(y).int(), img_x=img,
                 img_y=torch.rand(B, T - 1, 3, H, H), gt_params=gt)
    state = TrainState(port_actor(W).train())
    loss = supervised_step(state, batch)["loss"]
    names = set(RM.trainable_names(RM.param_specs(CFG, V)))
    P = {k: v.clone().requires_grad_(k in names) for k, v in W.items()}
    ref = RM.supervised_loss(P, CFG, OPC, batch)
    ref.backward()
    assert abs(float(loss) - float(ref)) < 1e-6 * abs(float(ref))
    assert _grad_gap(state, P) < 1e-4


def test_masked_episode_step(setup):
    W, x, img, g = setup
    masks = torch.from_numpy((g.random((B, 11, 1, H, H)) > 0.5)
                             .astype(np.float32))
    gt = torch.from_numpy(g.random((B, 3, H, H)).astype(np.float32))

    def gumbel(step, shape):
        u = torch.rand(shape, generator=torch.Generator().manual_seed(
            1000 + step)).clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    calls = [0]

    def noise_fn(shape):
        calls[0] += 1
        return gumbel(calls[0] - 1, shape)

    batch = dict(x=x.int(), img_x=img, gt_img=gt, masks_vocab=masks)
    state = TrainState(port_actor(W).train())
    loss = episode_step(state, batch, sample=True, fused_exec=True,
                        noise_fn=noise_fn)["L1_loss"]
    names = set(RM.trainable_names(RM.param_specs(CFG, V)))
    P = {k: v.clone().requires_grad_(k in names) for k, v in W.items()}
    ref = RM.episode_loss(P, CFG, OPC, batch, gumbel)
    ref.backward()
    assert abs(float(loss) - float(ref)) < 1e-6 * abs(float(ref))
    assert _grad_gap(state, P) < 1e-4
