"""The supervised training step as a CUDA graph (`train.loop` through
`utils.graphs`) and what it leaves as it was.

On the CPU, at tiny widths, in the default, the discrete and the
per-step-BN modes: the request encoder followed by
`Actor.teacher_forced` gives `Actor.supervised`'s outputs bit for bit;
the two-stage backward (the pass's gradients of the detached encoder
outputs fed to the encoder's backward) gives every parameter's gradient
of the one-stage backward; the step runs eagerly on the CPU and under a
data-parallel or a model group, counting no replay and no capture; the
step's forward span says it was not graphed.

On a CUDA card (marked `card`, skipped without one), at the training
cells' widths, b64 x 128 px, with cuDNN's deterministic algorithms: six
steps alternating supervised and sampled episode steps as the trainers
take them, graphed against eager from the same weights and batches, bit
for bit as two eager runs agree, with the FiveK and the GIER
configurations and the per-step-BN, discrete and bf16 modes; a capture
that changes no parameter, buffer or Adam state; a recapture after the
weights moved; a second batch shape with a graph of its own; the
counters."""

import functools
import types

import numpy as np
import pytest
import torch

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.data.loader import device_put_batch
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.train import loop
from t2onet_tpu_torch.train.loop import (TrainState, episode_step,
                                         supervised_step)
from t2onet_tpu_torch.utils import graphs, profiling

torch.set_num_threads(2)

TINY = ModelConfig.tiny(encoder_max_len=17, decoder_max_len=5)
MODES = {
    "default": (TINY, False),
    "discrete": (ModelConfig.tiny(encoder_max_len=17, decoder_max_len=5,
                                  discrete_param=True, discrete_step=10),
                 False),
    "per_step_bn": (TINY, True),
}
COUNTERS = ("supervised_steps", "supervised_graph_replays",
            "supervised_graph_captures")


def _actor(cfg, seed=0, vocab_size=None):
    return Actor(cfg, OperatorConfig(),
                 vocab_size or len(synthetic_vocab()),
                 generator=torch.Generator().manual_seed(seed))


def _tiny_batch(n=3, seed=0):
    ds = SyntheticFiveK(n=n, img_size=16, op_max_len=5, seed=seed)
    return device_put_batch({k: v for k, v in next(ds.batches(n, 1)).items()
                             if k != "req"}, "cpu")


def _flat(out):
    return [t for t in out if t is not None]


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_encoder_then_teacher_forced_is_supervised(mode):
    cfg, per_step_bn = MODES[mode]
    actor = _actor(cfg).train()
    b = _tiny_batch()
    state = {k: v.clone() for k, v in actor.state_dict().items()}
    want = actor.supervised(b["x"], b["y"], b["img_x"], b["img_y"],
                            per_step_bn=per_step_bn)
    moved = {k: v.clone() for k, v in actor.state_dict().items()}
    actor.load_state_dict(state)
    got = actor.teacher_forced(actor.lang_encoder(b["x"]), b["y"],
                               b["img_x"], b["img_y"],
                               per_step_bn=per_step_bn)
    assert len(got) == len(want) == (4 if cfg.discrete_param else 3)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    # the BatchNorm running statistics moved alike
    for k, v in actor.state_dict().items():
        assert torch.equal(v, moved[k]), k


def _one_stage(actor, b, per_step_bn):
    encoded = actor.lang_encoder(b["x"])
    loss = loop._teacher_forced_losses(actor, encoded, b, per_step_bn)[0]
    return torch.autograd.grad(loss, _trainable(actor), allow_unused=True)


def _trainable(actor):
    return [p for p in actor.parameters() if p.requires_grad]


def _two_stage(actor, b, per_step_bn):
    """The graph's split: the pass from detached encoder outputs, their
    gradients fed to the encoder's backward."""
    params = _trainable(actor)
    enc_out, (h, c), valid = actor.lang_encoder(b["x"])
    leaves = [t.detach().requires_grad_() for t in (enc_out, h, c)]
    loss = loop._teacher_forced_losses(
        actor, (leaves[0], (leaves[1], leaves[2]), valid), b,
        per_step_bn)[0]
    grads = torch.autograd.grad(loss, params + leaves, allow_unused=True)
    enc = torch.autograd.grad([enc_out, h, c], params, grads[len(params):],
                              allow_unused=True)
    out = []
    for g, e in zip(grads[:len(params)], enc):
        assert g is None or e is None    # the encoder's and the rest's
        out.append(g if e is None else e)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_stage_backward_gives_the_one_stage_gradients(mode):
    cfg, per_step_bn = MODES[mode]
    actor = _actor(cfg, seed=1).train()
    b = _tiny_batch(seed=1)
    state = {k: v.clone() for k, v in actor.state_dict().items()}
    want = _one_stage(actor, b, per_step_bn)
    actor.load_state_dict(state)
    got = _two_stage(actor, b, per_step_bn)
    names = [n for n, p in actor.named_parameters() if p.requires_grad]
    reached = 0
    for name, g, w in zip(names, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            reached += 1
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=name)
    assert reached == len(names)
    assert any(n.startswith("lang_encoder.") for n in names)


def _fake_cuda_batch(b):
    """The batch's shapes and dtypes on a CUDA device, for `_graph_key`
    alone (no card needed)."""
    cuda = torch.device("cuda", 0)
    return {k: types.SimpleNamespace(device=cuda, shape=v.shape,
                                     dtype=v.dtype)
            for k, v in b.items()}


def test_graph_key_engages_on_a_card_at_world_size_one(monkeypatch):
    state = TrainState(_actor(TINY))
    b = _tiny_batch()
    assert loop._graph_key(state, b, False) is None           # the CPU
    fake = _fake_cuda_batch(b)
    key = loop._graph_key(state, fake, False)
    assert key is not None and key[0] == torch.device("cuda", 0)
    assert loop._graph_key(state, fake, True) != key           # per_step_bn
    half = _fake_cuda_batch({k: v[:2] for k, v in b.items()})
    assert loop._graph_key(state, half, False) != key          # the shape
    with monkeypatch.context() as m:
        m.setattr(mesh, "active", lambda: True)
        assert loop._graph_key(state, fake, False) is None
    with monkeypatch.context() as m:
        m.setattr(mesh, "model_size", lambda: 2)
        assert loop._graph_key(state, fake, False) is None


def test_cpu_steps_run_eagerly_and_count():
    state = TrainState(_actor(TINY))
    assert state.stats == dict.fromkeys(COUNTERS, 0)
    b = _tiny_batch()
    for _ in range(2):
        supervised_step(state, b)
    episode_step(state, {"x": b["x"], "img_x": b["img_x"],
                         "gt_img": b["img_y"][:, -1]},
                 generator=torch.Generator().manual_seed(0), sample=True)
    assert state.stats == {"supervised_steps": 2,
                           "supervised_graph_replays": 0,
                           "supervised_graph_captures": 0}
    assert state.graphs.values() == [] and state.step == 3


def test_active_mesh_steps_run_eagerly(monkeypatch):
    """A data group reported active, its all-reduces over this one rank:
    the step is the eager one of world size 1 and counts no replay."""
    b = _tiny_batch()
    want = TrainState(_actor(TINY, seed=2))
    m_want = supervised_step(want, b)
    got = TrainState(_actor(TINY, seed=2))
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr(mesh.dist, "all_reduce", lambda t, **kw: None)
    m_got = supervised_step(got, b)
    assert got.stats == {"supervised_steps": 1,
                         "supervised_graph_replays": 0,
                         "supervised_graph_captures": 0}
    assert got.graphs.values() == []
    for k in m_want:
        torch.testing.assert_close(m_got[k], m_want[k], rtol=1e-6, atol=0)
    # the global BatchNorm's E[x^2] - E[x]^2 against the local one's
    for p, q in zip(got.params, want.params):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-6)


def test_forward_span_says_whether_graphed():
    state = TrainState(_actor(TINY))
    profiling.start_spans()
    try:
        supervised_step(state, _tiny_batch())
    finally:
        spans, dropped = profiling.take_spans()
    (fwd,) = [s for s in spans if s.name == "train.forward"]
    assert dropped == 0 and fwd.attrs == {"graphed": False}


# -- on the card --------------------------------------------------------------

BATCH, SIZE, REQ_LEN = 64, 128, 17
# (decoder_max_len, vocab, masks) of the FiveK and GIER configurations
DATA = {"fivek": (5, 918, False), "gier": (8, 3046, True)}
CARD_MODES = {                     # data, per_step_bn, ModelConfig extras
    "fivek": ("fivek", False, {}),
    "gier": ("gier", False, {}),
    "fivek_per_step_bn": ("fivek", True, {}),
    "fivek_discrete": ("fivek", False, {"discrete_param": True,
                                        "discrete_step": 10}),
    "fivek_bf16": ("fivek", False, {"vis_bf16": True}),
}
STEPS = 6


@pytest.fixture
def card(monkeypatch):
    """Skips the test where PyTorch finds no CUDA card. cuDNN takes its
    deterministic algorithms for the test: with its atomic weight
    gradients two eager runs part in the last bits, and the sampled
    rollouts and Adam's first steps (a sign for each gradient) carry
    that to every weight within a few steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from t2onet_tpu_torch.precision import set_cuda_precision

    set_cuda_precision()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    return torch.device("cuda", torch.cuda.current_device())


def _card_batches(data, steps, batch=BATCH, seed=0):
    """`steps` host batches, odd steps supervised (x, y, img_x, img_y,
    gt_params) and even ones episode (x, img_x, gt_img, with GIER's
    masks_vocab), as the trainers stage them: requests of 3-17 tokens,
    1-n_ops ops, images in (0.05, 0.95)."""
    n_ops, vocab, masks = DATA[data]
    rng = np.random.default_rng(seed)
    out = []
    for s in range(1, steps + 1):
        x = np.zeros((batch, REQ_LEN), np.int64)
        y = np.zeros((batch, n_ops + 2), np.int64)
        gt = np.zeros((batch, n_ops, 24), np.float32)
        for i in range(batch):
            n = int(rng.integers(3, REQ_LEN + 1))
            x[i, :n] = rng.integers(4, vocab, n)
            k = int(rng.integers(1, n_ops + 1))
            y[i, 0], y[i, 1:k + 1], y[i, k + 1] = 1, rng.integers(3, 11, k), 2
            gt[i, :k, 0] = rng.uniform(-0.5, 0.5, k)
        img_x = rng.uniform(0.05, 0.95, (batch, 3, SIZE, SIZE))
        img_y = rng.uniform(0.05, 0.95, (batch, n_ops + 1, 3, SIZE, SIZE))
        if s % 2:
            b = {"x": x, "y": y, "img_x": img_x.astype(np.float32),
                 "img_y": img_y.astype(np.float32), "gt_params": gt}
        else:
            b = {"x": x, "img_x": img_x.astype(np.float32),
                 "gt_img": img_y[:, -1].astype(np.float32)}
            if masks:
                b["masks_vocab"] = (rng.uniform(size=(batch, 11, 1, SIZE,
                                                      SIZE)) < 0.5
                                    ).astype(np.float32)
        out.append(b)
    return out


def _card_actor(mode, card):
    data, _, extra = CARD_MODES[mode]
    n_ops, vocab, _ = DATA[data]
    cfg = ModelConfig(encoder_max_len=REQ_LEN, decoder_max_len=n_ops,
                      **extra)
    return _actor(cfg, seed=3, vocab_size=vocab).to(card)


def _snapshot(state):
    """Every parameter, buffer and Adam moment, cloned."""
    out = {f"w.{k}": v.detach().clone()
           for k, v in state.actor.state_dict().items()}
    for i, p in enumerate(state.params):
        for k, v in state.opt.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def _run(mode, card, batches, graphed, monkeypatch, weights):
    """Train from `weights` over `batches`: (losses, Adam's first moments
    after each step, the state after the last)."""
    _, per_step_bn, _ = CARD_MODES[mode]
    actor = _card_actor(mode, card)
    actor.load_state_dict(weights)
    state = TrainState(actor)
    gen = torch.Generator(device=card).manual_seed(17)
    losses, moments = [], []
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(loop, "_graph_key", lambda *a: None)
        for s, host in enumerate(batches, start=1):
            b = device_put_batch(host, card)
            if s % 2:
                out = supervised_step(state, b, per_step_bn=per_step_bn)
                losses.append(out["loss"])
            else:
                out = episode_step(state, b, generator=gen, sample=True,
                                   fused_exec=True)
                losses.append(out["L1_loss"])
            moments.append(torch.cat([state.opt.state[p]["exp_avg"]
                                      .reshape(-1) for p in state.params]))
    torch.cuda.synchronize()
    return torch.stack(losses).cpu(), moments, _snapshot(state), state


@pytest.mark.card
@pytest.mark.parametrize("mode", sorted(CARD_MODES))
def test_graphed_steps_equal_eager(mode, card, monkeypatch):
    data = CARD_MODES[mode][0]
    weights = {k: v.clone() for k, v in
               _card_actor(mode, card).state_dict().items()}
    batches = _card_batches(data, STEPS)
    eager = _run(mode, card, batches, False, monkeypatch, weights)
    again = _run(mode, card, batches, False, monkeypatch, weights)
    graph = _run(mode, card, batches, True, monkeypatch, weights)
    st = graph[3].stats
    assert st == {"supervised_steps": 3, "supervised_graph_replays": 2,
                  "supervised_graph_captures": 1}
    assert eager[3].stats["supervised_graph_replays"] == 0
    # with cuDNN's deterministic algorithms two eager runs agree bit for
    # bit, and so do the graphed steps: losses, Adam's first moments after
    # each step (the gradients as Adam got them), and the parameters,
    # BatchNorm running statistics and Adam moments after the six steps
    for run in (again, graph):
        assert torch.equal(run[0], eager[0]), mode
        for s, (m, want) in enumerate(zip(run[1], eager[1]), start=1):
            assert torch.equal(m, want), (mode, s)
        assert sorted(run[2]) == sorted(eager[2])
        for k, want in eager[2].items():
            assert torch.equal(run[2][k], want), (mode, k)


@pytest.mark.card
def test_capture_changes_no_state(card):
    mode = "fivek"
    state = TrainState(_card_actor(mode, card))
    (host,) = _card_batches("fivek", 1)
    b = device_put_batch(host, card)
    supervised_step(state, b)          # eager, then a capture
    before = _snapshot(state)
    encoded = state.actor.lang_encoder(b["x"])
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    graph = graphs.Graph(state.actor,
                         functools.partial(loop._captured_losses, state,
                                           False),
                         loop._graph_inputs(encoded, b),
                         torch.cuda.graph_pool_handle(), stream)
    torch.cuda.synchronize()
    after = _snapshot(state)
    assert sorted(after) == sorted(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert not graph.weights.moved()
    assert all(p.grad is not None for p in state.params)


@pytest.mark.card
def test_moved_weights_force_a_recapture(card, monkeypatch):
    mode = "fivek"
    weights = {k: v.clone() for k, v in
               _card_actor(mode, card).state_dict().items()}
    batches = _card_batches("fivek", 5)[0::2]          # supervised ones
    state = TrainState(_card_actor(mode, card))
    state.actor.load_state_dict(weights)
    losses = []
    for i, host in enumerate(batches):
        if i == 2:
            (graph,) = state.graphs.values()
            assert not graph.weights.moved()
            state.actor.to(card)
            assert graph.weights.moved()
        losses.append(supervised_step(state, device_put_batch(host, card))
                      ["loss"])
    assert state.stats == {"supervised_steps": 3,
                           "supervised_graph_replays": 1,
                           "supervised_graph_captures": 2}
    (regraphed,) = state.graphs.values()
    assert regraphed is not graph and not regraphed.weights.moved()
    with monkeypatch.context() as m:
        m.setattr(loop, "_graph_key", lambda *a: None)
        eager = TrainState(_card_actor(mode, card))
        eager.actor.load_state_dict(weights)
        want = [supervised_step(eager, device_put_batch(h, card))["loss"]
                for h in batches]
    assert torch.equal(torch.stack(losses), torch.stack(want))


@pytest.mark.card
def test_a_second_shape_captures_its_own_graph(card, monkeypatch):
    mode = "fivek"
    weights = {k: v.clone() for k, v in
               _card_actor(mode, card).state_dict().items()}
    big = _card_batches("fivek", 3)[0::2]
    small = _card_batches("fivek", 3, batch=32, seed=1)[0::2]
    order = [big[0], small[0], big[1], small[1], big[0], small[0]]

    def losses(graphed):
        state = TrainState(_card_actor(mode, card))
        state.actor.load_state_dict(weights)
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(loop, "_graph_key", lambda *a: None)
            out = [supervised_step(state, device_put_batch(h, card))["loss"]
                   for h in order]
        return torch.stack(out).cpu(), state

    got, state = losses(True)
    want, _ = losses(False)
    assert len(state.graphs.values()) == 2
    assert state.stats == {"supervised_steps": 6,
                           "supervised_graph_replays": 4,
                           "supervised_graph_captures": 2}
    assert torch.equal(got, want)
