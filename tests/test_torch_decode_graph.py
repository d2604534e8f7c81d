"""The serving decode as a CUDA graph (through `utils.graphs`) and what
it leaves as it was.

On the CPU, where the decode runs eagerly: the engine's decode counters
(row blocks counted, no graph captured or replayed) and its programs,
equal to `Actor.episode`'s on the same row blocks; the counters in
`stats_snapshot()` and the `graphed` attribute of the decode span; the
op-mask constant made once a device (`models.actor.episode_op_mask`)
leaving greedy and sampled episodes and `rl_step` bit-equal to a mask
copied from the host on every call, and the state_dict keys as they
were.

On a CUDA card (marked `card`, skipped without one), at the serving
cell's widths and 128 px probe: graphed programs equal to the eager
`Actor.episode`'s for every row count 1..8, two launches in flight each
with its own program, a mesh naming one card twice giving each row block
its own, after a warm-up one capture per key seen and a replay for
every later call, a capture again once the actor's weights moved, and
the decode span's `graphed` true on replays only."""

import numpy as np
import pytest
import torch

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.data.synthetic import synthetic_vocab
from t2onet_tpu_torch.models import actor as actor_mod
from t2onet_tpu_torch.models.actor import EPISODE_OP_MASK, Actor
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.parallel.mesh import shard_rows
from t2onet_tpu_torch.serve import (END_ID, MicroBatcher, ServingEngine,
                                    resize_bilinear)
from t2onet_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY = ModelConfig.tiny(encoder_max_len=17, decoder_max_len=5)
REQUESTS = ["increase the brightness", "improve contrast",
            "increase saturation", "sharpen the image", "fix the tone",
            "make it brighter and warmer", "reduce the contrast",
            "warm up the colors"]
COUNTERS = ("decode_calls", "decode_graph_replays", "decode_graph_captures")


def _actor(cfg=TINY, seed=0):
    """Random weights, with <END>'s logit lowered so that programs run to
    five ops."""
    actor = Actor(cfg, OperatorConfig(), len(synthetic_vocab()),
                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        actor.decoder.out_linear.bias[END_ID] -= 4.0
    return actor


def _images(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.05, 0.95, (3,) + hw).astype(np.float32)
            for hw in shapes]


@torch.inference_mode()
def _eager(actor, engine, images, requests, device):
    """`Actor.episode` on one row block as the engine decodes it: its
    tokens, and each (bucket-sized) image resized to the probe. Returns
    (ops (rows, S), params (rows, S, 24)) on the host."""
    x = torch.from_numpy(np.stack([engine._tokenize(r) for r in requests]))
    ds = engine.decode_size
    probe = torch.cat([resize_bilinear(torch.from_numpy(im)[None]
                                       .to(device), ds, ds)
                       for im in images])
    out = actor.episode(x.to(device), probe,
                        host_lengths=(x != 0).sum(dim=1))
    return out["ops"].cpu(), out["params"].cpu()


def _blocks(engine, n):
    """The row blocks of a micro-batch of n: padded to the mesh's size
    with its last request, then cut as the engine cuts it."""
    pad = (-n) % engine.mesh.size
    idx = list(range(n)) + [n - 1] * pad
    return [idx[r] for r in shard_rows(len(idx), engine.mesh)]


def _names(ops):
    names = []
    for op in ops.tolist():
        if op == END_ID:
            break
        if op >= 3:
            names.append(OP_NAMES[op - 3])
    return names


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("mesh_size", [1, 2])
def test_cpu_engine_counts_row_blocks_and_captures_nothing(mesh_size):
    """Five 16x16 requests (micro-batches of 4 and 1) and two 16x32 (one
    of 2): every row block is counted, nothing is captured or replayed,
    and each request's program is the eager episode's on its row block,
    bit for bit before the engine rounds the parameters."""
    actor = _actor()
    engine = ServingEngine(actor, synthetic_vocab(),
                           mesh=["cpu"] * mesh_size, decode_size=16,
                           quantum=16, max_batch=4, encoder_max_len=17,
                           u8_wire=False)
    shapes = [(16, 16)] * 5 + [(16, 32)] * 2
    images, requests = _images(shapes), REQUESTS[:7]
    results = engine.edit_batch(images, requests)
    batches = [[0, 1, 2, 3], [4], [5, 6]]
    blocks = [[b[i] for i in blk] for b in batches
              for blk in _blocks(engine, len(b))]
    st = engine.stats_snapshot()
    assert st["decode_calls"] == len(blocks) == (3 if mesh_size == 1 else 6)
    assert st["decode_graph_replays"] == st["decode_graph_captures"] == 0
    assert engine.graphs.values() == []
    served = set()
    for blk in blocks:
        ops, params = _eager(engine.actor, engine, [images[i] for i in blk],
                             [requests[i] for i in blk], "cpu")
        for row, i in enumerate(blk):
            want = _names(ops[row])
            assert results[i].ops == want
            assert results[i].params == [params[row, s].numpy().round(4)
                                         .tolist() for s in range(len(want))]
            served.add(i)
    assert served == set(range(7))
    assert min(len(r.ops) for r in results) >= 3


def test_stats_snapshot_carries_the_decode_counters():
    engine = ServingEngine(_actor(), synthetic_vocab(), device="cpu",
                           decode_size=16, quantum=16, max_batch=4,
                           encoder_max_len=17)
    st = engine.stats_snapshot()
    assert all(st[k] == 0 for k in COUNTERS)
    batcher = MicroBatcher(engine, linger_ms=2.0).start()
    try:
        handles = [engine.submit(im, r) for im, r in
                   zip(_images([(16, 16)] * 3), REQUESTS)]
        assert all(h.done.wait(60) and h.error is None for h in handles)
    finally:
        batcher.stop()
    st = engine.stats_snapshot()
    assert st["decode_calls"] == st["batches"] >= 1
    assert st["decode_graph_replays"] == st["decode_graph_captures"] == 0
    assert set(COUNTERS) <= set(st)


def test_decode_span_says_whether_graphed():
    engine = ServingEngine(_actor(), synthetic_vocab(), device="cpu",
                           decode_size=16, quantum=16, max_batch=2,
                           encoder_max_len=17)
    profiling.start_spans()
    try:
        engine.edit_batch(_images([(16, 16)] * 3), REQUESTS[:3])
    finally:
        spans, dropped = profiling.take_spans()
    decodes = [s for s in spans if s.name == "serve.launch.decode"]
    assert dropped == 0 and len(decodes) == 2
    assert all(s.attrs == {"graphed": False} for s in decodes)


def _fresh_mask(device):
    """The mask as `Actor.episode` and `rl_step` made it before it was
    cached: copied from the host on every call."""
    return torch.as_tensor(EPISODE_OP_MASK, device=device)


def _gen():
    return torch.Generator().manual_seed(7)


def _rollouts(actor, x, img):
    greedy = actor.episode(x, img)
    sampled = actor.episode(x, img, sample=True, generator=_gen())
    carry = actor.decoder.init_carry(actor.lang_encoder(x)[1])
    op = torch.full((x.shape[0],), actor.cfg.start_id, dtype=torch.long)
    first = actor.rl_step(x, img, carry, op, generator=_gen())
    second = actor.rl_step(x, first[0], first[5], first[6],
                           generator=_gen(), op_mask=first[7])
    return greedy, sampled, first, second


def _flat(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out) if out[k] is not None]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cached_op_mask_leaves_rollouts_bit_equal(monkeypatch, mode):
    """Greedy and sampled episodes and two chained `rl_step`s with the
    cached mask against the mask copied on every call: every output bit
    for bit. The cached mask, first made under inference mode as a
    serving engine makes it, is a normal tensor that a training step
    saves for its backward; it is one tensor a device and never
    written."""
    actor = _actor()
    getattr(actor, mode)()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(4, 39, (3, 17))).long()
    x[:, 9:] = 0
    img = torch.from_numpy(rng.uniform(0.05, 0.95, (3, 3, 16, 16))
                           .astype(np.float32))
    monkeypatch.setattr(actor_mod, "_OP_MASKS", {})
    with torch.inference_mode():
        cached = actor_mod.episode_op_mask("cpu")
    assert not cached.is_inference()
    assert actor_mod.episode_op_mask(torch.device("cpu")) is cached

    state = {k: v.clone() for k, v in actor.state_dict().items()}
    got = _rollouts(actor, x, img)
    actor.load_state_dict(state)
    with monkeypatch.context() as m:
        m.setattr(actor_mod, "episode_op_mask", _fresh_mask)
        want = _rollouts(actor, x, img)
    assert got[0]["logprobs"].requires_grad     # the mask saved for backward
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(cached.numpy(), EPISODE_OP_MASK)
    assert actor_mod.episode_op_mask("cpu") is cached


def test_actor_state_dict_keys_unchanged():
    """No buffer is added for the mask: the keys and buffers after
    serving and rollouts are those of an actor that never ran, and a
    strict load into a fresh actor takes them."""
    fresh = _actor(seed=1)
    keys = list(fresh.state_dict())
    buffers = [n for n, _ in fresh.named_buffers()]
    actor = _actor()
    engine = ServingEngine(actor, synthetic_vocab(), device="cpu",
                           decode_size=16, quantum=16, max_batch=2,
                           encoder_max_len=17)
    engine.edit_batch(_images([(16, 16)] * 2), REQUESTS[:2])
    x = torch.ones(2, 17, dtype=torch.long)
    actor.episode(x, torch.rand(2, 3, 16, 16), sample=True,
                  generator=_gen())
    assert list(actor.state_dict()) == keys
    assert [n for n, _ in actor.named_buffers()] == buffers
    assert not any("mask" in k for k in keys)
    fresh.load_state_dict(actor.state_dict(), strict=True)


# -- on the card --------------------------------------------------------------

FULL = ModelConfig(encoder_max_len=17, decoder_max_len=5)
PROBE = 128


@pytest.fixture
def card():
    """Skips the test where PyTorch finds no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def full_actor():
    """The serving cell's actor widths (ResNet-18, bi-LSTM 256, heads fc
    512)."""
    return _actor(FULL, seed=5)


def _engine(actor, card, **kw):
    opts = dict(decode_size=PROBE, quantum=64, max_batch=8,
                encoder_max_len=17)
    opts.update(kw)
    if "mesh" not in opts:
        opts["device"] = card
    return ServingEngine(actor, synthetic_vocab(), **opts)


def _launch(engine, images, requests):
    """Submit one bucket's requests and launch them as one micro-batch
    without reading back: the in-flight records."""
    for im, r in zip(images, requests):
        engine.submit(im, r)
    return engine.launch(engine._take())


def _programs(rec):
    """A read-back record's raw (ops (n, S), params (n, S, 24))."""
    meta = rec.meta.numpy()
    s = meta.shape[1] // 25
    return (torch.from_numpy(meta[:, :s].astype(np.int64)),
            torch.from_numpy(meta[:, s:].reshape(-1, s, 24).copy()))


@pytest.mark.card
def test_graphed_decode_equals_eager_for_every_row_count(card, full_actor):
    engine = _engine(full_actor, card)
    actor = engine.actor
    gen = torch.Generator().manual_seed(11)
    for rows in range(1, 9):
        requests = [REQUESTS[(rows + i) % len(REQUESTS)] for i in range(rows)]
        x = torch.from_numpy(np.stack([engine._tokenize(r)
                                       for r in requests]))
        lengths = (x != 0).sum(dim=1)
        probe = torch.rand((rows, 3, PROBE, PROBE), generator=gen).to(card)
        with torch.inference_mode():
            want = actor.episode(x.to(card), probe, host_lengths=lengths)
            got = []
            with engine._on_streams():
                for _ in range(3):      # eager and capture, then replays
                    got.append(engine._decode(x.to(card), probe, lengths,
                                              card))
            torch.cuda.synchronize()
        for ops, params in got:
            assert torch.equal(ops, want["ops"]), rows
            assert torch.equal(params, want["params"]), rows
    st = engine.stats_snapshot()
    assert st["decode_graph_captures"] == 8
    assert st["decode_graph_replays"] == 16
    assert st["decode_calls"] == 24


@pytest.mark.card
def test_back_to_back_launches_keep_their_own_programs(card, full_actor):
    engine = _engine(full_actor, card, max_batch=4)
    shapes = [(128, 128)] * 4
    first, second = _images(shapes, seed=1), _images(shapes, seed=2)
    req1, req2 = REQUESTS[:4], REQUESTS[4:8]
    engine.edit_batch(first, req1)               # captures rows = 4
    recs = _launch(engine, first, req1) + _launch(engine, second, req2)
    engine.readback(recs)
    assert engine.stats_snapshot()["decode_graph_replays"] == 2
    for rec, images, requests in ((recs[0], first, req1),
                                  (recs[1], second, req2)):
        ops, params = _programs(rec)
        want_ops, want_params = _eager(engine.actor, engine, images,
                                       requests, card)
        assert torch.equal(ops, want_ops)
        assert torch.equal(params, want_params)
    assert not torch.equal(_programs(recs[0])[1], _programs(recs[1])[1])


@pytest.mark.card
def test_mesh_on_one_card_gives_each_block_its_program(card, full_actor):
    engine = _engine(full_actor, card, mesh=[card, card])
    images, requests = _images([(128, 128)] * 8, seed=3), REQUESTS
    engine.edit_batch(images, requests)          # captures rows = 4
    (rec,) = _launch(engine, images, requests)
    engine.readback([rec])
    st = engine.stats_snapshot()
    assert st["decode_graph_captures"] == 1
    assert st["decode_graph_replays"] == 3 and st["decode_calls"] == 4
    ops, params = _programs(rec)
    for blk in (slice(0, 4), slice(4, 8)):
        want_ops, want_params = _eager(engine.actor, engine, images[blk],
                                       requests[blk], card)
        assert torch.equal(ops[blk], want_ops)
        assert torch.equal(params[blk], want_params)
    assert not torch.equal(params[:4], params[4:])


@pytest.mark.card
def test_warm_up_captures_each_key_and_replays_after(card, full_actor):
    """Every row count in one bucket, then a batcher over two buckets of
    another native shape (the probe's shape is the key, so they share
    the graphs): a capture a key seen, then only replays."""
    engine = _engine(full_actor, card)
    for rows in range(1, 9):
        engine.edit_batch(_images([(128, 128)] * rows, seed=rows),
                          REQUESTS[:rows])
    st = engine.stats_snapshot()
    assert st["decode_graph_captures"] == len(engine.graphs.values()) == 8
    assert st["decode_calls"] == 8 and st["decode_graph_replays"] == 0
    batcher = MicroBatcher(engine, linger_ms=2.0).start()
    try:
        shapes = [(192, 128), (128, 256)] * 10
        handles = [engine.submit(im, REQUESTS[i % len(REQUESTS)])
                   for i, im in enumerate(_images(shapes, seed=9))]
        assert all(h.done.wait(120) and h.error is None for h in handles)
    finally:
        batcher.stop()
    after = engine.stats_snapshot()
    assert after["decode_graph_captures"] == 8
    calls = after["decode_calls"] - st["decode_calls"]
    assert calls >= 2
    assert after["decode_graph_replays"] == calls


@pytest.mark.card
def test_a_second_engine_on_the_actor_makes_the_first_recapture(card,
                                                               full_actor):
    """A second engine over the same actor moves it onto the card again,
    which flattens the LSTMs' weights into new storage and frees the old
    (the second engine's capture empties the cache): the first engine's
    graph would read freed memory. It captures again, and its programs
    stay the eager episode's."""
    first = _engine(full_actor, card, max_batch=4)
    images, requests = _images([(128, 128)] * 4, seed=4), REQUESTS[:4]
    first.edit_batch(images, requests)           # captures rows = 4
    (graph,) = first.graphs.values()
    assert not graph.weights.moved()
    second = _engine(full_actor, card, max_batch=4)
    assert graph.weights.moved()
    second.edit_batch(images, requests)
    (rec,) = _launch(first, images, requests)
    first.readback([rec])
    st = first.stats_snapshot()
    assert st["decode_graph_captures"] == 2 and st["decode_graph_replays"] == 0
    (regraphed,) = first.graphs.values()
    assert regraphed is not graph and not regraphed.weights.moved()
    ops, params = _programs(rec)
    want_ops, want_params = _eager(first.actor, first, images, requests, card)
    assert torch.equal(ops, want_ops)
    assert torch.equal(params, want_params)


@pytest.mark.card
def test_decode_span_is_graphed_on_replays_only(card, full_actor):
    """Three micro-batches of one row count: the first captures, the
    other two replay, and each decode span says so."""
    engine = _engine(full_actor, card, max_batch=4)
    images = _images([(128, 128)] * 4, seed=6)
    profiling.start_spans()
    try:
        for _ in range(3):
            engine.edit_batch(images, REQUESTS[:4])
    finally:
        spans, dropped = profiling.take_spans()
    decodes = [s for s in spans if s.name == "serve.launch.decode"]
    assert dropped == 0
    assert [s.attrs["graphed"] for s in decodes] == [False, True, True]
    st = engine.stats_snapshot()
    assert st["decode_graph_captures"] == 1
    assert st["decode_graph_replays"] == 2
