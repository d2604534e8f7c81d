"""The request encoder packs by host lengths without stalling the card
(`models.encoder`, fed by `data.loader.device_put_batch`'s lengths).

On a CUDA card (marked `card`, skipped without one), at the training
cells' widths, b64 x 128 px, and the serving cell's: after a warm-up, a
replayed supervised step, a sampled fused episode step, a GAN iteration
and a serving decode each run whole with `torch.cuda.set_sync_debug_mode`
at "error", so that a device read or a blocking copy anywhere in them,
the request encoder's calls and the batch's staging included, raises;
every one of those encoder calls packed from host lengths
(`RNNEncoder.stats`). The CPU tests of the packing are
in test_torch_model.py and test_torch_train.py."""

import numpy as np
import pytest
import torch

from t2onet_tpu_torch.cli import train_gan
from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.data.loader import device_put_batch
from t2onet_tpu_torch.data.synthetic import synthetic_vocab
from t2onet_tpu_torch.models import gan
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.serve import ServingEngine
from t2onet_tpu_torch.train import loop

BATCH, SIZE, REQ_LEN, N_OPS, VOCAB = 64, 128, 17, 5, 918
KINDS = ("supervised", "episode", "gan", "decode")


@pytest.fixture
def card():
    """Skips the test where PyTorch finds no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from t2onet_tpu_torch.precision import set_cuda_precision

    set_cuda_precision()
    return torch.device("cuda", torch.cuda.current_device())


def _host_batch(rng, supervised):
    """A FiveK-shaped host batch as the trainers stage it: requests of
    1-17 tokens (ties among them), 1-5 ops, images in (0.05, 0.95)."""
    x = np.zeros((BATCH, REQ_LEN), np.int64)
    y = np.zeros((BATCH, N_OPS + 2), np.int64)
    gt = np.zeros((BATCH, N_OPS, 24), np.float32)
    for i in range(BATCH):
        n = int(rng.integers(1, REQ_LEN + 1))
        x[i, :n] = rng.integers(4, VOCAB, n)
        k = int(rng.integers(1, N_OPS + 1))
        y[i, 0], y[i, 1:k + 1], y[i, k + 1] = 1, rng.integers(3, 11, k), 2
        gt[i, :k, 0] = rng.uniform(-0.5, 0.5, k)
    img_x = rng.uniform(0.05, 0.95, (BATCH, 3, SIZE, SIZE)).astype(np.float32)
    img_y = rng.uniform(0.05, 0.95, (BATCH, N_OPS + 1, 3, SIZE, SIZE)) \
        .astype(np.float32)
    if supervised:
        return {"x": x, "y": y, "img_x": img_x, "img_y": img_y,
                "gt_params": gt}
    return {"x": x, "img_x": img_x, "gt_img": img_y[:, -1]}


def _trainer_step(kind, card):
    """fn() running one step of `kind` on fresh batches, and the actor."""
    cfg = ModelConfig(encoder_max_len=REQ_LEN, decoder_max_len=N_OPS)
    actor = Actor(cfg, OperatorConfig(), VOCAB,
                  generator=torch.Generator().manual_seed(3)).to(card)
    state = loop.TrainState(actor)
    gen = torch.Generator(device=card).manual_seed(17)
    rng = np.random.default_rng(5)
    if kind == "gan":
        bundle = gan.DiscBundle(cfg.n_layers * 2 * cfg.hidden_size).to(card)
        gstate = train_gan.GANState(bundle, state.params)
        losses = gan.Seq2SeqGANLosses()

    def step():
        b = device_put_batch(_host_batch(rng, kind == "supervised"), card)
        if kind == "supervised":
            return loop.supervised_step(state, b)
        if kind == "episode":
            return loop.episode_step(state, b, generator=gen, sample=True,
                                     fused_exec=True)
        return train_gan.gan_step(state, gstate, b, losses, generator=gen,
                                  fused_exec=True)

    return step, actor, state


def _decode_call(card):
    """fn() decoding one row block of 8 requests as the batcher does, and
    the engine's actor."""
    cfg = ModelConfig(encoder_max_len=REQ_LEN, decoder_max_len=N_OPS)
    actor = Actor(cfg, OperatorConfig(), len(synthetic_vocab()),
                  generator=torch.Generator().manual_seed(5))
    engine = ServingEngine(actor, synthetic_vocab(), device=card,
                           decode_size=128, quantum=64, max_batch=8,
                           encoder_max_len=REQ_LEN)
    requests = ["increase the brightness", "improve contrast",
                "increase saturation", "make it brighter and warmer"] * 2
    tokens = torch.from_numpy(np.stack([engine._tokenize(r)
                                        for r in requests])).pin_memory()
    lengths = (tokens != 0).sum(dim=1)
    probe = torch.rand((8, 3, 128, 128), generator=torch.Generator()
                       .manual_seed(11)).to(card)

    def call():
        with torch.inference_mode(), engine._on_streams():
            return engine._decode(tokens.to(card, non_blocking=True), probe,
                                  lengths, card)

    return call, engine.actor, engine


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
def test_steps_and_decode_never_sync(kind, card):
    if kind == "decode":
        run, actor, owner = _decode_call(card)
    else:
        run, actor, owner = _trainer_step(kind, card)
    for _ in range(3):          # warm-up: cuDNN, the graphs' captures
        run()
    torch.cuda.synchronize()
    encoder = actor.lang_encoder
    before = dict(encoder.stats)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    calls = encoder.stats["calls"] - before["calls"]
    packed = encoder.stats["host_packed"] - before["host_packed"]
    assert calls == packed == 2 * (2 if kind == "gan" else 1)
    if kind == "supervised":
        assert owner.stats["supervised_graph_replays"] >= 2
    if kind == "decode":
        assert owner.stats["decode_graph_replays"] >= 2
