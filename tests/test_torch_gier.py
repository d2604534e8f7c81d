"""The port's GIER local-edit training path against the JAX package's, on
the repo's real GIER data (`data_real_gier`) and the planner actions made
from it (`data_real_gier_acts`): RLE masks and their nearest resize, the
vocabularies and GloVe rows, the GIER index and datasets (every batch
key equal), one masked episode step and one supervised step with frozen
GloVe rows, and a tiny run of `t2onet_tpu_torch.cli.train_gier` that
checkpoints and resumes.

The steps run at tiny widths with the real 2,279-word vocabulary and
300-wide GloVe rows, `decoder_max_len` 3, b4 at 16 px; the tolerances
are test_torch_train.py's (`check_train_step`). Every op the rollout can
pick is given a real mask (the batch's own local masks, shared out to
the global ops), so each executed step is blended."""

import json
import os

import numpy as np
import pytest
import torch

from t2onet_tpu import native
from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data import gier as jgier
from t2onet_tpu.data import rle as jrle
from t2onet_tpu.data import text as jtext
from t2onet_tpu_torch.cli import train_fivek, train_gier
from t2onet_tpu_torch.data import gier, rle, text
from t2onet_tpu_torch.train import loop
from tests._torch_port import (gier_step_case, gier_train_step_parity,
                               port_actor)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data_real_gier")
GIER_DIR = os.path.join(DATA, "GIER")
VOCAB_DIR = os.path.join(DATA, "language")
ACTS = os.path.join(ROOT, "data_real_gier_acts", "GIER_actions_set_1")
GLOVE_H5 = os.path.join(VOCAB_DIR, "GIER_vocabs_glove_feat_3.h5")
GLOVE_NPY = os.path.join(ROOT, "data_real_gier_acts",
                         "GIER_vocabs_glove_feat_3.npy")

CFG = JModelConfig.tiny(decoder_max_len=3, word_vec_dim=300,
                        fix_input_embedding=True)


# ---------------------------------------------------------------------------
# masks, vocabularies, GloVe
# ---------------------------------------------------------------------------

def _rles():
    out = []
    for name in sorted(os.listdir(os.path.join(GIER_DIR, "masks"))):
        with open(os.path.join(GIER_DIR, "masks", name)) as f:
            out += json.load(f)
    return out


def test_rle_and_resize_nearest_match_jax():
    """Every RLE of the real mask files decodes as the JAX package's
    (numpy and native); the nearest resize equals native's and cv2's at
    the trainer's sizes and at sizes where 1/(oh/h) and h/oh differ."""
    import cv2

    rles = _rles()
    assert len(rles) > 83
    sizes = [(128, 128), (16, 16), (18, 18), (64, 97), (7, 300)]
    for r in rles:
        m = rle.rle_decode(r)
        np.testing.assert_array_equal(m, jrle.rle_decode(r))
        np.testing.assert_array_equal(m, native.rle_decode(r))
        enc = rle.rle_encode(m)
        assert enc == jrle.rle_encode(m)
        np.testing.assert_array_equal(rle.rle_decode(enc), m)
        for oh, ow in sizes:
            got = rle.resize_nearest(m, oh, ow)
            np.testing.assert_array_equal(got, native.resize_nearest(m, oh,
                                                                     ow))
            np.testing.assert_array_equal(
                got, cv2.resize(m, (ow, oh), interpolation=cv2.INTER_NEAREST))
    odd = (np.arange(14 * 14).reshape(14, 14) % 3 == 0).astype(np.uint8)
    np.testing.assert_array_equal(
        rle.resize_nearest(odd, 18, 18),
        cv2.resize(odd, (18, 18), interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError):
        rle.rle_decode({"size": [2, 2], "counts": [1, 2]})


def test_vocab_and_glove_match_jax():
    got = text.load_vocab(VOCAB_DIR, "GIER", 3)
    assert got == jtext.load_vocab(VOCAB_DIR, "GIER", 3)
    assert len(got[0]) == 2279 and len(got[2]) == 11
    glove = text.load_embedding(GLOVE_H5)
    np.testing.assert_array_equal(glove, jtext.load_embedding(GLOVE_H5))
    assert glove.shape == (2275, 300) and glove.dtype == np.float32
    # the .npy copy for hosts without h5py holds the same matrix
    np.testing.assert_array_equal(text.load_embedding(GLOVE_NPY), glove)


# ---------------------------------------------------------------------------
# the GIER index and datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["shapeAlign", "global+shapeAlign",
                                  "valid+shapeAlign_nonCrop"])
def test_gier_index_matches_jax(mode):
    port = gier.GIER(GIER_DIR, VOCAB_DIR, "train", data_mode=mode)
    ref = jgier.GIER(GIER_DIR, VOCAB_DIR, "train", data_mode=mode)
    assert port.op_data == ref.op_data and len(port) == len(ref) > 0
    for name in ("getImgId", "getReq", "ReqId2PairId", "PairId2ReqId"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.getReqIdx.keys() == ref.getReqIdx.keys()
    for k, v in port.getReqIdx.items():
        np.testing.assert_array_equal(v, ref.getReqIdx[k])
    for pid in range(len(port)):
        assert port.get_op_info(pid) == ref.get_op_info(pid)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "req":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("wire", [np.uint8, np.float32])
def test_gier_dataset_act_batches_match_jax(wire):
    """`GIERDatasetAct` on the real split and the committed actions: the
    request count of shapeAlign, then two b8 batches, key by key (images,
    planned steps, requests, ops, params, step_masks, masks_vocab)."""
    kw = dict(data_mode="shapeAlign", is_load_mask=True, session=3,
              train_img_size=16, wire_dtype=wire)
    port = gier.GIERDatasetAct(GIER_DIR, VOCAB_DIR, ACTS, "train", **kw)
    ref = jgier.GIERDatasetAct(GIER_DIR, VOCAB_DIR, ACTS, "train", **kw)
    assert len(port) == len(ref) == 446
    n_local = 0
    for got, want in zip(port.batches(8, 2, shuffle=True, seed=3),
                         ref.batches(8, 2, shuffle=True, seed=3)):
        _assert_batches_equal(got, want)
        n_local += int((got["masks_vocab"] < 1).any(axis=(2, 3, 4)).sum())
    assert n_local > 0                       # some items carry local masks


def test_gier_eval_batches_match_jax():
    """Validation items at the train size, sequential with a short tail."""
    port = gier.GIERDataset(GIER_DIR, VOCAB_DIR, "val",
                            data_mode="shapeAlign", train_img_size=16,
                            eval_img_mode="train_size")
    ref = jgier.GIERDataset(GIER_DIR, VOCAB_DIR, "val",
                            data_mode="shapeAlign", train_img_size=16,
                            eval_img_mode="train_size")
    n = 0
    for got, want in zip(port.batches(16, 0, sequential=True),
                         ref.batches(16, 0, sequential=True)):
        _assert_batches_equal(got, want)
        n += len(got["req"])
    assert n == len(port) == len(ref)


# ---------------------------------------------------------------------------
# one training step of each framework
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def init():
    return gier_step_case(CFG)


def test_supervised_step_with_frozen_glove_matches_jax(init):
    pstate = gier_train_step_parity(init, CFG, "supervised")
    # the special tokens' rows train
    emb = pstate.actor.lang_encoder.embedding.weight
    assert emb.grad[:CFG.n_spec_token].any()


@pytest.mark.parametrize("mode", ["greedy_bank", "sampled_bank"])
def test_masked_episode_step_matches_jax(init, mode):
    """Through the masked bank (`--fused_exec 0`); the masked fused step
    is test_torch_masked.py's."""
    gier_train_step_parity(init, CFG, mode)


def test_episode_masks_change_the_step(init):
    """The masks reach the rollout: without them the loss differs."""
    _, params, stats, batch, vocab, _ = init
    keys = ("x", "img_x", "gt_img")
    t = {k: torch.from_numpy(batch[k]) for k in keys + ("masks_vocab",)}
    losses = []
    for b in (t, {k: t[k] for k in keys}):
        state = loop.TrainState(port_actor(CFG, vocab, params, stats))
        losses.append(float(loop.episode_step(state, b, sample=False)
                            ["L1_loss"]))
    assert losses[0] != losses[1]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--is_load_mask", "1", "--data_dir", DATA,
        "--act_dir", ACTS, "--data_mode", "shapeAlign", "--batch_size", "4",
        "--img_size", "16", "--decoder_max_len", "3", "--hidden_size", "8",
        "--operator_fc_dim", "8", "--resnet_widths", "4,4,8,8",
        "--vis_feat_dim", "8", "--print_every", "2", "--checkpoint_every",
        "2", "--val_batches", "1", "--fused_exec", "1"]


def test_train_gier_parser_defaults():
    """GIER's defaults, as the JAX trainer sets them."""
    a = train_gier.train_parser().parse_args([])
    assert (a.dataset, a.session, a.num_iters, a.decoder_max_len,
            a.data_mode, a.is_load_mask, a.fix_input_embedding,
            a.wire_u8) == ("GIER", 3, 20_000, 8, "global+shapeAlign", 0, 1,
                           1)


def test_train_gier_runs_checkpoints_and_resumes(tmp_path, monkeypatch):
    """Masks reach every episode step and only those; the GloVe rows
    stay frozen; --resume continues from the latest checkpoint."""
    seen = []
    real = train_fivek.episode_step

    def spy(state, batch, **kw):
        seen.append(sorted(batch))
        return real(state, batch, **kw)

    monkeypatch.setattr(train_fivek, "episode_step", spy)
    run = str(tmp_path / "run")
    argv = TINY + ["--run_dir", run]
    state = train_gier.main(argv + ["--num_iters", "4"])
    assert state.step == 4
    assert seen == [["gt_img", "img_x", "masks_vocab", "x", "x_lengths"]] * 2
    glove = text.load_embedding(GLOVE_H5)
    emb = state.actor.lang_encoder.embedding.weight.detach().numpy()
    np.testing.assert_array_equal(emb[4:], glove)
    ckdir = tmp_path / "run" / "seq2seqL1_model"
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "checkpoint_best.pt", "checkpoint_iter00000002.pt",
        "checkpoint_iter00000004.pt", "stats.json"]
    resumed = train_gier.main(argv + ["--num_iters", "6", "--resume"])
    assert resumed.step == 6 and len(seen) == 3
    assert (ckdir / "checkpoint_iter00000006.pt").exists()
