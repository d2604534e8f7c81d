"""The port's eval data against the JAX package's, on the repo's real
FiveK (`data_real_h2h`) and GIER (`data_real_gier`) test splits: the
short-side-600 loader, FiveK items at native resolution and at the train
size, GIER items at native resolution (the output resized to the
input's shape), eval batches, `build_dataset_and_vocab` for both
datasets, and the FiveK GloVe rows' .npy copy. Items are equal exactly:
the same cv2 calls on the same files."""

import argparse
import os

import numpy as np
import pytest
import torch

from t2onet_tpu.cli import common as jcommon
from t2onet_tpu.data import fivek as jfivek
from t2onet_tpu.data import gier as jgier
from t2onet_tpu.data import text as jtext
from t2onet_tpu_torch.cli import common, test_fivek, test_gier
from t2onet_tpu_torch.data import fivek, gier, text

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2H = os.path.join(ROOT, "data_real_h2h")
FIVEK_IMGS = os.path.join(H2H, "FiveK", "images")
FIVEK_ANNO = os.path.join(H2H, "FiveK", "annotations")
FIVEK_H5 = os.path.join(H2H, "language", "FiveK_vocabs_glove_feat_1.h5")
FIVEK_NPY = os.path.join(ROOT, "data_real_h2h_acts",
                         "FiveK_vocabs_glove_feat_1.npy")
GIER_DATA = os.path.join(ROOT, "data_real_gier")
GIER_DIR = os.path.join(GIER_DATA, "GIER")
GIER_VOCAB = os.path.join(GIER_DATA, "language")


def _assert_items_equal(got, want):
    assert type(got) is type(want)
    pairs = (got.items() if isinstance(got, dict) else enumerate(got))
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
    for k, v in pairs:
        w = want[k]
        if isinstance(w, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            np.testing.assert_array_equal(v, w, err_msg=str(k))
        else:
            assert v == w, k


def test_short_side_loader_matches_jax():
    path = os.path.join(FIVEK_IMGS, "3458_O.jpg")
    for short in (600, 97):
        got = fivek.load_infer_img_short_size_bounded(path, short)
        want = jfivek.load_infer_img_short_size_bounded(path, short)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 97, 97)
    with pytest.raises(FileNotFoundError):
        fivek.load_infer_img_short_size_bounded(path + ".missing")


@pytest.mark.parametrize("mode,wire", [("native", np.float32),
                                       ("train_size", np.float32),
                                       ("train_size", np.uint8)])
def test_fivek_items_and_batches_match_jax(mode, wire):
    """The first 3 test items, then sequential eval batches of 2 over
    them (native: 600 x 600 f32 whatever the wire, as JAX's)."""
    kw = dict(train_img_size=24, eval_img_mode=mode, wire_dtype=wire)
    port = fivek.FiveK(FIVEK_IMGS, FIVEK_ANNO, "test", **kw)
    ref = jfivek.FiveK(FIVEK_IMGS, FIVEK_ANNO, "test", **kw)
    assert len(port) == len(ref) == 50
    for i in range(3):
        got = port[i]
        _assert_items_equal(got, ref[i])
    assert got[0].shape == ((3, 600, 600) if mode == "native"
                            else (3, 24, 24))
    _assert_items_equal(port[2], got)       # read anew, the same
    port.data, ref.data = port.data[:3], ref.data[:3]
    for b_got, b_want in zip(port.batches(2, 0, sequential=True),
                             ref.batches(2, 0, sequential=True)):
        _assert_items_equal(b_got, b_want)


def test_gier_native_items_match_jax():
    """GIER test items at native resolution: the input short-side-600,
    the output resized to the input's shape."""
    port = gier.GIERDataset(GIER_DIR, GIER_VOCAB, "test",
                            data_mode="global+shapeAlign")
    ref = jgier.GIERDataset(GIER_DIR, GIER_VOCAB, "test",
                            data_mode="global+shapeAlign")
    assert len(port) == len(ref) == 57
    for i in range(3):
        got = port[i]
        _assert_items_equal(got, ref[i])
        assert got["input"].shape == got["output"].shape == (3, 600, 600)
    for b_got, b_want in zip(port.batches(1, 2, shuffle=False),
                             ref.batches(1, 2, shuffle=False)):
        _assert_items_equal(b_got, b_want)


def _jax_parser():
    """The JAX CLI's base parser. JAX's `cli/train_gier._patch_parser`
    (which its `plan_gier.main` and `test_gier.main` call) rebinds
    `add_base_args` for the whole process to one that adds --data_mode and
    --is_load_mask, so a test that adds --data_mode itself resolves the
    clash rather than depend on which tests ran before it."""
    jp = argparse.ArgumentParser(conflict_handler="resolve")
    jcommon.add_base_args(jp)
    return jp


@pytest.mark.parametrize("dataset", ["FiveK", "GIER"])
def test_build_dataset_and_vocab_matches_jax(dataset):
    """The eval CLIs' test set: JAX's length, vocabulary, op names and
    GloVe rows; FiveK's train split reads the planner's actions."""
    _check_build_dataset_and_vocab(dataset)


def test_build_dataset_and_vocab_after_jax_gier_patch(monkeypatch):
    """The GIER case in a process where JAX's `_patch_parser` has already
    wrapped `add_base_args` (pytest restores it afterwards)."""
    from t2onet_tpu.cli import train_gier as jtrain_gier

    orig = jcommon.add_base_args
    monkeypatch.setattr(jcommon, "add_base_args", orig)
    jtrain_gier._patch_parser()
    assert jcommon.add_base_args is not orig
    assert "--data_mode" in _jax_parser()._option_string_actions
    _check_build_dataset_and_vocab("GIER")


def _check_build_dataset_and_vocab(dataset):
    if dataset == "FiveK":
        argv = ["--data_dir", H2H]
        a = test_fivek.eval_parser().parse_args(argv)
        ja = _jax_parser().parse_args(argv)
    else:
        argv = ["--data_dir", GIER_DATA, "--dataset", "GIER", "--session",
                "3"]
        a = test_gier.eval_parser().parse_args(argv)
        jp = _jax_parser()
        jp.add_argument("--data_mode", default="global+shapeAlign")
        ja = jp.parse_args(argv)
    ds, vocab2id, id2op, w2v = common.build_dataset_and_vocab(a, "test")
    jds, jvocab, jid2op, jw2v = jcommon.build_dataset_and_vocab(ja, "test")
    assert len(ds) == len(jds) and vocab2id == jvocab and id2op == jid2op
    np.testing.assert_array_equal(w2v, jw2v)
    _assert_items_equal(ds[1], jds[1])
    if dataset == "FiveK":
        # the train split: FiveKAct over the planner's actions, from
        # JAX's default act_dir
        train = common.build_dataset_and_vocab(a, "train")[0]
        jtrain = jcommon.build_dataset_and_vocab(ja, "train")[0]
        assert type(train).__name__ == type(jtrain).__name__ == "FiveKAct"
        assert train.act_dir == jtrain.act_dir
        # the .npy copy through --glove_path gives the same rows
        a.glove_path = FIVEK_NPY
        np.testing.assert_array_equal(
            common.build_dataset_and_vocab(a, "val")[3], jw2v)


def test_fivek_glove_npy_equals_h5():
    """The committed .npy copy (for hosts without h5py) is the .h5's
    "glove" dataset, bit for bit."""
    want = jtext.load_embedding(FIVEK_H5)
    got = text.load_embedding(FIVEK_NPY)
    assert got.dtype == np.float32 and got.shape == (914, 300)
    assert np.array_equal(got, want)
    assert np.array_equal(np.load(FIVEK_NPY), want)
