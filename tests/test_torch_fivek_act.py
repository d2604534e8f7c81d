"""The port's FiveK training data and trainer on real data against the
JAX package's, on the repo's FiveK train pairs (`data_real_h2h`) and the
planner actions made from them (`data_real_h2h_acts/actions_set_1`):
`FiveKAct` items and batches (equal exactly: the same cv2 calls on the
same files), the decoded-item cache and its `T2ONET_CACHE_GB` budget,
the FiveK train split of `build_dataset_and_vocab`, one supervised and
one sampled episode step through the fused step on a real batch at tiny
widths (the tolerances of test_torch_train.py, `check_train_step`), and
the trainer's `--fs_only`, `train_actor_fs`, `--profile_steps` and a
phase summary from `utils.profiling`'s spans."""

import argparse
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.cli import common as jcommon
from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data import fivek as jfivek
from t2onet_tpu.train import loop as jloop
from t2onet_tpu_torch.cli import common, train_actor_fs, train_fivek
from t2onet_tpu_torch.data import fivek
from t2onet_tpu_torch.train import loop
from t2onet_tpu_torch.utils import profiling
from tests._torch_port import (check_train_step, gumbel_draws, jax_actor,
                               jax_train_state, port_actor)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2H = os.path.join(ROOT, "data_real_h2h")
IMGS = os.path.join(H2H, "FiveK", "images")
ANNO = os.path.join(H2H, "FiveK", "annotations")
ACTS = os.path.join(ROOT, "data_real_h2h_acts", "actions_set_1")
GLOVE_NPY = os.path.join(ROOT, "data_real_h2h_acts",
                         "FiveK_vocabs_glove_feat_1.npy")
B, LR = 4, 1e-3
CFG = JModelConfig.tiny(word_vec_dim=300, fix_input_embedding=True)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("wire,op_max_len", [(np.float32, 5),
                                             (np.uint8, 5), (np.float32, 2)])
def test_fivek_act_items_and_batches_match_jax(wire, op_max_len):
    args = (IMGS, ANNO, ACTS, "train", 1, 24)
    kw = dict(op_max_len=op_max_len, wire_dtype=wire)
    pd, jd = fivek.FiveKAct(*args, **kw), jfivek.FiveKAct(*args, **kw)
    assert len(pd) == len(jd) == 200
    steps = []
    for i in range(6):
        got, want = pd[i], jd[i]
        _assert_items_equal(got, want)
        steps.append(int((got[3] > 2).sum()))      # executed ops kept
    assert max(steps) <= op_max_len and min(steps) >= 1
    if op_max_len == 5:
        assert len(set(steps)) > 1                 # truncations differ
    gb = next(pd.batches(3, 1, shuffle=True, seed=2))
    wb = next(jd.batches(3, 1, shuffle=True, seed=2))
    assert sorted(gb) == sorted(wb)
    for k in wb:
        if k == "req":
            assert gb[k] == wb[k]
        else:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k])


def test_cache_returns_the_same_item_and_a_zero_budget_caches_none(
        monkeypatch):
    ds = fivek.FiveKAct(IMGS, ANNO, ACTS, "train", 1, 16)
    first = ds[3]
    assert ds[3] is first                          # the cached tuple
    assert not first[0].flags.writeable
    assert ds._cache_bytes == sum(a.nbytes for a in first
                                  if isinstance(a, np.ndarray))
    val = fivek.FiveK(IMGS, ANNO, "val", 1, 16, eval_img_mode="train_size")
    assert val[0] is val[0]
    native = fivek.FiveK(IMGS, ANNO, "val", 1, 16)   # variable-size: never
    native[0]
    assert not native._cache
    monkeypatch.setenv("T2ONET_CACHE_GB", "0")
    off = fivek.FiveKAct(IMGS, ANNO, ACTS, "train", 1, 16)
    a, b = off[3], off[3]
    assert a is not b and not off._cache and off._cache_bytes == 0
    _assert_items_equal(a, first)


def _args(**kw):
    a = dict(synthetic=False, data_dir=H2H, dataset="FiveK", session=1,
             img_size=16, act_dir=ACTS, action_id=1, decoder_max_len=5,
             encoder_max_len=17, synthetic_n=8)
    a.update(kw)
    return argparse.Namespace(**a)


def test_build_dataset_and_vocab_fivek_train_matches_jax():
    got = common.build_dataset_and_vocab(_args(glove_path=None), "train",
                                         wire_u8=True)
    want = jcommon.build_dataset_and_vocab(_args(), "train", wire_u8=True)
    assert type(got[0]).__name__ == type(want[0]).__name__ == "FiveKAct"
    assert got[0].act_dir == want[0].act_dir == ACTS
    _assert_items_equal(got[0][7], want[0][7])
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    # the default act_dir, as the JAX CLI's
    default = common.build_dataset_and_vocab(
        _args(act_dir=None, glove_path=GLOVE_NPY), "train")[0]
    assert default.act_dir == os.path.join("output", "actions_set_1")


@pytest.fixture(scope="module")
def real_case():
    """A real b4 FiveK training batch at 16 px (JAX's FiveKAct) and a
    seeded tiny init whose word rows are the GloVe matrix."""
    ds = jfivek.FiveKAct(IMGS, ANNO, ACTS, "train", 1, 16,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=True, seed=3))
    batch = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    batch["gt_img"] = nb["img_y"][:, -1]
    glove = np.load(GLOVE_NPY)
    vocab = glove.shape[0] + CFG.n_spec_token
    ja, params, stats = jax_actor(CFG, vocab, batch["x"], batch["img_x"],
                                  seed=9, knots_near_one=True)
    params["lang_encoder"]["embedding"][CFG.n_spec_token:] = glove
    return ja, params, stats, batch, vocab


@pytest.mark.parametrize("mode", ["supervised", "episode"])
def test_real_fivek_step_matches_jax(real_case, mode):
    """The episode step is the trainer's on the card: sampled, each step
    through the fused step (JAX: pallas_exec in interpret mode), JAX's
    Gumbel draws fed to the port."""
    ja, params, stats, batch, vocab = real_case
    jstate0 = jax_train_state(params, stats, LR)
    pstate = loop.TrainState(port_actor(CFG, vocab, params, stats),
                             learning_rate=LR)
    if mode == "supervised":
        keys = ("x", "y", "img_x", "img_y", "gt_params")
        jstate1, jm = jloop.make_supervised_step(ja, donate=False)(
            jstate0, {k: jnp.asarray(batch[k]) for k in keys})
        pm = loop.supervised_step(
            pstate, {k: torch.from_numpy(batch[k]) for k in keys})
        p_loss, j_loss = pm["loss"], jm["loss"]
    else:
        keys = ("x", "img_x", "gt_img")
        key = jax.random.PRNGKey(5)
        jstate1, jm = jloop.make_episode_step(
            ja, sample=True, donate=False, pallas_exec=True)(
            jstate0, {k: jnp.asarray(batch[k]) for k in keys}, key)
        draws = iter(gumbel_draws(key, (B, CFG.op_vocab_size),
                                  CFG.decoder_max_len))
        pm = loop.episode_step(
            pstate, {k: torch.from_numpy(batch[k]) for k in keys},
            sample=True, fused_exec=True,
            noise_fn=lambda shape: torch.from_numpy(next(draws).copy()))
        p_loss, j_loss = pm["L1_loss"], jm["L1_loss"]
    # BN statistics within 1e-5 plus 3e-5 of their value: bn1 normalises
    # 32 visual features over 4 images per rollout step, and the sampled
    # episode leaves its running variances (~0.6) about 1e-5 from an f64
    # run of the same step in each framework (measured: the port 1.05e-5,
    # JAX 9.4e-6, in opposite directions, 1.7e-5 apart)
    check_train_step(pstate, jstate1, p_loss, j_loss, params, CFG.n_layers,
                     LR, stats_rtol=3e-5)


TINY = ["--device", "cpu", "--data_dir", H2H, "--act_dir", ACTS,
        "--glove_path", GLOVE_NPY, "--batch_size", "4", "--img_size", "16",
        "--hidden_size", "8", "--operator_fc_dim", "8",
        "--resnet_widths", "4,4,8,8", "--vis_feat_dim", "8",
        "--print_every", "2", "--val_batches", "1"]


def _count_steps(monkeypatch):
    calls = {"supervised": 0, "episode": 0}
    sup, epi = train_fivek.supervised_step, train_fivek.episode_step

    def count_sup(*a, **k):
        calls["supervised"] += 1
        return sup(*a, **k)

    def count_epi(*a, **k):
        calls["episode"] += 1
        return epi(*a, **k)

    monkeypatch.setattr(train_fivek, "supervised_step", count_sup)
    monkeypatch.setattr(train_fivek, "episode_step", count_epi)
    return calls


def test_fs_only_runs_only_supervised_steps(tmp_path, monkeypatch):
    calls = _count_steps(monkeypatch)
    state = train_fivek.main(TINY + ["--num_iters", "4", "--fs_only",
                                     "--run_dir", str(tmp_path)])
    assert state.step == 4
    assert calls == {"supervised": 4, "episode": 0}


def test_train_actor_fs_adds_fs_only(monkeypatch):
    seen = []
    monkeypatch.setattr(train_fivek, "main", lambda argv: seen.append(argv))
    train_actor_fs.main(["--synthetic"])
    train_actor_fs.main(["--synthetic", "--fs_only"])
    assert seen == [["--synthetic", "--fs_only"], ["--synthetic",
                                                   "--fs_only"]]


def test_real_data_training_validates_and_profiles(tmp_path, monkeypatch):
    """Real FiveK train batches, alternating phases, validation on real
    FiveK val at the train size, a checkpoint, and --profile_steps 2:
    steps 5 and 6 traced into {run_dir}/profile, their spans beside the
    trace in spans.json."""
    calls = _count_steps(monkeypatch)
    run = str(tmp_path)
    state = train_fivek.main(TINY + ["--num_iters", "6", "--profile_steps",
                                     "2", "--checkpoint_every", "6",
                                     "--run_dir", run])
    assert state.step == 6 and calls == {"supervised": 3, "episode": 3}
    traces = glob.glob(os.path.join(run, "profile", "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(os.path.join(run, "profile", "spans.json")) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e["name"] == "train.step"]
    assert sorted(e["args"]["step"] for e in steps) == [5, 6]
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in steps)
    assert os.path.exists(os.path.join(run, "seq2seqL1_model",
                                       "checkpoint_iter00000006.pt"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert '"val_L1"' in f.read()


def test_phase_timer_keeps_a_running_mean(monkeypatch):
    """A phase's mean, p50, p90 and count, as a caller of `take_spans`
    summarises the spans of one name."""
    ticks = iter([0, 1, 1, 4, 4, 6])
    monkeypatch.setattr(profiling.time, "time_ns",
                        lambda: next(ticks) * 10 ** 9)
    profiling.start_spans()
    try:
        for _ in range(3):
            with profiling.span("step"):
                pass
    finally:
        spans, dropped = profiling.take_spans()
    xs = sorted((s.end_ns - s.start_ns) / 1e9 for s in spans
                if s.name == "step")
    assert dropped == 0 and len(xs) == 3
    assert sum(xs) / len(xs) == pytest.approx(2.0)
    assert xs[len(xs) // 2] == 2.0
    assert xs[min(int(len(xs) * 0.9), len(xs) - 1)] == 3.0
