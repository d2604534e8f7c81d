"""The port's host-side training pieces against the JAX package's: the
synthetic dataset (same requests, ops and params, images within 1e-6:
the same f32 op math on the CPU), batch-index iteration, the
Prefetcher, the CLI flags and config, and a tiny end-to-end run of
`t2onet_tpu_torch.cli.train_fivek` that checkpoints and resumes."""

import argparse
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from t2onet_tpu import config as jconfig
from t2onet_tpu.cli import common as jcommon
from t2onet_tpu.data import iteration as jiter
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab as jvocab
from t2onet_tpu_torch import config as pconfig
from t2onet_tpu_torch.cli import common, train_fivek
from t2onet_tpu_torch.data import iteration
from t2onet_tpu_torch.data.loader import Prefetcher, device_put_batch
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.train.checkpoint import CheckpointManager
from t2onet_tpu_torch.train.loop import TrainState

torch.set_num_threads(2)


def test_synthetic_items_match_jax():
    assert synthetic_vocab() == jvocab()
    kw = dict(n=12, img_size=16, seed=3, req_max_len=17, op_max_len=5)
    port, ref = SyntheticFiveK(**kw), JSyntheticFiveK(**kw)
    for i in range(kw["n"]):
        got, want = port.make_item(i), ref.make_item(i)
        assert got[5] == want[5]                            # request
        for j in (2, 3, 4):                                 # req ids, ops, params
            np.testing.assert_array_equal(got[j], want[j])
        for j in (0, 1):                                    # images
            np.testing.assert_allclose(got[j], want[j], atol=1e-6, rtol=0)
    got = next(port.batches(4, 1, shuffle=True, seed=2))
    want = next(ref.batches(4, 1, shuffle=True, seed=2))
    for k in ("x", "y", "gt_params"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["req"] == want["req"]


@pytest.mark.parametrize("n,bs,steps,shuffle", [(10, 3, 7, True),
                                                (10, 3, 7, False),
                                                (5, 5, 3, True)])
def test_iteration_matches_jax(n, bs, steps, shuffle):
    got = list(iteration.epoch_index_batches(
        n, bs, steps, shuffle, np.random.default_rng(4)))
    want = list(jiter.epoch_index_batches(
        n, bs, steps, shuffle, np.random.default_rng(4)))
    assert len(got) == steps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    seq = [list(s) for s in iteration.sequential_index_batches(n, bs)]
    assert seq == [list(s) for s in jiter.sequential_index_batches(n, bs)]
    with pytest.raises(ValueError):
        next(iteration.epoch_index_batches(n, n + 1, 1, shuffle,
                                           np.random.default_rng(0)))


def test_prefetcher_order_error_and_close():
    out = list(Prefetcher(iter(range(6)), to_device=lambda b: b * 10,
                          depth=2))
    assert out == [0, 10, 20, 30, 40, 50]

    def broken():
        yield 1
        raise RuntimeError("bad batch")

    it = Prefetcher(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)                        # keeps raising, never blocks

    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    with Prefetcher(endless(), depth=2) as it:
        assert next(it) == 0
    time.sleep(0.3)
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n and n <= 5    # the pump stopped after close()
    assert not any(t.name == it._thread.name and t.is_alive()
                   for t in threading.enumerate())


def test_device_put_batch_on_cpu():
    u8 = np.arange(24, dtype=np.uint8).reshape(2, 3, 2, 2) * 10
    f = np.random.default_rng(0).uniform(size=(2, 3)).astype(np.float32)
    out = device_put_batch({"img": u8, "x": f, "req": ["a", "b"]}, "cpu")
    assert out["img"].dtype == torch.float32
    np.testing.assert_array_equal(out["img"].numpy(),
                                  u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out["x"].numpy(), f)
    assert out["req"] == ["a", "b"]


def test_cli_flags_and_config_match_jax():
    """Every flag of the port's trainer is the JAX CLI's, with its default,
    but `--device` (for `--cpu`) and `--glove_path` (an .npy copy of the
    GloVe rows for hosts without h5py; None reads the JAX CLI's .h5); the
    config they give is the JAX CLI's, GloVe rows frozen by default."""
    pp, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_train_args(common.add_base_args(pp))
    jcommon.add_train_args(jcommon.add_base_args(jp))
    got, want = vars(pp.parse_args([])), vars(jp.parse_args([]))
    assert got.pop("device") == "cuda" and want.pop("cpu") is False
    assert got.pop("glove_path") is None
    assert got == {k: want[k] for k in got}
    for flags in ([], ["--fix_input_embedding", "0"]):
        cfg = common.args_to_config(pp.parse_args(flags))
        jcfg = jcommon.args_to_config(jp.parse_args(flags))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(pconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())


TINY = ["--synthetic", "--device", "cpu", "--synthetic_n", "16",
        "--batch_size", "4", "--img_size", "16", "--encoder_max_len", "12",
        "--decoder_max_len", "3", "--hidden_size", "8", "--word_vec_dim",
        "8", "--operator_fc_dim", "8", "--resnet_widths", "4,4,8,8",
        "--vis_feat_dim", "8", "--print_every", "2", "--checkpoint_every",
        "2", "--val_batches", "1"]


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """`--device` defaults to cuda, and a trainer asked for CUDA where
    PyTorch finds no card raises before it builds anything, rather than
    run on the CPU; --device cpu runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    i = TINY.index("--device")
    argv = TINY[:i] + TINY[i + 2:] + ["--run_dir", str(tmp_path / "run")]
    assert train_fivek.train_parser().parse_args(argv).device == "cuda"
    for flags in ([], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_fivek.main(argv + flags)
    assert not (tmp_path / "run").exists()
    assert common.resolve_device("cpu") == torch.device("cpu")


def _same_state(a, b):
    sa, sb = a.actor.state_dict(), b.actor.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.opt.state_dict(), b.opt.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_train_fivek_runs_checkpoints_and_resumes(tmp_path):
    run = str(tmp_path / "run")
    argv = TINY + ["--run_dir", run, "--fused_exec", "1"]
    state = train_fivek.main(argv + ["--num_iters", "4"])
    assert state.step == 4
    ckdir = tmp_path / "run" / "seq2seqL1_model"
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "checkpoint_best.pt", "checkpoint_iter00000002.pt",
        "checkpoint_iter00000004.pt", "stats.json"]
    # the latest checkpoint restores the final state exactly
    a = train_fivek.train_parser().parse_args(argv)
    actor, _ = common.build_actor(a, len(synthetic_vocab()))
    fresh = TrainState(actor)
    assert not torch.equal(fresh.actor.bn1.running_mean,
                           state.actor.bn1.running_mean)
    CheckpointManager(str(ckdir)).restore(fresh, "latest")
    _same_state(fresh, state)
    # --resume continues from iteration 5 with the restored state
    resumed = train_fivek.main(argv + ["--num_iters", "6", "--resume"])
    assert resumed.step == 6
    assert (ckdir / "checkpoint_iter00000006.pt").exists()
    # max_to_keep prunes old step checkpoints but keeps the best one
    CheckpointManager(str(ckdir), max_to_keep=1).save(resumed, 7, None)
    names = sorted(p.name for p in ckdir.iterdir())
    assert "checkpoint_iter00000007.pt" in names
    assert "checkpoint_iter00000006.pt" not in names
    assert "checkpoint_best.pt" in names
