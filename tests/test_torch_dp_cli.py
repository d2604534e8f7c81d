"""The port's data-parallel entry points on the CPU, at tiny widths:
`cli.train_fivek` under torchrun with two gloo ranks against one
process, the refusals of `--data_parallel`, `cli.plan_fleet` (its index
shards, `verify`, a two-worker fan-out against one process, and
`--verify_only`), `plan_fivek --data_parallel`, and the dry run's twin
at n=2.

The two-rank trainer's logged losses are held to one process's within
1e-5 relative and its final weights within 1e-5: both runs take the same
batches and draws and differ only in the order of summation (the losses'
and BatchNorm's sums over the ranks). `vis_encoder.fc.bias` feeds a
BatchNorm, so its true gradient is 0 and Adam moves it by rounding noise
(lr * g / (|g| + eps)): it is held to Adam's bound, lr a step."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from t2onet_tpu.cli import plan_fleet as jfleet
from t2onet_tpu_torch.cli import common, plan_fivek, plan_fleet, train_fivek
from t2onet_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--synthetic", "--device", "cpu", "--synthetic_n", "16",
        "--batch_size", "4", "--img_size", "16", "--encoder_max_len", "12",
        "--decoder_max_len", "3", "--hidden_size", "8", "--word_vec_dim",
        "8", "--operator_fc_dim", "8", "--resnet_widths", "4,4,8,8",
        "--vis_feat_dim", "8", "--print_every", "1", "--val_batches", "1",
        "--num_iters", "2", "--checkpoint_every", "2"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def _weights(run_dir):
    path = os.path.join(run_dir, "seq2seqL1_model", "checkpoint_best.pt")
    blob = torch.load(path, weights_only=False, map_location="cpu")
    return blob["model"] if "model" in blob else blob["actor"]


def test_train_fivek_two_ranks_match_one_process(tmp_path):
    one = train_fivek.main(TINY + ["--run_dir", str(tmp_path / "one")])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "t2onet_tpu_torch.cli.train_fivek"]
        + TINY + ["--run_dir", str(tmp_path / "two")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "data-parallel over 2 rank(s) (gloo), 2 rows a rank" in out.stdout
    # rank 0 alone prints: one line a step
    assert out.stdout.count("iter      1/2") == 1
    logs = []
    for run in ("one", "two"):
        with open(tmp_path / run / "metrics.jsonl") as f:
            logs.append([{k: v for k, v in json.loads(line).items()
                          if k != "time"} for line in f])
    assert [sorted(r) for r in logs[0]] == [sorted(r) for r in logs[1]]
    for a, b in zip(*logs):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    got = _weights(str(tmp_path / "two"))
    for k, w in one.actor.state_dict().items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
            continue
        atol = 2 * 1e-3 if k == "vis_encoder.fc.bias" else 1e-5
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def test_data_parallel_refusals(monkeypatch):
    a = train_fivek.train_parser().parse_args(TINY + ["--batch_size", "3"])
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="--batch_size 3 not divisible by "
                                         "the world size 2"):
        common.join_data_parallel(a)
    a.data_parallel = 0
    with pytest.raises(SystemExit, match="each would train alone"):
        common.join_data_parallel(a)


def test_plan_fleet_shards_and_verify(tmp_path):
    for total, shards in ((17, 4), (16, 4), (5, 8), (3, 1)):
        for i in range(shards):
            assert plan_fleet.shard_range(total, i, shards) == \
                jfleet.shard_range(total, i, shards)
    out = str(tmp_path)
    for i in (0, 1, 3):
        os.makedirs(os.path.join(out, f"train{i}"))
        with open(os.path.join(out, f"train{i}", f"{i:05d}.json"), "w") as f:
            json.dump({"operation sequence": []} if i != 3 else {}, f)
    assert plan_fleet.verify(out, "train", 0, 5) == [2, 3, 4]
    assert plan_fleet.verify(out, "train", 0, 5) == \
        jfleet.verify(out, "train", 0, 5)


def test_plan_fleet_two_workers_match_one_process(tmp_path):
    """Two CPU workers over 4 pairs (pair_batch 2, so each worker's batch
    is one of the one-process run's) write one process's JSONs; then
    --verify_only passes, and fails on a missing pair."""
    plan = ["--synthetic", "--synthetic_n", "16", "--img_size", "16",
            "--n_iters", "5", "--pair_batch", "2"]
    fleet_dir = str(tmp_path / "fleet")
    out = subprocess.run(
        [sys.executable, "-m", "t2onet_tpu_torch.cli.plan_fleet", "--total",
         "4", "--workers", "2", "--worker_cpu", "--out_dir", fleet_dir]
        + plan, env=_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["workers"] == 2 and summary["missing_after"] == 0
    one_dir = str(tmp_path / "one")
    assert plan_fivek.main(plan + ["--device", "cpu", "--limit", "4",
                                   "--out_dir", one_dir]) == 4
    for i in range(4):
        name = os.path.join(f"train{i}", f"{i:05d}.json")
        with open(os.path.join(fleet_dir, name)) as f:
            got = json.load(f)
        with open(os.path.join(one_dir, name)) as f:
            assert got == json.load(f), name
    with pytest.raises(SystemExit) as e:
        plan_fleet.main(["--total", "4", "--verify_only", "--out_dir",
                         fleet_dir])
    assert e.value.code == 0
    os.remove(os.path.join(fleet_dir, "train2", "00002.json"))
    with pytest.raises(SystemExit) as e:
        plan_fleet.main(["--total", "4", "--verify_only", "--out_dir",
                         fleet_dir])
    assert e.value.code == 1


def test_plan_fivek_data_parallel_on_cpu_entries(tmp_path):
    """--data_parallel 2 with --device cpu: the lockstep fits split over
    two CPU entries, the same plans as one."""
    plan = ["--synthetic", "--synthetic_n", "16", "--img_size", "16",
            "--n_iters", "5", "--pair_batch", "3", "--limit", "3",
            "--device", "cpu"]
    assert plan_fivek.main(plan + ["--data_parallel", "2", "--out_dir",
                                   str(tmp_path / "dp")]) == 3
    assert plan_fivek.main(plan + ["--out_dir", str(tmp_path / "one")]) == 3
    for i in range(3):
        name = os.path.join(f"train{i}", f"{i:05d}.json")
        with open(tmp_path / "dp" / name) as f:
            got = json.load(f)
        with open(tmp_path / "one" / name) as f:
            want = json.load(f)
        assert [a[0] for a in got["operation sequence"]] == \
            [a[0] for a in want["operation sequence"]]


def test_dryrun_twin(tmp_path, capsys):
    out = dryrun.dryrun_multichip(2, job_dir=str(tmp_path / "ranks"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(2) ")
    assert out["serve_reqs"] == 2
    assert all(np.isfinite(out[k]) for k in ("sup_loss", "epi_loss",
                                             "plan_dist", "gan_G", "gan_D"))
