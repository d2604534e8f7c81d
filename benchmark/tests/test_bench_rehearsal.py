"""Each cell rehearsed on the CPU at tiny widths, through the harness and
its driver with the look for a card left out: the result's line has the
contract's keys, and `correct` holds. Then the timed path broken
underneath, once for each fault a cell can have, and `correct` false.
(No cell spans chips, so there is no exchange between chips to leave
out.)"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests._rehearse import drive, make_run

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(cell):
    line = drive(make_run(cell))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) == set(KEYS) | {"checks"}
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "cpu"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    json.dumps(line)


@pytest.mark.parametrize("cell", ["fivek_serve_bulk", "gier_train_b64"])
def test_rehearsal_traced_line(cell):
    line = drive(make_run(cell, trace=1))
    assert set(line) == set(KEYS) | {"breakdown", "checks"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in line["metrics"]


def test_open_loop_rehearsal():
    """The open loop (the knee's sweep, and a later tail cell) serves
    every request due in its window, correct."""
    run = make_run("fivek_serve_bulk")
    run.traffic.update(loop="open", rate_per_s=10.0)
    line = drive(run)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 15 and line["failed"] == 0
    assert len(run.readings["latencies_s"]) == 15


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


def _serving_fault(monkeypatch, where):
    from t2onet_tpu_torch.serve import ServingEngine

    if where == "token":
        decode = ServingEngine._decode

        def altered(self, *a, **kw):
            ops, params = decode(self, *a, **kw)
            ops = ops.clone()
            ops[:, 0] = torch.where(ops[:, 0] == 3, 4, 3)
            return ops, params
        monkeypatch.setattr(ServingEngine, "_decode", altered)
    else:
        execute = ServingEngine._execute

        def altered(self, *a, **kw):
            return [255 - o for o in execute(self, *a, **kw)]
        monkeypatch.setattr(ServingEngine, "_execute", altered)


@pytest.mark.parametrize("where", ["token", "answer"])
def test_serving_fault_is_caught(monkeypatch, where):
    _serving_fault(monkeypatch, where)
    line = drive(make_run("fivek_serve_bulk"))
    assert not line["correct"], line["checks"]


def test_empty_programs_are_not_correct():
    """Weights that decode <END> first for every request serve empty
    programs, which leave the decode and the chain unchecked: the run
    is not correct (`unserved_steps`)."""
    run = make_run("fivek_serve_bulk")
    run.traffic["end_logit_bias"] = 50.0
    line = drive(run)
    assert line["checks"]["unserved_steps"]["value"] == 1.0
    assert not line["correct"], line["checks"]


def _training_fault(monkeypatch, fault):
    from t2onet_tpu_torch.train import loop

    if fault == "state_unchanged":
        apply = loop.TrainState.apply_gradients

        def unchanged(self, loss):
            before = [p.detach().clone() for p in self.params]
            apply(self, loss)
            with torch.no_grad():
                for p, b in zip(self.params, before):
                    p.copy_(b)
        monkeypatch.setattr(loop.TrainState, "apply_gradients", unchanged)
    else:
        sup, epi = loop.supervised_step, loop.episode_step

        def half(batch):
            n = batch["x"].shape[0] // 2
            return {k: v[:n] for k, v in batch.items()}
        monkeypatch.setattr(loop, "supervised_step",
                            lambda s, b, **kw: sup(s, half(b), **kw))
        monkeypatch.setattr(loop, "episode_step",
                            lambda s, b, **kw: epi(s, half(b), **kw))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["gier_train_b64", "fivek_train_b64"])
def test_training_fault_is_caught(monkeypatch, cell, fault):
    _training_fault(monkeypatch, fault)
    line = drive(make_run(cell))
    assert not line["correct"], line["checks"]
