"""The control of each cell's check comes out as not correct: the
reference put in the system's place one precision below the
configuration's (TF32 for f32 with TF32 off). On the CPU at tiny widths
with TF32 emulated; on a card at the cell's own size over three seeds."""

import argparse
import time

import pytest

from benchmark import control, harness
from benchmark.tests._rehearse import make_run

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


def _fails(run, readings) -> bool:
    limits = run.cell["limits"]
    numbers = readings["tf32"]
    # the driver's own numbers (`pool_off`) are not the control's
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


def _readings(run):
    if run.traffic["kind"] == "serve":
        return control.serving_readings(run, "tf32")
    return control.training_readings(run, "tf32")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_tiny_widths(cell):
    run = make_run(cell)
    run.cell["check"]["requests"] = 64
    assert _fails(run, _readings(run))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (101, 102, 103):
        args = argparse.Namespace(workload=cell, seed=seed,
                                  seconds=harness.load_json(
                                      harness.ROOT, "BENCHMARK.json")[
                                      "run_seconds"], trace=0)
        run = harness.Run(args, time.time())
        assert _fails(run, _readings(run)), seed
