"""A cell run on the CPU at tiny widths, through the harness and its
driver as `run.py` runs it, with the look for a card left out."""

import argparse
import os
import time

import torch

from benchmark import harness

TINY_MODEL = {"resnet_widths": [8, 8, 16, 16], "hidden_size": 16,
              "word_vec_dim": 16, "operator_fc_dim": 16, "vis_feat_dim": 32}
TINY_TRAFFIC = {"long_side": 64, "rate_per_s": 10.0, "clients": 8,
                "ramp_s": 0.3, "images_per_aspect": 2, "trace_s": 0.5,
                "batch_size": 4}


def make_run(cell, seed=2 ** 31 + 12345, seconds=1.5, trace=0):
    torch.set_num_threads(2)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    run = harness.Run(args, time.time(), device="cpu",
                      overrides={"model": TINY_MODEL,
                                 "traffic": TINY_TRAFFIC})
    run.install_kernel_log()
    return run


def drive(run):
    driver = harness.load_module(
        os.path.join(harness.HERE, "drivers", f"{run.traffic['kind']}.py"),
        f"driver_{run.traffic['kind']}")
    return run.result(driver.run(run))
