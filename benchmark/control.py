"""The control of a cell's check, and the faults planted in it: readings
that the check has to fail, from which the limits in
`benchmark/workloads/<cell>.json` were set (with the lower readings of
the benchmark's own runs). Run on the card at the cell's own sizes:

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

The control is the reference put in the system's place and computed one
precision below the configuration's: TF32 for its float32 convolutions
and matrix products (TF32 off), bfloat16 for the chain's other float32
work. A
serving cell's control decodes and executes the seed's requests (as many
as a run checks) and serves them as the system does; a training cell's
follows the run's first three steps. Training cells also read the
reference against itself run again (the card's nondeterministic sums),
and the planted faults: half of each batch left out (the mean over the rest),
and a state left unchanged (a change of 0 reads 1 by the measure). Each
reading is printed as one JSON line.

Without a card (`--device cpu`) the same runs at the tests' tiny widths
emulate TF32 by rounding the products' operands.

A serving cell also reads a planted fault: the reference's own answers
with each request's first op swapped for another and the image executed
with it (`token`). With `--program` the script instead runs the system
itself through the cell's driver for each seed in one process, a window
of `--seconds` each, and prints the numbers its check compares: the
lower readings, where a run's set-up is long.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def serving_readings(run, precision: str):
    import numpy as np
    import torch

    from benchmark import check_serve
    from benchmark.reference import model as RM
    from benchmark.traffic import Traffic
    from benchmark.weights import serving_weights

    device = torch.device(run.device)
    vocab2id = run.vocab()
    model = run.model_config()
    W = serving_weights(model, len(vocab2id), run.seed, device, run.traffic)
    traffic = Traffic(run.traffic, run.root, run.seed, run.seconds)
    n = min(run.cell["check"]["requests"], len(traffic.requests))
    texts = [traffic.requests[i][3] for i in range(n)]
    images = [traffic.image(i) for i in range(n)]
    RM.set_precision(precision, device)
    answers = check_serve.control_answers(W, model, run.op_config(),
                                          vocab2id, texts, images,
                                          run.traffic["engine"], device)
    RM.set_precision("f32", device)
    t = time.time()
    numbers = check_serve.judge(answers, texts, images, W, model,
                                run.op_config(), vocab2id,
                                run.traffic["engine"], device, 0)
    numbers["reference_s"] = time.time() - t
    numbers["requests"] = n
    ops, params = check_serve.reference_answers(
        W, model, run.op_config(), vocab2id, texts, images,
        run.traffic["engine"], device)
    ops[:, 0] = np.where(ops[:, 0] == 3, 4, np.where(ops[:, 0] >= 3, 3,
                                                     ops[:, 0]))
    imgs = check_serve.execute(images, ops, params, run.traffic["engine"],
                               device)
    token = check_serve.judge(
        check_serve.served_answers(ops, params, imgs), texts, images, W,
        model, run.op_config(), vocab2id, run.traffic["engine"], device, 0)
    return {precision: numbers, "token": token}


def program_readings(run):
    from benchmark.harness import load_module

    driver = load_module(os.path.join(HERE, "drivers",
                                      f"{run.traffic['kind']}.py"),
                         f"driver_{run.traffic['kind']}")
    out = driver.run(run)
    return {"program": out["numbers"], "attempted": out["attempted"],
            "failed": out["failed"]}


def training_readings(run, precision: str):
    import torch

    from benchmark import check_train
    from benchmark.drivers import train
    from benchmark.weights import make_weights

    device = torch.device(run.device)
    W = make_weights(run.model_config(), len(run.vocab()), run.seed, device)
    pool = train.load_pool(run)
    kept = train.followed_batches(run, pool)

    def gumbel(step, k, shape):
        return train.gumbel(run.seed, step, k, shape, device)

    t = time.time()
    ref = check_train.reference_readings(run, W, kept, gumbel, device, "f32")
    out = {"reference_s": time.time() - t}
    ctl = check_train.reference_readings(run, W, kept, gumbel, device,
                                         precision)
    out[precision] = check_train.judge(ctl, ref)
    half = list(range(run.traffic["batch_size"] // 2))
    faulty = check_train.reference_readings(run, W, kept, gumbel, device,
                                            "f32", rows=half)
    out["half_batch"] = check_train.judge(faulty, ref)
    again = check_train.reference_readings(run, W, kept, gumbel, device,
                                           "f32")
    out["f32_again"] = check_train.judge(again, ref)
    still = dict(ref, change_norms={k: 0.0 for k in ref["change_norms"]})
    out["state_unchanged"] = check_train.judge(still, ref)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", action="store_true")
    a = p.parse_args(argv)
    from benchmark.harness import Run

    for seed in a.seeds:
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        run = Run(args, time.time(), device=a.device)
        if a.program:
            if a.device == "cuda":
                run.install_kernel_log()
            print(json.dumps({"workload": a.workload, "seed": seed,
                              **program_readings(run)}), flush=True)
            continue
        read = (serving_readings if run.traffic["kind"] == "serve"
                else training_readings)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **read(run, "tf32")}), flush=True)


if __name__ == "__main__":
    main()
