"""The control of the GAN cell's check, and the faults planted in it:
readings that `check_gan` has to fail, from which the limits in
`benchmark/workloads/fivek_gan_b64.json` were set (with the sound
readings of the cell's own runs). Run on the card at the cell's sizes:

    python3 benchmark/control_gan.py --seeds 1 2 3

Each reading puts the reference in the system's place over the run's
first three iterations and judges it against the reference in float32
(TF32 off):
- `tf32`: the control, one precision below the configuration's: TF32 for
  the convolutions and matrix products, bfloat16 for the chain's other
  float32 work (`reference.model.set_precision`);
- `f32_again`: the reference once more (the card's nondeterministic
  sums: cuDNN's weight gradients);
- `half_batch`: half of each batch left out;
- `no_cond`: the sentence code left out (zeros) in the GAN iteration;
- `bn_running`: D's BatchNorms on their running averages in G's and D's
  passes.
Each seed's readings are printed as one JSON line. On the CPU
(`readings` of a run at tiny widths, as the tests make one) TF32 is
emulated by rounding the products' operands.
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

WORKLOAD = "fivek_gan_b64"


def readings(run):
    import torch

    from benchmark import check_gan
    from benchmark.drivers import train
    from benchmark.weights import make_weights
    from benchmark.weights_gan import make_disc_weights

    device = torch.device(run.device)
    model = run.model_config()
    W = make_weights(model, len(run.vocab()), run.seed, device)
    WD = make_disc_weights(run.config["gan"], check_gan.hidden_dim(model),
                           run.seed, device)
    kept = train.followed_batches(run, train.load_pool(run))
    initial = {n: WD[n].clone() for n in check_gan.stat_keys(WD)}

    def gumbel(step, k, shape):
        return train.gumbel(run.seed, step, k, shape, device)

    def follow(precision="f32", **kw):
        return check_gan.reference_readings(run, W, WD, kept, gumbel,
                                            device, precision, **kw)

    t = time.time()
    ref = follow()
    out = {"reference_s": time.time() - t}
    half = list(range(run.traffic["batch_size"] // 2))
    for name, kw in (("tf32", {"precision": "tf32"}), ("f32_again", {}),
                     ("half_batch", {"rows": half}),
                     ("no_cond", {"fault": "no_cond"}),
                     ("bn_running", {"fault": "bn_running"})):
        out[name] = check_gan.judge(follow(**kw), ref, initial)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    from benchmark.harness import Run

    for seed in a.seeds:
        args = argparse.Namespace(workload=WORKLOAD, seed=seed, seconds=1.0,
                                  trace=0)
        run = Run(args, time.time())
        print(json.dumps({"workload": WORKLOAD, "seed": seed,
                          **readings(run)}), flush=True)


if __name__ == "__main__":
    main()
