"""The control of the pix2pixHD cell's check, and the faults planted in
it: readings that `check_p2p` has to fail, from which the limits in
`benchmark/workloads/fivek_pix2pixhd_1024p.json` were set (with the sound
readings of the cell's own runs). Run on the card at the cell's size:

    python3 benchmark/control_p2p.py --seeds 1 2 3

Each reading puts the reference in the system's place over the run's
first two iterations and judges it against the reference in float32
(TF32 off):
- `tf32`: the control, one precision below the configuration's: TF32
  for the convolutions;
- `f32_again`: the reference once more (the card's nondeterministic
  sums: cuDNN's weight gradients);
- `half_pixels`: the right half of both images gray;
- `d_batchnorm`: BatchNorm on its first running averages in D's
  instance norms' place;
- `no_global`: the global generator's output not added to the local
  branch.
Each seed's readings are printed as one JSON line. On the CPU (`readings`
of a run at a tiny size, as the tests make one) TF32 is emulated by
rounding the convolutions' operands.
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

WORKLOAD = "fivek_pix2pixhd_1024p"


def kept_batches(run, n):
    """The first n host batches the cell's driver stages."""
    from benchmark.drivers import pix2pixhd

    m = run.model_config()
    gen = pix2pixhd.batches(*pix2pixhd.load_pairs(run, m["height"],
                                                  m["width"]),
                            run.traffic["batch_size"], run.seed)
    return [next(gen) for _ in range(n)]


def readings(run):
    import torch

    from benchmark import check_p2p
    from benchmark.reference import pix2pixhd as R
    from benchmark.weights_pix2pixhd import make_pix2pixhd_weights, options

    device = torch.device(run.device)
    W = make_pix2pixhd_weights(run.seed, device,
                               options(run.model_config()))
    kept = kept_batches(run, check_p2p.STEPS)

    def follow(precision="f32", fault=None):
        return check_p2p.reference_readings(run, W, kept, device, precision,
                                            fault)

    t = time.time()
    ref = follow()
    out = {"reference_s": time.time() - t}
    for name, kw in (("tf32", {"precision": "tf32"}), ("f32_again", {}),
                     *((f, {"fault": f}) for f in R.FAULTS)):
        out[name] = check_p2p.judge(follow(**kw), ref)
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
