"""The control of the inpainting cell's check, and the faults planted in
it: readings that `check_inpaint` has to fail, from which the limits in
`benchmark/workloads/gier_edgeconnect_b8.json` were set (with the sound
readings of the cell's own runs). Run on the card at the cell's size:

    python3 benchmark/control_inpaint.py --seeds 1 2 3

Each reading puts the reference in the system's place over the run's
first two iterations and judges it against the reference in float32
(TF32 off):
- `tf32`: the control, one precision below the configuration's: TF32
  for the convolutions and matrix products;
- `f32_again`: the reference once more (the card's nondeterministic
  sums: cuDNN's weight gradients);
- `half_batch`: half of each batch left out;
- `no_style`: the style loss's weight 0;
- `no_power`: G's pass through D without its power iteration (it takes
  the fake pass's vectors).
Each seed's readings are printed as one JSON line. On the CPU (`readings`
of a run at a tiny size, as the tests make one) TF32 is emulated by
rounding the products' operands.
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

WORKLOAD = "gier_edgeconnect_b8"


def kept_batches(run, n):
    """The first n host batches the cell's driver stages."""
    from benchmark.drivers import inpaint

    size = run.model_config()["input_size"]
    gen = inpaint.batches(inpaint.load_images(run, size),
                          inpaint.load_masks(run, size),
                          run.traffic["batch_size"], run.seed)
    return [next(gen) for _ in range(n)]


def readings(run):
    import torch

    from benchmark import check_inpaint
    from benchmark.weights_edgeconnect import make_edgeconnect_weights

    device = torch.device(run.device)
    W = make_edgeconnect_weights(run.seed, device)
    kept = kept_batches(run, check_inpaint.STEPS)

    def follow(precision="f32", **kw):
        return check_inpaint.reference_readings(run, W, kept, device,
                                                precision, **kw)

    t = time.time()
    ref = follow()
    out = {"reference_s": time.time() - t}
    half = list(range(run.traffic["batch_size"] // 2))
    for name, kw in (("tf32", {"precision": "tf32"}), ("f32_again", {}),
                     ("half_batch", {"rows": half}),
                     ("no_style", {"fault": "no_style"}),
                     ("no_power", {"fault": "no_power"})):
        got = follow(**kw)
        if "rows" in kw:
            # the system's edges and edge G output over the whole batch
            got["edges"] = [e[:len(half)] for e in got["edges"]]
            ref_rows = dict(ref, edges=[e[:len(half)] for e in ref["edges"]],
                            pred=[p[:len(half)] for p in ref["pred"]])
            out[name] = check_inpaint.judge(got, ref_rows)
        else:
            out[name] = check_inpaint.judge(got, ref)
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
