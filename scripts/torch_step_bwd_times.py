"""Device and call times of the port's four kernels, their per-slot times
(B3 and B4, then B1 and B2) and the compiler's budget for every kernel,
for one tree of the port on one CUDA card.

    PYTHONPATH=<tree> python3 scripts/torch_step_bwd_times.py --label NAME \
        [--train_steps] [--out FILE]

`t2onet_tpu_torch` is imported from <tree> (a checkout of any commit of
the port, e.g. the parent unpacked with `git archive`), the timing code
from this checkout's chip_smoke.py, so that two trees are measured alike:
run parent, change, change, parent in one command on one card. Prints
ptxas's lines for every kernel, then per kernel and shape the device time
(a CUDA graph of 40 calls, chip_smoke.device_ms), the call time (CUDA
events around one wrapper call, chip_smoke.time_ms) and, for B3 and B4,
each CUDA kernel's own time from torch.profiler, with every kernel's
bound (chip_smoke.chain_bound, step_bound); then the slot-uniform tables of
chip_smoke's phases 6b (B3, B4 at b64 x 128 px) and 6c (B1, B2 at b64 x
128 px x K1, B1 at b128 x 512 px x K5). --train_steps then also runs chip_smoke's phases 8
and 10 (both trainers, 8 iterations at full width, then each step timed on
batches already on the card, and the GIER masked episode step's kernels
profiled). Whether the kernels are right is chip_smoke.py's to check. The
last line is one JSON object of the readings; --out also writes it to a
file.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--train_steps", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cs = load_chip_smoke()
    smi = cs.device_phase()
    cs.build_phase()
    from t2onet_tpu_torch.ops import chain, step

    cs.log(f"t2onet_tpu_torch from {os.path.dirname(step.__file__)}")
    out = {"label": a.label, "card": smi, "kernels": {}}
    cases = {
        "B1 b128x512x512 K5": (chain.fused_chain, cs.bench_workload()),
        "B1 b8x512x512 K5": (chain.fused_chain,
                             cs.random_case(8, 512, 512, seed=2)),
        "B1 b64x128x128 K1": (chain.fused_chain,
                              cs.step_k1_case(64, 128, 128, seed=10)),
        "B2 b128x512x512 K5": (chain.fused_chain, cs.bench_workload()
                               + (cs.half_mask(128, 512, 512, 20),)),
        "B2 b64x128x128 K1": (chain.fused_chain,
                              cs.step_k1_case(64, 128, 128, seed=10)
                              + (cs.step_mask(64, 128, 128, 21),)),
        "B3 b64x128x128": (step.step_bwd, cs.step_case(64, 128, 128, 10)),
        "B3 b128x512x512": (step.step_bwd, cs.step_case(128, 512, 512, 11)),
        "B4 b64x128x128": (step.step_bwd, cs.step_case(64, 128, 128, 10)
                           + (cs.step_mask(64, 128, 128, 30),)),
        "B4 b128x512x512": (step.step_bwd, cs.step_case(128, 512, 512, 11)
                            + (cs.step_mask(128, 512, 512, 31),)),
    }
    for name, (fn, arrays) in cases.items():
        args = cs.to_card(*arrays)
        dev = cs.device_ms(fn, cs.rotations(args, 2 * args[0].numel() * 4))
        call = cs.time_ms(lambda: fn(*args))
        rec = {"device_ms": statistics.median(dev), "device_ms_all": dev,
               "call_ms": statistics.median(call)}
        h, w = args[0].shape[2:]
        if fn is step.step_bwd:
            rec["bound_ms"] = cs.step_bound(args[1], h, w, len(args) == 5)[0]
            rec["kernels_us"] = cs.profiled_us(lambda: fn(*args), 20)
        else:
            rec["bound_ms"] = cs.chain_bound(args[1], h, w,
                                             len(args) == 4)[0]
        out["kernels"][name] = rec
        cs.log(f"{name}: device {rec['device_ms']:.4f} ms (replays "
               f"{[round(x, 4) for x in dev]}), call {rec['call_ms']:.4f} ms"
               f", bound {rec['bound_ms']:.4f} ms"
               + (f"; profiler µs per call {rec['kernels_us']}"
                  if "kernels_us" in rec else ""))
    out["slots_b64_128"] = cs.slot_phase()
    out["chain_slots"] = cs.chain_slot_phase()
    if a.train_steps:
        state, _ = cs.train_phase()
        out["train"] = cs.train_timing_phase(state)
        del state
        state, _ = cs.gier_train_phase()
        out["gier_train"] = cs.gier_timing_phase(state)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
