"""How far equally valid arithmetic moves the PyTorch port's planner on a
CUDA card: the same lockstep batches planned three ways.

    python3 scripts/torch_plan_noise.py [--out DIR]

FiveK train pairs 8-15 (seed 18) and GIER shapeAlign train pairs 0-7
(seed 10) and 8-15 (seed 18), at the committed action sets' settings
(128 px, beam 3, 2 restarts, 100 Adam iterations; GIER with its masks,
all 8 ops, err 1e-3), are planned in f32 as one lockstep batch of 8, in
f32 pair by pair, and in f64 as one batch. A batch's shape changes the
order of the card's f32 reductions, and f64 rounds far less, so the
spread among the three (and their gaps to the JAX planner's committed
plans, which `chip_smoke.py` reads) is the floor under any distance
bound between two implementations of the planner. Writes every pair's
top-beam (op, distance) list per way to DIR/plan_noise.json (default
output/) and prints each way's largest distance gap to the JAX
plans where the op sequences agree. Needs a card; imports nothing of
JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

from t2onet_tpu_torch.cli.common import resolve_device  # noqa: E402
from t2onet_tpu_torch.data.fivek import FiveK  # noqa: E402
from t2onet_tpu_torch.data.gier import GIER  # noqa: E402
from t2onet_tpu_torch.planner.beam import batch_beam_search  # noqa: E402


def top(results):
    return [[(a[0], a[2]) for a in actions[0]] for actions, _ in results]


def three_ways(x, y, seed, op_masks=None, **kw):
    """{way: per-pair top beams} for lockstep f32, pair-by-pair f32 and
    lockstep f64."""
    def f64(masks):
        return None if masks is None else [
            {o: m.astype(np.float64) for o, m in d.items()} for d in masks]

    out = {"p8_f32": top(batch_beam_search(
        x, y, seed=seed, op_masks=op_masks, device="cuda", **kw))}
    out["p1_f32"] = [top(batch_beam_search(
        x[i:i + 1], y[i:i + 1], seed=seed, device="cuda",
        op_masks=None if op_masks is None else op_masks[i:i + 1], **kw))[0]
        for i in range(len(x))]
    out["p8_f64"] = top(batch_beam_search(
        x.astype(np.float64), y.astype(np.float64), seed=seed,
        op_masks=f64(op_masks), device="cuda", **kw))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="output")
    a = p.parse_args()
    resolve_device("cuda")
    res, jax_plans = {}, {}
    ds = FiveK(os.path.join("data_real_h2h", "FiveK", "images"),
               os.path.join("data_real_h2h", "FiveK", "annotations"),
               "train", 1, 128, eval_img_mode="train_size")
    items = [ds[i] for i in range(8, 16)]
    t0 = time.time()
    res["fivek_8_15"] = three_ways(np.stack([it[0] for it in items]),
                                   np.stack([it[1] for it in items]), 18)
    jax_plans["fivek_8_15"] = [
        os.path.join("data_real_h2h_acts", "actions_set_1", f"train{i}",
                     f"{i:05d}.json") for i in range(8, 16)]
    print(f"fivek_8_15 {time.time() - t0:.1f} s", flush=True)
    gier = GIER(os.path.join("data_real_gier", "GIER"),
                os.path.join("data_real_gier", "language"), "train",
                data_mode="shapeAlign", is_load_mask=True,
                train_img_size=128)
    for lo in (0, 8):
        its = [gier.get_pair_item(i) for i in range(lo, lo + 8)]
        masks = [{int(k) - 3: m[None].astype(np.float32)
                  for k, m in it["mask_dict"].items()} for it in its]
        name = f"gier_{lo}_{lo + 7}"
        t0 = time.time()
        res[name] = three_ways(
            np.stack([it["input"] for it in its]),
            np.stack([it["output"] for it in its]), 10 + lo,
            op_masks=masks, operations=tuple(range(8)), max_step=8,
            err=1e-3)
        jax_plans[name] = [
            os.path.join("data_real_gier_acts", "GIER_actions_set_1",
                         gier.op_data[i]["input"].split("_")[0], "acts.json")
            for i in range(lo, lo + 8)]
        print(f"{name} {time.time() - t0:.1f} s", flush=True)
    for name, ways in res.items():
        want = []
        for path in jax_plans[name]:
            with open(path) as f:
                want.append([(s[0], s[2]) for s in
                             json.load(f)["operation sequence"][0]])
        for way, plans in ways.items():
            gaps = []
            for got, exp in zip(plans, want):
                for g, w in zip(got, exp):
                    if g[0] != w[0]:
                        break             # the plans part here
                    gaps.append(abs(g[1] - w[1]))
            same = sum([s[0] for s in got] == [s[0] for s in exp]
                       for got, exp in zip(plans, want))
            print(f"{name} {way}: {same} of {len(want)} op sequences as "
                  f"JAX's, largest distance gap {max(gaps):.3e} where the "
                  f"ops agree", flush=True)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "plan_noise.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
