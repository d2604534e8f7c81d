"""GIER planner CLI: pseudo ground-truth action sequences with mask
conditioning (counterpart of `t2onet_tpu.cli.plan_gier`): all 8
operators, err 1e-3, each local operator's ground-truth masks unioned.
Output layout, as GIERDatasetAct reads it: {out_dir}/{image id}/acts.json
and edit{k}.jpg.

  python -m t2onet_tpu_torch.cli.plan_gier --data_dir data_real_gier \\
      --data_mode shapeAlign --img_size 128 --pair_batch 8 \\
      --manual_seed 10 --out_dir output/GIER_actions_set_1

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU. With an inpaint
filler (`--inpaint_ckpt`, a `cli.train_inpaint` checkpoint, or
`--edgeconnect_dir`, EdgeConnect's generators) the inpaint candidate
fills each pair's ground-truth object mask instead of executing as the
identity; pairs are then planned one at a time, since the filler
captures its pair's mask.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.cli.plan_fivek import add_plan_args
from t2onet_tpu_torch.evals.visualize import save_img
from t2onet_tpu_torch.planner.beam import (batch_beam_search, beam_search,
                                           init_distance)

# executor indices; a vocab op id maps to one as vocab id - 3
ALL_OPS = (0, 1, 2, 3, 4, 5, 6, 7)
INPAINT_EXEC = 4                       # vocab inpaint_obj (7) - 3


def plan_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    add_plan_args(p)
    p.add_argument("--data_mode", default="global+shapeAlign",
                   help="'+'-combined filters: valid/shapeAlign/"
                        "shapeAlign_nonCrop/global/full")
    p.add_argument("--is_load_mask", type=int, default=0)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--err", type=float, default=1e-3)
    p.add_argument("--mode", default="plain")
    p.add_argument("--inpaint_ckpt", default=None,
                   help="trained filler checkpoint (cli.train_inpaint run "
                        "dir's inpaint_model): the inpaint candidate fills "
                        "its ground-truth mask region instead of executing "
                        "as the identity. One pair at a time (no "
                        "--pair_batch)")
    p.add_argument("--edgeconnect_dir", default=None,
                   help="dir holding EdgeModel_gen.pth and "
                        "InpaintingModel_gen.pth: the inpaint candidate "
                        "fills through EdgeConnect's MODEL=3 pipeline. One "
                        "pair at a time; exclusive with --inpaint_ckpt")
    return p


def filler_factory(a, device):
    """pair's (1, H, W) inpaint mask -> its inpaint_fn, from
    --inpaint_ckpt or --edgeconnect_dir (None without either)."""
    if a.inpaint_ckpt and a.edgeconnect_dir:
        raise SystemExit("--inpaint_ckpt and --edgeconnect_dir are "
                         "alternative inpaint backends; pick one")
    if (a.inpaint_ckpt or a.edgeconnect_dir) and a.pair_batch > 1:
        raise SystemExit("an inpaint filler plans pairs one at a time (drop "
                         "--pair_batch): its closure captures each pair's "
                         "own mask")
    if a.inpaint_ckpt:
        from t2onet_tpu_torch.models.inpaint import (load_inpaint,
                                                     make_inpaint_fn)

        net = load_inpaint(a.inpaint_ckpt, device)
        return lambda mask: make_inpaint_fn(net, mask[None])
    if a.edgeconnect_dir:
        import torch

        from t2onet_tpu_torch.models.edgeconnect import (
            load_generator, make_edgeconnect_inpaint_fn)

        nets = [load_generator(torch.load(
            os.path.join(a.edgeconnect_dir, name), map_location="cpu",
            weights_only=True), kind, device) for name, kind in (
            ("EdgeModel_gen.pth", "edge"),
            ("InpaintingModel_gen.pth", "inpaint"))]
        return lambda mask: make_edgeconnect_inpaint_fn(*nets, mask)
    return None


def write_item(out_dir, data_id, request, img_x, img_y, actions, images):
    """Teacher images first, acts.json last: acts.json marks the item
    complete (GIERDatasetAct reads zeros for a missing edit{k}.jpg)."""
    item_dir = os.path.join(out_dir, data_id)
    os.makedirs(item_dir, exist_ok=True)
    info = {
        "request": request,
        "init distance": init_distance(img_x, img_y),
        "operation sequence": [[list(x) for x in seq] for seq in actions],
    }
    for k, img in enumerate(images[0]):
        save_img(np.asarray(img)[0], os.path.join(item_dir, f"edit{k}.jpg"))
    with open(os.path.join(item_dir, "acts.json"), "w") as f:
        json.dump(info, f)


def main(argv=None):
    """Plan; returns the number of pairs written."""
    a = plan_parser().parse_args(argv)
    a.dataset = "GIER"
    if a.session == 1:
        a.session = 3
    device = common.resolve_device(a.device)
    make_filler = filler_factory(a, device)
    out_dir = a.out_dir or f"output/GIER_actions_set_{a.action_id}"
    os.makedirs(out_dir, exist_ok=True)

    from t2onet_tpu_torch.data.gier import GIER

    gier = GIER(os.path.join(a.data_dir, "GIER"),
                os.path.join(a.data_dir, "language"), a.phase,
                data_mode=a.data_mode, is_load_mask=True,
                session=a.session, train_img_size=a.img_size)

    def load_pair(pair_id):
        item = gier.get_pair_item(pair_id)
        # per-op masks: vocab op id -> executor index (vocab - 3)
        op_masks = {}
        for op_vocab_id, mask in item.get("mask_dict", {}).items():
            op_masks[int(op_vocab_id) - 3] = mask[None].astype(np.float32)
        data_id = gier.op_data[pair_id]["input"].split("_")[0]
        return (item["input"][None], item["output"][None], item["request"],
                op_masks, data_id)

    kw = dict(beam_size=a.beam_size, operations=ALL_OPS,
              max_step=len(ALL_OPS), err=a.err, mode=a.mode,
              n_starts=a.n_starts, n_iters=a.n_iters, lr=a.lr,
              dist_type=a.dist_type, device=device)
    pair_ids = list(range(a.start, len(gier)))
    if a.limit is not None:
        pair_ids = pair_ids[: a.limit]

    n, t0 = 0, time.time()
    if a.pair_batch > 1:
        for first in range(0, len(pair_ids), a.pair_batch):
            ids = pair_ids[first:first + a.pair_batch]
            buf = [load_pair(i) for i in ids]
            # seed = manual_seed + the batch's first pair id
            results = batch_beam_search(
                np.concatenate([b[0] for b in buf]),
                np.concatenate([b[1] for b in buf]),
                seed=a.manual_seed + ids[0],
                op_masks=[b[3] for b in buf], **kw)
            for (actions, images), b in zip(results, buf):
                write_item(out_dir, b[4], b[2], b[0], b[1], actions, images)
                n += 1
            print(f"planned {n} pairs, "
                  f"{(time.time() - t0) / max(n, 1):.2f}s/pair", flush=True)
    else:
        for pair_id in pair_ids:
            img_x, img_y, request, op_masks, data_id = load_pair(pair_id)
            inpaint_fn = None
            if make_filler is not None and INPAINT_EXEC in op_masks:
                # the filler fills THIS pair's ground-truth object mask
                inpaint_fn = make_filler(op_masks[INPAINT_EXEC])
            actions, images = beam_search(
                img_x, img_y, seed=a.manual_seed + pair_id,
                op_masks=op_masks or None, inpaint_fn=inpaint_fn, **kw)
            write_item(out_dir, data_id, request, img_x, img_y, actions,
                       images)
            n += 1
            if n % 5 == 0:
                print(f"planned {n} pairs, "
                      f"{(time.time() - t0) / n:.2f}s/pair", flush=True)
    print(f"done: {n} pairs, {(time.time() - t0) / max(n, 1):.2f}s/pair")
    return n


if __name__ == "__main__":
    main()
