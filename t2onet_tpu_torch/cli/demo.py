"""Single-image demo: request -> operation program -> edited images
(counterpart of `t2onet_tpu.cli.demo`).

  python -m t2onet_tpu_torch.cli.demo --img photo.jpg \\
      --request "increase the brightness" --run_dir output/FiveK_trial_1

Decode mode tokenizes --request, loads the run dir's checkpoint and runs
the greedy rollout at the image's own resolution (short side
--short_size), each step through the chain kernel at K=1 on the card
and through the bank on the CPU. --program
executes an explicit op sequence instead, with an optional --mask and an
inpaint filler (--inpaint_ckpt or --edgeconnect_dir). Either writes
input.jpg, step{i}.jpg, output.jpg and program.json to --out_dir
(default {run_dir}/demo).

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.data.fivek import (ACT2PN,
                                         load_infer_img_short_size_bounded)
from t2onet_tpu_torch.data.text import txt2idx
from t2onet_tpu_torch.evals.visualize import save_img
from t2onet_tpu_torch.ops.operators import OP_NAMES, apply_op_by_index
from t2onet_tpu_torch.train.checkpoint import restore_actor
from t2onet_tpu_torch.train.loop import eval_episode

CKPT_NAMES = ("seq2seqL1_model", "seq2seqGAN_model", "seq2seqRL_model")


def _load_mask(path, hw, device):
    """A grayscale mask image -> (1, 1, H, W) binary f32 (> 0.5 edits)."""
    from PIL import Image

    m = np.asarray(Image.open(path).convert("L"), np.float32) / 255.0
    if m.shape != tuple(hw):
        raise SystemExit(f"--mask shape {m.shape} != image {tuple(hw)}")
    return torch.from_numpy((m > 0.5).astype(np.float32)[None, None]) \
        .to(device)


def _inpaint_filler(a, mask, device):
    """The --program inpaint backend: a trained InpaintNet, EdgeConnect's
    generators, or None (the slot's identity)."""
    if a.inpaint_ckpt and a.edgeconnect_dir:
        raise SystemExit("--edgeconnect_dir and --inpaint_ckpt are mutually "
                         "exclusive inpaint backends")
    if (a.inpaint_ckpt or a.edgeconnect_dir) and mask is None:
        flag = "--inpaint_ckpt" if a.inpaint_ckpt else "--edgeconnect_dir"
        raise SystemExit(f"{flag} needs --mask (the hole)")
    if a.inpaint_ckpt:
        from t2onet_tpu_torch.models.inpaint import (load_inpaint,
                                                     make_inpaint_fn)

        return make_inpaint_fn(load_inpaint(a.inpaint_ckpt, device), mask)
    if a.edgeconnect_dir:
        from t2onet_tpu_torch.models.edgeconnect import load_edgeconnect

        return load_edgeconnect(
            os.path.join(a.edgeconnect_dir, "EdgeModel_gen.pth"),
            os.path.join(a.edgeconnect_dir, "InpaintingModel_gen.pth"),
            mask.cpu().numpy()[0, 0], device=device)
    return None


@torch.no_grad()
def _run_program(a, img, out_dir, device):
    """--program mode: apply an explicit executor-op sequence, with an
    optional --mask (local edits, the inpaint hole) and a filler for
    inpaint steps."""
    program = json.loads(a.program)
    mask = _load_mask(a.mask, img.shape[2:], device) if a.mask else None
    inpaint_fn = _inpaint_filler(a, mask, device)
    save_img(img[0], os.path.join(out_dir, "input.jpg"))
    cur, steps = torch.from_numpy(np.ascontiguousarray(img)).to(device), []
    for i, (name, params) in enumerate(program):
        op = OP_NAMES.index(name)              # raises on unknown op
        p_arr = np.zeros((1, max(ACT2PN[name], 1)), np.float32)
        if params:
            p_arr = np.asarray(params, np.float32)[None]
        cur = apply_op_by_index(cur, op, torch.from_numpy(p_arr).to(device),
                                mask=mask, inpaint_fn=inpaint_fn)
        save_img(cur[0].cpu().numpy(), os.path.join(out_dir, f"step{i}.jpg"))
        steps.append({"op": name, "params": list(map(float, params or []))})
    save_img(cur[0].cpu().numpy(), os.path.join(out_dir, "output.jpg"))
    with open(os.path.join(out_dir, "program.json"), "w") as f:
        json.dump({"program": steps, "mask": a.mask,
                   "inpaint_ckpt": a.inpaint_ckpt}, f, indent=2)
    print(f"executed {len(steps)}-step program -> {out_dir}")
    return steps


def demo_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    p.add_argument("--img", required=False, default=None)
    p.add_argument("--request", default="increase the brightness")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--short_size", type=int, default=600)
    p.add_argument("--ckpt_name", default=None,
                   help="checkpoint subdir (default: the first of "
                        "seq2seqL1_model / seq2seqGAN_model / "
                        "seq2seqRL_model in the run dir that holds a "
                        "checkpoint_best.pt)")
    p.add_argument("--program", default=None,
                   help="execute an explicit op program instead of "
                        "decoding one from --request: a JSON list of "
                        "[op_name, [params...]] pairs (executor names, "
                        "ops/operators.py OP_NAMES). No model needed")
    p.add_argument("--mask", default=None,
                   help="grayscale mask image for --program: nonzero = "
                        "edit region (local ops / the inpaint hole)")
    p.add_argument("--edgeconnect_dir", default=None,
                   help="dir holding EdgeConnect's EdgeModel_gen.pth and "
                        "InpaintingModel_gen.pth, the inpaint filler of "
                        "--program")
    p.add_argument("--inpaint_ckpt", default=None,
                   help="trained filler (cli.train_inpaint run dir's "
                        "inpaint_model): --program inpaint steps fill the "
                        "--mask region instead of passing through")
    return p


def main(argv=None):
    """Returns the written program's steps."""
    a = demo_parser().parse_args(argv)
    device = common.resolve_device(a.device)
    run_dir = common.resolve_run_dir(a, record=False)
    out_dir = a.out_dir or os.path.join(run_dir, "demo")
    os.makedirs(out_dir, exist_ok=True)

    if a.img:
        img = load_infer_img_short_size_bounded(a.img, a.short_size)[None]
    else:  # no image given: procedural demo image
        y, x = np.mgrid[0:a.img_size, 0:a.img_size].astype(np.float32)
        y, x = y / (a.img_size - 1), x / (a.img_size - 1)
        img = np.clip(np.stack([0.2 + 0.5 * x, 0.25 + 0.4 * y,
                                0.3 + 0.3 * (x + y) / 2], 0), 0, 1)[None]
    if a.program:
        return _run_program(a, img, out_dir, device)

    # the vocabulary only: the demo edits a user's image and needs no
    # dataset annotations or images
    vocab2id, id2op, w2v = common.build_vocab_only(a)
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    for name in ([a.ckpt_name] if a.ckpt_name else CKPT_NAMES):
        ckpt_dir = os.path.join(run_dir, name)
        if os.path.exists(os.path.join(ckpt_dir, "checkpoint_best.pt")):
            restore_actor(actor, ckpt_dir, "best")
            print(f"loaded checkpoint from {ckpt_dir}")
            break
    else:
        print("WARNING: no checkpoint — using random init")
    actor = actor.to(device)
    x_idx = txt2idx(a.request, vocab2id, a.encoder_max_len)
    batch = {"x": torch.from_numpy(x_idx).to(device),
             "img_x": torch.from_numpy(np.ascontiguousarray(img)).to(device)}
    # each rollout step through the chain kernel on the card, through the
    # bank (as the JAX demo) on the CPU
    pred, out = eval_episode(actor, batch, fused_exec=device.type == "cuda")

    save_img(img[0], os.path.join(out_dir, "input.jpg"))
    ops = out["ops"][0].cpu().numpy()
    imgs = out["imgs"][0].cpu().numpy()
    params = out["params"][0].cpu().numpy()
    steps = []
    for i, op in enumerate(ops):
        save_img(imgs[i], os.path.join(out_dir, f"step{i}.jpg"))
        if int(op) >= 3:
            name = OP_NAMES[int(op) - 3]
            steps.append({
                "op": name,
                "vocab_token": id2op.get(int(op), int(op)),
                "params": params[i, :max(ACT2PN[name], 1)].round(4).tolist(),
            })
        else:
            steps.append({"op": id2op.get(int(op), int(op)), "params": []})
        if int(op) == 2:          # <END>
            break
    save_img(pred[0].cpu().numpy(), os.path.join(out_dir, "output.jpg"))
    with open(os.path.join(out_dir, "program.json"), "w") as f:
        json.dump({"request": a.request, "steps": steps}, f, indent=2)
    print(f"request: {a.request!r}")
    print("program:", json.dumps(steps))
    print(f"wrote {out_dir}/input.jpg, step*.jpg, output.jpg, program.json")
    return steps


if __name__ == "__main__":
    main()
