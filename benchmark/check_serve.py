"""The comparison that decides `correct` in a serving cell.

Each checked request's served answer (its op names, parameters and edited
uint8 image) is held against the reference (`reference.model.decode`,
`reference.ops.chain_forward`), which works the answer out again from the
same request text and image:

- `op_gap`: the widest gap by which a served op's log-probability lies
  below the reference's best at that step, the reference following the
  served ops (the served <END> included);
- `param_gap`: the widest distance between a served parameter and the
  reference's for the same step;
- `param_off`: the share of the served ops' parameters (each op's own
  count) that differ from the reference's rounded as the system serves
  them, to 4 places;
- `px_off`: the mean over the requests of the share of the edited
  image's 8-bit values that differ from the reference's, which executes
  the served ops with its own parameters on the image edge-padded to its
  bucket, as the system executes it; `px_off_max` the largest share;
- `unserved_steps`: the share of the checked requests' decode steps
  that served no op (an empty program serves none, so a sample of empty
  programs, which would leave the decode and the chain unchecked, reads
  1; the serving mixes' `end_logit_bias` makes every program full);
- `missing`: requests whose answer never came or came as an error.

Which of them are compared, and against what limit, the cell's file says
(`benchmark/workloads/<cell>.json`); the others are printed as readings.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as RM
from benchmark.reference import ops as RO
from benchmark.reference.text import tokenize

OP_IDS = {name: i + 3 for i, name in enumerate(RM.OP_NAMES)}


def bucket(h: int, w: int, quantum: int, max_side: int):
    def up(x):
        return min(-(-x // quantum) * quantum, max_side)
    return up(h), up(w)


def served_op_ids(names, steps: int):
    """Op names up to <END> -> (steps,) vocab ids: the names, <END> if
    the program ended, then -1."""
    ids = [OP_IDS[n] for n in names]
    if len(ids) < steps:
        ids.append(RM.END_ID)
    return ids + [-1] * (steps - len(ids))


def reference_answers(P, cfg, op_cfg, vocab2id, texts, images_u8, engine,
                      device, served_ops=None, block: int = 8):
    """The reference's decode over `texts` and uint8 `images`: with
    served_ops (N, S) the teacher-forced gaps and parameters, else its
    own (ops, params), in blocks of the engine's micro-batch. Returns
    numpy arrays."""
    probe = engine["decode_size"]
    outs = []
    for s in range(0, len(texts), block):
        tok = torch.from_numpy(np.stack([
            tokenize(t, vocab2id, cfg["encoder_max_len"])
            for t in texts[s:s + block]])).to(device)
        views = torch.cat([
            F.interpolate(torch.from_numpy(im).to(device)[None].float()
                          / 255.0, size=(probe, probe), mode="bilinear",
                          align_corners=False, antialias=False)
            for im in images_u8[s:s + block]])
        forced = None if served_ops is None else torch.from_numpy(
            served_ops[s:s + block]).to(device)
        a, b = RM.decode(P, cfg, op_cfg, tok, views, served_ops=forced)
        outs.append((a.cpu().numpy(), b.cpu().numpy()))
    return (np.concatenate([o[0] for o in outs]),
            np.concatenate([o[1] for o in outs]))


def execute(images_u8, ops, params, engine, device, block: int = 32):
    """The reference's edited uint8 images: each image edge-padded to its
    bucket, the chain of `ops` (N, S) (identity from the first <END>)
    with `params` (N, S, 24), cropped, rounded to 8 bits."""
    out = [None] * len(images_u8)
    by_shape = {}
    for i, im in enumerate(images_u8):
        by_shape.setdefault(im.shape, []).append(i)
    for (_, h, w), idx in by_shape.items():
        hb, wb = bucket(h, w, engine["quantum"], engine["max_side"])
        for s in range(0, len(idx), block):
            sel = idx[s:s + block]
            x = torch.from_numpy(np.stack([images_u8[i] for i in sel])) \
                .to(device)
            x = F.pad(x.float(), (0, wb - w, 0, hb - h), mode="replicate")
            slots = RM.program_slots(torch.from_numpy(
                np.maximum(ops[sel], RM.END_ID)).to(device))
            y = RO.chain_forward(x / 255.0, slots,
                                 torch.from_numpy(params[sel]).to(device))
            y = torch.round(y[:, :, :h, :w] * 255.0).to(torch.uint8)
            for j, i in enumerate(sel):
                out[i] = y[j].cpu().numpy()
    return out


def judge(answers, texts, images_u8, P, cfg, op_cfg, vocab2id, engine,
          device, missing: int):
    """answers: [(op names, params [[24 floats]], uint8 image)] of the
    checked requests, in the order of `texts` and `images_u8`. Returns
    {number: value}."""
    steps = cfg["decoder_max_len"]
    ops = np.array([served_op_ids(a[0], steps) for a in answers], np.int64)
    gaps, ref_params = reference_answers(P, cfg, op_cfg, vocab2id, texts,
                                         images_u8, engine, device,
                                         served_ops=ops)
    param_gap, n_off, n_params = 0.0, 0, 0
    for i, (names, plist, _) in enumerate(answers):
        for s, name in enumerate(names):
            k = RO.PARAM_COUNTS[RM.OP_NAMES.index(name)]
            served = np.asarray(plist[s][:k], np.float64)
            ref = ref_params[i, s, :k].astype(np.float64)
            param_gap = max(param_gap, float(np.abs(served - ref).max()))
            n_off += int(np.sum(served != ref_params[i, s, :k].round(4)
                                .astype(np.float64)))
            n_params += k
    ref_imgs = execute(images_u8, ops, ref_params, engine, device)
    shares = [float(np.mean(r != a[2])) for r, a in zip(ref_imgs, answers)]
    served = sum(len(a[0]) for a in answers)
    return {"op_gap": float(gaps.max()) if len(gaps) else 0.0,
            "unserved_steps": 1.0 - served / max(len(answers) * steps, 1),
            "param_gap": param_gap,
            "param_off": n_off / max(n_params, 1),
            "px_off": float(np.mean(shares)) if shares else 0.0,
            "px_off_max": max(shares, default=0.0),
            "missing": float(missing)}


def control_answers(P, cfg, op_cfg, vocab2id, texts, images_u8, engine,
                    device):
    """The reference put in the system's place, at the precision it was
    set to: its own decode and execute, served as the system serves (op
    names up to <END>, parameters rounded to 4 places, uint8 image)."""
    ops, params = reference_answers(P, cfg, op_cfg, vocab2id, texts,
                                    images_u8, engine, device)
    imgs = execute(images_u8, ops, params, engine, device)
    return served_answers(ops, params, imgs)


def served_answers(ops, params, imgs):
    """(N, S) vocab ids, (N, S, 24) parameters and the uint8 images as the
    system serves them."""
    answers = []
    for i in range(len(imgs)):
        names, plist = [], []
        for s in range(ops.shape[1]):
            if ops[i, s] == RM.END_ID:
                break
            names.append(RM.OP_NAMES[ops[i, s] - 3])
            plist.append(params[i, s].round(4).tolist())
        answers.append((names, plist, imgs[i]))
    return answers
