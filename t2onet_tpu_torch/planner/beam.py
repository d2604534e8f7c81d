"""Beam-search operation planning, plain / eps-greedy / fixed-order
(counterpart of `t2onet_tpu.planner.beam`).

Each step fits every (beam x op x restart) candidate in one batched call
of `planner.fit` on the device; the host keeps the small bookkeeping over
at most `beam_size` sequences per pair (numpy, as the JAX package's).
Arrays come in and go out as numpy; `device` says where the fits run
(the card unless the caller asks for the CPU).

A trained inpaint filler (`beam_search(inpaint_fn=)`) evaluates the
inpaint candidate directly. A learned distance (`beam_search(score_fn=,
score_aux=)`, the 'seq2seqGAN-disc' planner) scores candidates in place
of the pixel distance. Not ported yet: sharded planning (`mesh`), which
waits for multi-GPU (ROADMAP A6) and raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops import operators as O
from t2onet_tpu_torch.planner import fit as Fit

OP_NAMES = list(O.OP_NAMES)


def _dev(a, device):
    """A numpy array as a tensor on `device` (a copy: cached dataset
    items are read-only)."""
    return torch.from_numpy(np.array(a)).to(device)


def _unported(mesh=None):
    if mesh is not None:
        raise NotImplementedError(
            "sharded planning (mesh) waits for the multi-GPU port "
            "(ROADMAP A6)")


def _fit_step(I_buff: np.ndarray, target, op_slots, n_starts, n_iters, lr,
              init_key, op_masks=None, dist_type="l1", device="cuda",
              score_fn=None, score_aux=None):
    """One fit of all (beam, op, start) candidates, by the pixel distance
    to `target` or, with `score_fn`, by the learned distance. Returns
    (params (N,C,24), dists (N,C), outs (N,C,3,H,W)) as numpy, and the
    candidate op index per column."""
    op_slots = tuple(int(op) for op in op_slots)
    cand_ops = Fit.candidate_op_slots(op_slots, n_starts)
    init = _dev(Fit.init_candidates(op_slots, n_starts, key=init_key),
                device)
    imgs = _dev(I_buff, device)
    masks = _op_mask_rows(op_masks, op_slots, I_buff.shape[-2:], device)
    if score_fn is not None:
        params, dists = Fit.fit_op_params_scored_sel(
            imgs, init, op_slots, n_starts, score_fn, score_aux,
            n_iters=n_iters, lr=lr, masks=masks)
    else:
        params, dists = Fit.fit_op_params_sel(
            imgs, _dev(target, device), init, op_slots, n_starts,
            n_iters=n_iters, lr=lr, masks=masks, dist=dist_type)
    outs = Fit.execute_candidates_sel(imgs, params, op_slots, n_starts,
                                      masks)
    return (params.cpu().numpy(), dists.cpu().numpy(), outs.cpu().numpy(),
            cand_ops)


def _op_mask_rows(op_masks, op_slots, hw, device):
    """op_masks ({op: (1,H,W)} dict or per-row list of dicts) -> per-op
    mask tensor in the fit's layout: (n_ops, 1, H, W) shared or
    (N, n_ops, 1, H, W) per row; None when no row has any local op.
    (len(), not truthiness: op index 0 is a valid dict key.)"""
    has_masks = (len(op_masks) > 0 if isinstance(op_masks, dict)
                 else any(len(d) > 0 for d in op_masks)) \
        if op_masks is not None else False
    if not has_masks:
        return None
    h, w = hw

    def rows(d):
        return np.stack([d.get(int(op), np.ones((1, h, w), np.float32))
                         for op in op_slots])

    if isinstance(op_masks, dict):              # shared across rows
        out = rows(op_masks)
    else:
        out = np.stack([rows(d) for d in op_masks])
    return _dev(out.astype(np.float32), device)


def normalize_dist_type(dist_type: str) -> str:
    """The reference's spellings ('L1'/'L2') -> 'l1'/'l2'."""
    d = dist_type.lower()
    if d not in ("l1", "l2"):
        raise ValueError(
            f"dist_type {dist_type!r} invalid — 'l1'/'l2' here; learned "
            "distances ('seq2seqGAN-disc') go through score_fn")
    return d


def beam_search(
    I_0: np.ndarray,
    I_gt: np.ndarray,
    beam_size: int = 3,
    operations: Sequence[int] = Fit.DEFAULT_PLAN_OPS,
    max_step: int = 6,
    err: float = 1e-2,
    mode: str = "plain",
    eps: float = 0.05,
    n_starts: int = 2,
    n_iters: int = 100,
    lr: float = 0.05,
    replace: bool = False,
    seed: int = 0,
    op_masks=None,
    dist_type: str = "l1",
    score_fn=None,
    score_aux=None,
    inpaint_fn=None,
    device="cuda",
) -> Tuple[List[List[Tuple[str, list, float]]], List[List[np.ndarray]]]:
    """Plan an operation sequence for one (input, target) pair.

    :param I_0, I_gt: (1, 3, H, W) float32 in [0,1].
    :param mode: 'plain', 'eps' (eps-greedy) or 'fixed' (operations[i]
        at step i, beam 1).
    :param op_masks: optional {executor_op_idx: (1, H, W) float mask} for
        local (masked) ops, the GIER planner's mask conditioning.
    :param dist_type: 'l1' or 'l2' pixel distance ('L1'/'L2' accepted).
    :param score_fn, score_aux: a learned candidate distance in place of
        the pixel distance, the 'seq2seqGAN-disc' planner (reference
        beam_search.py:226-236): `models.gan.make_disc_planner_score`,
        with score_aux (I_0, cond) as tensors on `device`. I_gt is then
        not read.
    :param inpaint_fn: a trained filler for the inpaint op, (B, 3, H, W)
        -> (B, 3, H, W) tensors on `device`, its hole mask captured
        (`models.inpaint.make_inpaint_fn`,
        `models.edgeconnect.make_edgeconnect_inpaint_fn`). The inpaint
        candidate has no parameters, so it is evaluated directly, not
        fitted; without a filler inpaint is the identity and plain mode
        never selects it.
    :return: (actions, images): actions[b] = [(op_name, params, dist),
        ...] per beam; images[b] = the per-step edited images (1,3,H,W).
    """
    if mode not in ("plain", "eps", "fixed"):
        raise ValueError(f"unknown beam-search mode {mode!r} "
                         "(want plain | eps | fixed)")
    rng = np.random.default_rng(seed)
    dist_type = normalize_dist_type(dist_type) if score_fn is None else "l1"
    if mode == "fixed":
        beam_size = 1
    # device-side top-k selection needs a pixel distance (the learned one
    # takes the all-candidates path) and no eps randomization (which
    # permutes over all candidates)
    fused = mode in ("plain", "fixed") and score_fn is None

    min_dist = float("inf")
    sequences: List[Tuple[list, float]] = [([], float("inf"))]
    I_buff = I_0.copy()                           # (n_beam, 3, H, W)
    INPAINT = OP_NAMES.index("inpaint")

    for step in range(max_step):
        if mode == "fixed":
            step_ops = [operations[step]] if step < len(operations) else []
        else:
            step_ops = list(operations)
        if not step_ops:
            break
        # the parameterless inpaint candidate: the filler's output as it is
        inp_outs = inp_dists = None
        if inpaint_fn is not None and INPAINT in step_ops:
            with torch.no_grad():
                filled = inpaint_fn(_dev(I_buff, device))
                if score_fn is not None:
                    inp_dists = score_fn(filled[:, None],
                                         score_aux)[:, 0].cpu().numpy()
            inp_outs = filled.cpu().numpy()
            if score_fn is None and dist_type == "l2":
                inp_dists = ((inp_outs - I_gt) ** 2).mean(axis=(1, 2, 3))
            elif score_fn is None:
                inp_dists = np.abs(inp_outs - I_gt).mean(axis=(1, 2, 3))
        fit_ops = [op for op in step_ops
                   if not (op == INPAINT and inp_outs is not None)]

        n_beam = len(sequences)
        used_by_beam = [set() if replace else
                        {OP_NAMES.index(a[0]) for a in sequences[j][0]}
                        for j in range(n_beam)]

        all_candidates, I_tmp = [], []
        no_update, finish = True, False
        tmp_min = []

        def consider(j, op, dist, p_list, out_img):
            nonlocal no_update, finish
            accept = (dist < min_dist) if mode == "plain" else True
            if accept:
                tmp_min.append(dist)
                seq = sequences[j][0] + [(OP_NAMES[op], p_list, dist)]
                all_candidates.append((seq, dist))
                I_tmp.append(out_img)
                no_update = False
                if dist < err:
                    finish = True

        if fused and fit_ops:
            fos = tuple(int(op) for op in fit_ops)
            allow = np.zeros((1, n_beam, len(fos)), bool)
            for j in range(n_beam):
                for i, op in enumerate(fos):
                    allow[0, j, i] = op not in used_by_beam[j]
            masks = _op_mask_rows(op_masks, fos, I_buff.shape[-2:], device)
            thr = min_dist if mode == "plain" else float("inf")
            k = min(beam_size, n_beam * len(fos))
            sel_imgs, sel_d, sel_params, sel_beam, sel_pos = \
                Fit.fit_select_step(
                    _dev(I_buff, device)[None], _dev(I_gt, device),
                    _dev(Fit.init_candidates(fos, n_starts, key=seed + step),
                         device),
                    _dev(allow, device),
                    torch.tensor([thr], dtype=torch.float32, device=device),
                    fos, n_starts, k, n_iters=n_iters, lr=lr,
                    dist=dist_type,
                    masks=None if masks is None else masks[None])
            sel_imgs = sel_imgs[0].cpu().numpy()
            sel_d = sel_d[0].cpu().numpy()
            sel_params = sel_params[0].cpu().numpy()
            sel_beam = sel_beam[0].cpu().numpy()
            sel_pos = sel_pos[0].cpu().numpy()
            for r in range(k):
                if not np.isfinite(sel_d[r]):
                    break
                op = fos[int(sel_pos[r])]
                consider(int(sel_beam[r]), op, float(sel_d[r]),
                         sel_params[r, : O.PARAM_COUNTS[op]].tolist(),
                         sel_imgs[r])
            if inp_outs is not None:
                for j in range(n_beam):
                    if INPAINT not in used_by_beam[j]:
                        consider(j, INPAINT, float(inp_dists[j]),
                                 [0.0] * O.PARAM_COUNTS[INPAINT],
                                 inp_outs[j])
        else:
            if fit_ops:
                params, dists, outs, cand_ops = _fit_step(
                    I_buff, I_gt, fit_ops, n_starts, n_iters, lr,
                    init_key=seed + step, op_masks=op_masks,
                    dist_type=dist_type, device=device, score_fn=score_fn,
                    score_aux=score_aux)
            else:                                 # inpaint-only search
                cand_ops = np.empty(0, np.int64)
            for j in range(n_beam):
                for op in step_ops:
                    if op in used_by_beam[j]:
                        continue
                    if op == INPAINT and inp_outs is not None:
                        consider(j, op, float(inp_dists[j]),
                                 [0.0] * O.PARAM_COUNTS[op], inp_outs[j])
                        continue
                    cols = np.where(cand_ops == op)[0]
                    best = cols[int(np.argmin(dists[j, cols]))]
                    consider(j, op, float(dists[j, best]),
                             params[j, best, :O.PARAM_COUNTS[op]].tolist(),
                             outs[j, best])
        if tmp_min:
            min_dist = min(min_dist, min(tmp_min))

        if len(all_candidates) < beam_size:
            all_candidates += sequences
            I_tmp += list(I_buff)
        order = np.argsort([c[1] for c in all_candidates], kind="stable")
        if mode == "eps" and rng.random() < eps:
            order = rng.permutation(len(all_candidates))
        keep = order[:beam_size]
        sequences = [all_candidates[i] for i in keep]
        I_buff = np.stack([I_tmp[i] for i in keep])
        if no_update or finish:
            break

    actions = [list(seq) for seq, _ in sequences]
    images = _replay_images(I_0, actions, op_masks, inpaint_fn, device)
    return actions, images


def _replay_images(I_0, actions, op_masks=None, inpaint_fn=None,
                   device="cuda"):
    """Recompute each surviving beam's per-step images: every beam in one
    batched replay without a filler; with one, op by op through
    `apply_op_by_index` (the filler runs outside the bank)."""
    if inpaint_fn is None:
        return _replay_images_batch(
            np.asarray(I_0), [actions],
            None if op_masks is None else [op_masks], device=device)[0]
    images = []
    with torch.no_grad():
        for seq in actions:
            imgs = []
            cur = _dev(I_0, device)
            for (name, p_list, _d) in seq:
                op = OP_NAMES.index(name)
                p = torch.tensor([p_list], dtype=torch.float32,
                                 device=device).reshape(1, -1)
                mask = None
                if op_masks and op in op_masks:
                    mask = _dev(op_masks[op], device)[None]
                cur = O.apply_op_by_index(cur, op, p, mask=mask,
                                          inpaint_fn=inpaint_fn)
                imgs.append(cur.cpu().numpy())
            images.append(imgs)
    return images


@torch.no_grad()
def _replay_scan(imgs0, slots, params, masks_all, uint8_wire=False):
    """Replay padded op sequences on a batch of rows, one bank execute
    per step.

    imgs0 (N, 3, H, W); slots (N, S) bank slot ids (0 = identity
    padding); params (N, S, 24); masks_all optional (N, N_OPS+1, 1, H, W)
    per-slot edit masks (slot 0 unused). Returns (S, N, 3, H, W).

    uint8_wire quantizes each step's output (not the carried state) as
    `save_img` does, floor(clip(out, 0, 1)·255), so the JPEG bytes are
    unchanged and the readback is 4x smaller."""
    img = imgs0
    ys = []
    for s in range(slots.shape[1]):
        slot = slots[:, s]
        onehot = F.one_hot(slot, bank.N_OPS + 1).to(img.dtype)
        m = None
        if masks_all is not None:
            m = masks_all[torch.arange(slot.shape[0], device=slot.device),
                          slot]
        img = bank.execute_onehot(img, onehot, params[:, s], mask=m)
        ys.append((img.clamp(0, 1) * 255).to(torch.uint8) if uint8_wire
                  else img)
    return torch.stack(ys)


def _replay_images_batch(I_0s, actions_list, op_masks=None,
                         max_beams=None, uint8_wire=False, device="cuda"):
    """Replay every pair's surviving beams in one batched loop and one
    device->host copy.

    :param I_0s: (P, 3, H, W).
    :param actions_list: per pair, a list of beam action sequences.
    :param op_masks: None | per-pair list of {executor_op: (1, H, W)}.
    :param max_beams: replay only the first `max_beams` beams per pair
        (dataset planning writes just the top beam's edit images); the
        other beams get empty image lists.
    :param uint8_wire: quantize step images to uint8 on the device (see
        _replay_scan) and return float arrays u/255 (the same JPEGs).
    :return: per pair: images[b] = [per-step (1, 3, H, W) numpy arrays].
    """
    rows = []                                 # (pair_idx, seq)
    for pi, beams in enumerate(actions_list):
        for seq in beams[:max_beams]:
            rows.append((pi, seq))
    s_max = max((len(seq) for _, seq in rows), default=0)
    if s_max == 0:
        return [[[] for _ in beams] for beams in actions_list]
    n = len(rows)
    h, w = I_0s.shape[-2:]
    slots = np.zeros((n, s_max), np.int64)
    params = np.zeros((n, s_max, bank.MAX_PARAM), np.float32)
    imgs0 = np.zeros((n, 3, h, w), np.float32)
    for i, (pi, seq) in enumerate(rows):
        imgs0[i] = I_0s[pi]
        for s, (name, p_list, _d) in enumerate(seq):
            slots[i, s] = OP_NAMES.index(name) + 1
            params[i, s, : len(p_list)] = p_list
    masks_all = None
    if op_masks is not None and any(len(d) > 0 for d in op_masks):
        masks_all = np.ones((n, bank.N_OPS + 1, 1, h, w), np.float32)
        for i, (pi, _seq) in enumerate(rows):
            for op, m in op_masks[pi].items():
                masks_all[i, int(op) + 1] = m
        masks_all = _dev(masks_all, device)
    ys = _replay_scan(_dev(imgs0, device), _dev(slots, device),
                      _dev(params, device), masks_all,
                      uint8_wire=uint8_wire).cpu().numpy()
    if uint8_wire:
        ys = ys.astype(np.float32) / 255.0
    out = [[] for _ in actions_list]
    for i, (pi, seq) in enumerate(rows):
        out[pi].append([ys[s, i][None] for s in range(len(seq))])
    for pi, beams in enumerate(actions_list):     # beams beyond max_beams
        while len(out[pi]) < len(beams):
            out[pi].append([])
    return out


def init_distance(I_0, I_gt) -> float:
    """The L1 'init distance' recorded in the planner's JSONs."""
    return float(np.abs(np.asarray(I_0) - np.asarray(I_gt)).mean())


def batch_beam_search(
    I_0s: np.ndarray,
    I_gts: np.ndarray,
    beam_size: int = 3,
    operations: Sequence[int] = Fit.DEFAULT_PLAN_OPS,
    max_step: int = 6,
    err: float = 1e-2,
    mode: str = "plain",
    eps: float = 0.05,
    n_starts: int = 2,
    n_iters: int = 100,
    lr: float = 0.05,
    replace: bool = False,
    seed: int = 0,
    dist_type: str = "l1",
    mesh=None,
    op_masks=None,
    replay_beams=None,
    replay_uint8: bool = False,
    device="cuda",
):
    """Plan many pairs in lockstep: one fit per step covers every
    (pair x beam x op x restart) candidate.

    :param I_0s, I_gts: (P, 3, H, W).
    :param op_masks: optional per-pair mask conditioning, a list of P
        dicts {executor_op_idx: (1, H, W) float mask}.
    :param replay_beams: replay step images for only the first N beams
        per pair; the rest return empty image lists.
    :param replay_uint8: the uint8 image wire for the replay's readback
        (the same JPEGs, 4x fewer bytes).
    :return: list of per-pair (actions, images) like beam_search's.
    """
    _unported(mesh=mesh)
    if mode not in ("plain", "eps", "fixed"):
        raise ValueError(f"unknown beam-search mode {mode!r} "
                         "(want plain | eps | fixed)")
    dist_type = normalize_dist_type(dist_type)
    if mode == "fixed":
        beam_size = 1
    if mode in ("plain", "fixed"):
        return _batch_beam_search_fused(
            I_0s, I_gts, beam_size, operations, max_step, err, mode,
            n_starts, n_iters, lr, replace, seed, dist_type, op_masks,
            replay_beams, replay_uint8, device)
    rng = np.random.default_rng(seed)
    p = I_0s.shape[0]
    # per-pair host state
    states = [{
        "min_dist": float("inf"),
        "sequences": [([], float("inf"))],
        "done": False,
    } for _ in range(p)]
    I_buff = I_0s[:, None].copy()                 # (P, n_beam, 3, H, W)

    for step in range(max_step):
        step_ops = list(operations)
        if not step_ops or all(s["done"] for s in states):
            break
        n_beam = I_buff.shape[1]
        flat = I_buff.reshape(p * n_beam, *I_buff.shape[2:])
        tgt = np.repeat(I_gts, n_beam, axis=0)
        row_masks = None
        if op_masks is not None:
            row_masks = [op_masks[pi] for pi in range(p)
                         for _ in range(n_beam)]
        params, dists, outs, cand_ops = _fit_step(
            flat, tgt, step_ops, n_starts, n_iters, lr,
            init_key=seed + step, dist_type=dist_type, op_masks=row_masks,
            device=device)
        params = params.reshape(p, n_beam, *params.shape[1:])
        dists = dists.reshape(p, n_beam, -1)
        outs = outs.reshape(p, n_beam, *outs.shape[1:])

        next_buff = []
        for pi, st in enumerate(states):
            if st["done"]:
                next_buff.append(_pad_beams(I_buff[pi], beam_size))
                continue
            all_candidates, I_tmp = [], []
            no_update, finish = True, False
            tmp_min = []
            for j in range(len(st["sequences"])):
                used = ([] if replace else
                        [OP_NAMES.index(a[0])
                         for a in st["sequences"][j][0]])
                for op in step_ops:
                    if op in used:
                        continue
                    cols = np.where(cand_ops == op)[0]
                    best = cols[int(np.argmin(dists[pi, j, cols]))]
                    dist = float(dists[pi, j, best])
                    k = O.PARAM_COUNTS[op]
                    accept = ((dist < st["min_dist"])
                              if mode == "plain" else True)
                    if accept:
                        tmp_min.append(dist)
                        seq = st["sequences"][j][0] + [
                            (OP_NAMES[op],
                             params[pi, j, best, :k].tolist(), dist)]
                        all_candidates.append((seq, dist))
                        I_tmp.append(outs[pi, j, best])
                        no_update = False
                        if dist < err:
                            finish = True
            if tmp_min:
                st["min_dist"] = min(st["min_dist"], min(tmp_min))
            if len(all_candidates) < beam_size:
                all_candidates += st["sequences"]
                I_tmp += list(I_buff[pi, : len(st["sequences"])])
            order = np.argsort([c[1] for c in all_candidates], kind="stable")
            if rng.random() < eps:
                order = rng.permutation(len(all_candidates))
            keep = order[:beam_size]
            st["sequences"] = [all_candidates[i] for i in keep]
            buf = np.stack([I_tmp[i] for i in keep])
            next_buff.append(_pad_beams(buf, beam_size))
            if no_update or finish:
                st["done"] = True
        I_buff = np.stack(next_buff)

    actions_list = [[list(seq) for seq, _ in st["sequences"]]
                    for st in states]
    reps = _replay_images_batch(I_0s, actions_list, op_masks,
                                max_beams=replay_beams,
                                uint8_wire=replay_uint8, device=device)
    return list(zip(actions_list, reps))


def _batch_beam_search_fused(I_0s, I_gts, beam_size, operations, max_step,
                             err, mode, n_starts, n_iters, lr, replace,
                             seed, dist_type, op_masks=None,
                             replay_beams=None, replay_uint8=False,
                             device="cuda"):
    """Lockstep planning with the beam images on the device (plain and
    fixed modes).

    Each step is one `fit_select_update` call: fit all (pair x beam x op
    x restart) candidates, select the top k per pair, and compose the
    next beam buffer, all on the device. Per step only (dists, params,
    indices) come back to the host, whose bookkeeping mirrors the
    device's composition rule (see fit_select_update)."""
    p = I_0s.shape[0]
    states = [{
        "min_dist": float("inf"),
        "sequences": [([], float("inf"))],
        "done": False,
    } for _ in range(p)]

    imgs = _dev(I_0s, device)[:, None]
    tgts = _dev(I_gts, device)
    mask_cache = {}

    def masks_for(fos):
        if op_masks is None:
            return None
        if fos not in mask_cache:
            mask_cache[fos] = _op_mask_rows(list(op_masks), fos,
                                            I_0s.shape[-2:], device)
        return mask_cache[fos]

    for step in range(max_step):
        if mode == "fixed":
            step_ops = [operations[step]] if step < len(operations) else []
        else:
            step_ops = list(operations)
        if not step_ops or all(s["done"] for s in states):
            break
        fos = tuple(int(op) for op in step_ops)
        n_ops = len(fos)
        n_beam = imgs.shape[1]
        allow = np.zeros((p, n_beam, n_ops), bool)
        thr = np.full((p,), np.inf, np.float32)
        for pi, st in enumerate(states):
            if st["done"]:
                continue
            if mode == "plain":
                thr[pi] = st["min_dist"]
            for j in range(len(st["sequences"])):
                used = (set() if replace else
                        {OP_NAMES.index(a[0])
                         for a in st["sequences"][j][0]})
                for i, op in enumerate(fos):
                    allow[pi, j, i] = op not in used
        init = _dev(Fit.init_candidates(fos, n_starts, key=seed + step),
                    device)
        imgs, sel_d, sel_params, sel_beam, sel_pos = Fit.fit_select_update(
            imgs, tgts, init, _dev(allow, device), _dev(thr, device), fos,
            n_starts, beam_size,
            n_iters=n_iters, lr=lr, dist=dist_type, masks=masks_for(fos))
        sel_d = sel_d.cpu().numpy()
        sel_params = sel_params.cpu().numpy()
        sel_beam = sel_beam.cpu().numpy()
        sel_pos = sel_pos.cpu().numpy()

        for pi, st in enumerate(states):
            if st["done"]:
                continue
            cands = []
            finish = False
            for r in range(sel_d.shape[1]):
                dist = float(sel_d[pi, r])
                if not np.isfinite(dist):
                    break
                op = fos[int(sel_pos[pi, r])]
                j = int(sel_beam[pi, r])
                k = O.PARAM_COUNTS[op]
                seq = st["sequences"][j][0] + [
                    (OP_NAMES[op], sel_params[pi, r, :k].tolist(), dist)]
                cands.append((seq, dist))
                if dist < err:
                    finish = True
            if cands:
                st["min_dist"] = min(st["min_dist"], cands[0][1])
            # accepted (ascending) first, then the previous sequences: the
            # merge fit_select_update applied to the image buffer
            st["sequences"] = (cands + st["sequences"])[:beam_size]
            if not cands or finish:
                st["done"] = True

    actions_list = [[list(seq) for seq, _ in st["sequences"]]
                    for st in states]
    reps = _replay_images_batch(I_0s, actions_list, op_masks,
                                max_beams=replay_beams,
                                uint8_wire=replay_uint8, device=device)
    return list(zip(actions_list, reps))


def _pad_beams(buf: np.ndarray, beam_size: int) -> np.ndarray:
    """Pad or trim the beam axis to a fixed size (repeat the last row)."""
    if buf.shape[0] == beam_size:
        return buf
    if buf.shape[0] > beam_size:
        return buf[:beam_size]
    reps = np.repeat(buf[-1:], beam_size - buf.shape[0], axis=0)
    return np.concatenate([buf, reps], axis=0)
