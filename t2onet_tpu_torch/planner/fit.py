"""Batched operator-parameter fitting (counterpart of
`t2onet_tpu.planner.fit`, its selected-branch path).

One Adam optimisation fits every (image, candidate op, restart) triple at
once:

    params: (N, C, 24)   N images x C candidates, each a padded param row
    loss:   sum over (n, c) of mean|apply(img_n, op_c, p_nc) - target_n|

Candidates do not interact, so one optimiser over the whole tensor is C*N
independent optimisers. Column block i of the C columns runs only
op_slots[i]'s pixel math. Plain autograd, as the JAX planner is plain
jnp: no kernel runs here.

The learned-distance fits (`fit_op_params_scored*`) wait for the GAN
port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops import operators as O
from t2onet_tpu_torch.ops.color import abs_, clip

# ops the FiveK planner searches over (executor indices; not inpaint=4
# nor white=7)
DEFAULT_PLAN_OPS = (0, 1, 2, 3, 5, 6)

# per-op param init: zeros for the scalar ops, ones for the curves
_ONES_INIT_OPS = (3, 5)


def init_candidates(op_slots: Sequence[int], n_starts: int,
                    key=None) -> np.ndarray:
    """(C, 24) initial params for C = len(op_slots)*n_starts candidates.

    Start 0 is the reference init; extra starts jitter it with draws from
    numpy's default_rng(key), so the rows equal the JAX package's bit for
    bit."""
    inits = []
    rng = np.random.default_rng(0 if key is None else key)
    for op in list(op_slots):
        base = np.zeros(bank.MAX_PARAM, np.float32)
        if op in _ONES_INIT_OPS:
            base[: O.PARAM_COUNTS[op]] = 1.0
        for s in range(n_starts):
            row = base.copy()
            if s > 0:
                k = O.PARAM_COUNTS[op]
                row[:k] += rng.normal(0.0, 0.3, size=k).astype(np.float32)
            inits.append(row)
    return np.stack(inits)                     # (C, 24)


def candidate_op_slots(op_slots: Sequence[int], n_starts: int) -> np.ndarray:
    return np.repeat(np.asarray(op_slots, np.int32), n_starts)


def _apply_selected(imgs, params, op_slots, n_starts, masks=None):
    """Column block i runs only op_slots[i]'s op: the bank's math on an
    exact one-hot row (the ±1e4 finite guard, the mask blend, the clamp).

    :param imgs: (N, 3, H, W).
    :param params: (N, C, 24), C = len(op_slots) * n_starts; columns
        [i*n_starts, (i+1)*n_starts) belong to op_slots[i].
    :param masks: per-op edit masks, (n_ops, 1, H, W) shared across rows
        or (N, n_ops, 1, H, W) per row; None for global edits.
    :return: (N, C, 3, H, W).
    """
    n, _, h, w = imgs.shape
    s = n_starts
    x = imgs[:, None].expand(n, s, 3, h, w).reshape(n * s, 3, h, w)
    outs = []
    for i, op in enumerate(op_slots):
        p = params[:, i * s:(i + 1) * s].reshape(n * s, bank.MAX_PARAM)
        name = O.OP_NAMES[op]
        if name == "tone":
            y = O.tone_curve(x, p[:, :8])
        elif name == "inpaint":
            y = x                       # parameterless without a filler
        else:
            y = O._OP_FNS[name](x, p)
        y = clip(y, -1e4, 1e4)          # the bank's finite guard
        m = None
        if masks is not None:
            if masks.ndim == 4:         # (n_ops, 1, H, W) shared
                m = masks[i][None].expand(n * s, 1, h, w)
            else:                       # (N, n_ops, 1, H, W) per row
                m = masks[:, i][:, None].expand(n, s, 1, h, w).reshape(
                    n * s, 1, h, w)
        outs.append(O.mask_blend(y, x, m).reshape(n, s, 3, h, w))
    return torch.cat(outs, dim=1)


def _sel_dist_fn(imgs, targets_b, op_slots, n_starts, masks, dist):
    def per_candidate_dist(params):
        out = _apply_selected(imgs, params, op_slots, n_starts, masks)
        diff = out - targets_b[:, None]
        if dist == "l2":
            return (diff * diff).mean(dim=(2, 3, 4))
        return abs_(diff).mean(dim=(2, 3, 4))
    return per_candidate_dist


B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam's defaults


def _adam_fit(per_candidate_dist, init_params, n_iters: int, lr: float):
    """The multi-start Adam loop: `n_iters` Adam steps on the sum of the
    independent per-candidate distances. Returns (final params, final
    dists), detached.

    The step is optax.adam(lr)'s, in its f32 arithmetic:
    mu_hat / (sqrt(nu_hat) + eps) with the bias corrections 1 - b**t
    computed in f32. torch.optim.Adam computes them in f64 on the host,
    which moves the very first step by 6.4e-6 of itself (b2 = 0.999 is
    0.99900001 in f32), and an L1 fit's kinks grow that into distance
    gaps above 1e-5 within 20 iterations."""
    params = init_params.detach().clone()
    mu = torch.zeros_like(params)
    nu = torch.zeros_like(params)
    b1 = params.new_tensor(B1)
    b2 = params.new_tensor(B2)
    for t in range(1, n_iters + 1):
        p = params.requires_grad_(True)
        loss = per_candidate_dist(p).sum()
        if not loss.requires_grad:
            break     # only parameterless ops: every update would be 0
        (g,) = torch.autograd.grad(loss, p)
        with torch.no_grad():
            mu = (1 - B1) * g + B1 * mu
            nu = (1 - B2) * (g * g) + B2 * nu
            mu_hat = mu / (1 - b1 ** t)
            nu_hat = nu / (1 - b2 ** t)
            params = p.detach() + mu_hat / (nu_hat.sqrt() + EPS) * -lr
    params = params.detach()
    with torch.no_grad():
        return params, per_candidate_dist(params)


def _broadcast_init(init_params, n, c):
    if init_params.ndim == 2:
        return init_params[None].expand(n, c, bank.MAX_PARAM)
    return init_params


def fit_op_params_sel(imgs, targets, init_params, op_slots, n_starts,
                      n_iters: int = 100, lr: float = 0.05,
                      masks=None, dist: str = "l1"):
    """Fit every (image, candidate) pair at once.

    :param imgs: (N, 3, H, W) current beam images.
    :param targets: (N, 3, H, W), or (1, 3, H, W) broadcast.
    :param init_params: (N, C, 24) or (C, 24).
    :param dist: 'l1' (mean abs) or 'l2' (mean squared).
    :return: (params (N, C, 24), dists (N, C)): the final params and the
        distance of the final edit.
    """
    n = imgs.shape[0]
    c = len(op_slots) * n_starts
    init = _broadcast_init(init_params, n, c)
    targets_b = targets.expand_as(imgs)
    fn = _sel_dist_fn(imgs, targets_b, tuple(op_slots), n_starts, masks,
                      dist)
    return _adam_fit(fn, init, n_iters, lr)


@torch.no_grad()
def execute_candidates_sel(imgs, params, op_slots, n_starts, masks=None):
    """The candidates' edited images, (N, C, 3, H, W) (masks in the
    per-op layout)."""
    return _apply_selected(imgs, params, tuple(op_slots), n_starts, masks)


def fit_select_step(imgs, targets, init_params, allow, min_dists,
                    op_slots, n_starts, beam_size, n_iters: int = 100,
                    lr: float = 0.05, dist: str = "l1", masks=None):
    """One beam-search step: the fit, then per pair the `beam_size`
    best candidates, and only those survivors executed.

    The candidates are ordered row-major over (beam, op), and ties go to
    the lower index, as `jax.lax.top_k` breaks them: a stable ascending
    sort of the distances, of which the first kk are taken (`torch.topk`
    promises no order among ties on CUDA). The best restart of each
    (pair, beam, op) is the first minimum, as `jnp.argmin` takes it.

    :param imgs: (P, B, 3, H, W) current beam images per pair.
    :param targets: (P, 3, H, W).
    :param init_params: (C, 24) shared inits, or (P*B, C, 24).
    :param allow: (P, B, n_ops) bool: the candidate is permitted (op
        unused in that beam's sequence, beam row real, pair not done).
    :param min_dists: (P,) accept thresholds (plain mode's monotone
        improvement filter; +inf accepts all, the fixed-order mode).
    :param masks: (P, n_ops, 1, H, W) per-pair per-op edit masks or None.
    :return: (sel_imgs (P,K,3,H,W), sel_dists (P,K), sel_params (P,K,24),
        sel_beam (P,K) int64, sel_op_pos (P,K) int64), ascending by dist;
        rejected slots hold +inf dists.
    """
    p, b = imgs.shape[:2]
    n_ops = len(op_slots)
    c = n_ops * n_starts
    h, w = imgs.shape[-2:]
    flat = imgs.reshape(p * b, 3, h, w)
    tgt = targets.repeat_interleave(b, dim=0)
    row_masks = None
    if masks is not None:
        row_masks = masks.repeat_interleave(b, dim=0)  # (P*B, n_ops, 1,H,W)
    init = _broadcast_init(init_params, p * b, c)
    fn = _sel_dist_fn(flat, tgt, tuple(op_slots), n_starts, row_masks, dist)
    params, dists = _adam_fit(fn, init, n_iters, lr)

    with torch.no_grad():
        # best restart per (pair, beam, op): the first minimum
        d4 = dists.reshape(p, b, n_ops, n_starts)
        best_s = torch.argmin(d4, dim=-1)                 # (P, B, n_ops)
        d_best = torch.amin(d4, dim=-1)
        p5 = params.reshape(p, b, n_ops, n_starts, bank.MAX_PARAM)
        p_best = torch.take_along_dim(
            p5, best_s[..., None, None], dim=3)[:, :, :, 0]  # (P,B,n_ops,24)

        kk = min(beam_size, b * n_ops)  # no wider than the candidates
        ok = allow & (d_best < min_dists[:, None, None])
        inf = torch.full_like(d_best, float("inf"))
        flatd = torch.where(ok, d_best, inf).reshape(p, b * n_ops)
        sorted_d, order = torch.sort(flatd, dim=1, stable=True)
        sel_d, top_idx = sorted_d[:, :kk], order[:, :kk]
        sel_beam = torch.div(top_idx, n_ops, rounding_mode="floor")
        sel_pos = top_idx % n_ops
        sel_params = torch.take_along_dim(
            p_best.reshape(p, b * n_ops, bank.MAX_PARAM),
            top_idx[..., None], dim=1)                    # (P, K, 24)

        # execute only the survivors, each through its op's one-hot row
        src = torch.take_along_dim(
            imgs, sel_beam[..., None, None, None], dim=1)  # (P,K,3,H,W)
        slots = torch.as_tensor(op_slots, dtype=torch.int64,
                                device=imgs.device)
        onehot = F.one_hot(slots[sel_pos] + 1, bank.N_OPS + 1).to(
            imgs.dtype).reshape(p * kk, -1)
        m_f = None
        if masks is not None:
            m_f = torch.take_along_dim(
                masks, sel_pos[..., None, None, None], dim=1).reshape(
                p * kk, 1, h, w)
        out = bank.execute_onehot(src.reshape(p * kk, 3, h, w), onehot,
                                  sel_params.reshape(-1, bank.MAX_PARAM),
                                  mask=m_f)
    return (out.reshape(p, kk, 3, h, w), sel_d, sel_params, sel_beam,
            sel_pos)


def fit_select_update(imgs, targets, init_params, allow, min_dists,
                      op_slots, n_starts, beam_size,
                      n_iters: int = 100, lr: float = 0.05,
                      dist: str = "l1", masks=None):
    """`fit_select_step`, then the next beam buffer composed on the
    device by the host's merge rule: accepted candidates (ascending) fill
    rows first, then the previous beam rows in order, the last previous
    row repeating as padding (`beam._pad_beams`). In plain mode every
    accepted candidate's dist is below min_dist, which is at most every
    previous sequence's dist, so "accepted, then previous" is the
    ascending merge order.

    :return: (new_buff (P, beam_size, 3, H, W) on the device, sel_dists,
        sel_params, sel_beam, sel_op_pos).
    """
    b = imgs.shape[1]
    sel_out, sel_d, sel_params, sel_beam, sel_pos = fit_select_step(
        imgs, targets, init_params, allow, min_dists, op_slots, n_starts,
        beam_size, n_iters, lr, dist, masks)
    kk = sel_out.shape[1]                             # = min(K, B*n_ops)
    n_acc = torch.isfinite(sel_d).sum(dim=1)          # (P,)
    r = torch.arange(beam_size, device=imgs.device)[None]   # (1, K)
    prev_idx = (r - n_acc[:, None]).clamp(0, b - 1)
    idx = torch.where(r < n_acc[:, None], r, kk + prev_idx)
    cat = torch.cat([sel_out, imgs], dim=1)           # (P, kk+B, 3, H, W)
    new_buff = torch.take_along_dim(cat, idx[..., None, None, None], dim=1)
    return new_buff, sel_d, sel_params, sel_beam, sel_pos
