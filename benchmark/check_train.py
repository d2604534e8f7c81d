"""The comparison that decides `correct` in a training cell.

The reference (`reference.model`: the same weights from the seed, the
same host batches, the same Gumbel draws, its own Adam) follows the
system's first three steps: supervised, the sampled episode (with masks
in GIER: B2 forward, B4 backward), supervised. The numbers:

- `loss_gap`, `loss_gap.2`: the relative distance between the first
  (supervised) and the second (episode) step's loss and the
  reference's. The third step's (`loss_gap.3`) is a reading only: the
  episode's gradient moves weights whose gradient is rounding noise by up
  to the learning rate on either side (Adam's step is the sign where
  the gradient is far above its epsilon), which can turn a near-tie of
  the third step's Gumbel draws and with it a sample's rollout;
- `grad_gap`: over the leaves, the largest distance between the norm of
  the first gradient as the system's Adam holds it (its first moment
  after one step over 1 - beta1) and the reference's, over the larger of
  the reference leaf's norm and the median leaf's;
- `grad_gap_median.2`: the same distance for the second (episode)
  gradient (Adam's first moment after two steps less 0.9 times the
  first, over 1 - beta1), its median over the leaves. The largest
  (`grad_gap.2`) is a reading: the episode's backward through the
  rollout amplifies float32 rounding in a few leaves, so that float32
  runs of the reference itself lie up to 3e-3 from its float64 gradient
  there (PERF.md);
- `change_gap`: the same as `grad_gap` for each leaf's change over the
  three steps, over the leaves whose reference gradient in some step
  reaches a thousandth of that step's median leaf: a leaf below that (a
  bias under a normalisation) moves under Adam by its rounding noise
  alone;
- `pool_off` (set by the driver): values of a sample of the host pool
  that differ from the benchmark's own decode (`pool_check`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as RM

SMALL_GRAD = 1e-3             # of the median leaf: rounding noise alone


def _on_device(batch, device, rows=None):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(
            v if rows is None else v[rows])).to(device)
        out[k] = t.float() / 255.0 if v.dtype == np.uint8 else t
    return out


def reference_readings(ctx, W, kept, gumbel, device, precision: str,
                       rows=None):
    """The reference's readings over the kept steps [(supervised?, host
    batch)]: losses, the first step's gradient norms, each step's
    gradient norms, the change norms after the last. `rows` keeps only
    those rows of every batch (a planted fault)."""
    model, op_cfg = ctx.model_config(), ctx.op_config()
    RM.set_precision(precision, device)
    names = RM.trainable_names(RM.param_specs(model, len(ctx.vocab())))
    P = {n: t.detach().clone() for n, t in W.items()}
    adam = {}
    losses, grads = [], []
    for step, (sup, host) in enumerate(kept, 1):
        batch = _on_device(host, device, rows)
        for n in names:
            P[n].requires_grad_(True)
        if sup:
            loss = RM.supervised_loss(P, model, op_cfg, batch)
        else:
            loss = RM.episode_loss(
                P, model, op_cfg, batch,
                lambda k, shape, s=step: gumbel(s, k, shape),
                ctx.config["explore_prob"])
        got = torch.autograd.grad(loss, [P[n] for n in names],
                                  allow_unused=True)
        g = {n: (x if x is not None else torch.zeros_like(P[n]))
             for n, x in zip(names, got)}
        for n in names:
            P[n] = P[n].detach()
        RM.adam_step(P, names, g, adam, lr=ctx.traffic["learning_rate"])
        losses.append(float(loss.detach()))
        grads.append({n: float(v.norm()) for n, v in g.items()})
        del batch, loss, got, g
    RM.set_precision("f32", device)
    change = {n: float((P[n] - W[n]).norm()) for n in names}
    return {"losses": losses, "grad_norms": grads[0],
            "grad_norms_2": grads[1] if len(grads) > 1 else {},
            "step_grads": grads, "change_norms": change}


def _leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's |prog norm - ref norm| over the larger of the ref
    leaf's norm and the median leaf's."""
    med = float(np.median([ref[n] for n in names])) if names else 0.0
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names
            if max(ref[n], med) > 0]


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    return max(_leaf_gaps(prog, ref, names), default=0.0)


def _median_leaf(prog: dict, ref: dict, names) -> float:
    gaps = _leaf_gaps(prog, ref, names)
    return float(np.median(gaps)) if gaps else 0.0


def counted_leaves(ref: dict):
    """The leaves whose reference gradient reaches SMALL_GRAD of the
    median leaf's in some step."""
    keep = set()
    for grads in ref["step_grads"]:
        med = float(np.median(list(grads.values())))
        keep |= {n for n, v in grads.items() if v >= SMALL_GRAD * med}
    return sorted(keep)


def judge(prog: dict, ref: dict) -> dict:
    """prog: the system's "losses", "grad_norms", "grad_norms_2",
    "change_norms"."""
    gaps = [abs(p - r) / max(abs(r), 1e-12)
            for p, r in zip(prog["losses"], ref["losses"])]
    second = sorted(ref["grad_norms_2"])
    return {"loss_gap": gaps[0],
            **{f"loss_gap.{i}": g for i, g in enumerate(gaps[1:], 2)},
            "grad_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                    sorted(ref["grad_norms"])),
            "grad_gap.2": _worst_leaf(prog["grad_norms_2"],
                                      ref["grad_norms_2"], second),
            "grad_gap_median.2": _median_leaf(prog["grad_norms_2"],
                                              ref["grad_norms_2"], second),
            "change_gap": _worst_leaf(prog["change_norms"],
                                      ref["change_norms"],
                                      counted_leaves(ref))}
