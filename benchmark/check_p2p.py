"""The comparison that decides `correct` in the pix2pixHD cell.

The reference (`reference.pix2pixhd`: the same weights from the seed,
the same host batches, Adams of its own) follows the system's first two
iterations at the cell's size. Each number is a distance of the system's
reading from the reference's:

- `fake_gap`: G's output on the first batch, |system - reference| /
  |reference|;
- `d_logit_gap`: D's patch logits on the first batch, of the pair with
  the fake and of the pair with the target, at each of the scales: the
  largest of their relative distances;
- `g_gan_gap`, `g_feat_gap`, `g_vgg_gap`, `d_real_gap`, `d_fake_gap`:
  the first iteration's loss terms, each relative to the reference's;
  the same with `.2` for the second iteration, printed as readings and
  not compared: the second iteration is held by `change_gap` and
  `d_change_gap`;
- `g_grad_gap`, `d_grad_gap`: G's and D's first gradients as their Adams
  hold them (the first moment over 1 - beta1), |system - reference| /
  |reference| over all of the network's parameters; the second
  gradients' the same with `.2`, printed and not compared;
- `change_gap`, `d_change_gap`: each network's parameters' change over
  the two iterations, |system - reference| / |reference| over the
  entries whose steps clear their rounding. Adam's first step moves
  each weight by about the learning rate along the sign of its first
  gradient, the second along the sign of its first moment (g1 + 2 g2,
  up to a factor, at these betas); an entry where either lies within
  its rounding steps either way. So an entry is compared where the
  reference's first gradient and its first moment after the second
  step each exceed a tenth (`CLEAR`) of their tensor's rms; the biases
  that an instance norm cancels (their whole tensor's gradient is 0 up
  to rounding) are left out. A state left unchanged reads 1. The same
  over every entry but those biases is printed as `change_gap.all` and
  `d_change_gap.all`, and not compared. G's second gradient amplifies
  its first step's rounding (the reference against itself: 1e-3 on the
  first gradient, 3-5e-2 on the second), so G's change reads about a
  tenth on sound runs, and precision hardly moves it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pix2pixhd as R
from benchmark.weights_pix2pixhd import copy, options

STEPS = 2                        # iterations the reference follows
CLEAR = 0.1                      # a compared change's first gradient and
                                 # second first moment over their
                                 # tensor's rms, at least
TERMS = {"G_GAN": "g_gan", "G_GAN_Feat": "g_feat", "G_VGG": "g_vgg",
         "D_real": "d_real", "D_fake": "d_fake"}


def config(ctx) -> dict:
    """The reference's options and Adam's settings from the
    configuration."""
    m = ctx.model_config()
    return {**options(m), "lr": m["lr"], "beta1": m["beta1"],
            "beta2": m["beta2"]}


def on_device(host: dict, device):
    """A host batch as the system stages it: uint8 / 255 on the device."""
    return [torch.from_numpy(np.ascontiguousarray(host[k])).to(device)
            .float() / 255.0 for k in ("label", "image")]


def flat(tensors: dict, names, scale: float = 1.0):
    """The named tensors flattened in `names`' order, on the host."""
    return torch.cat([tensors[n].detach().reshape(-1) for n in names]
                     ).cpu() * scale


def changed_names(cfg):
    """(G's, D's) parameters whose change is compared."""
    skip = R.normed_biases(cfg)
    return ([n for n in R.names(R.generator_specs(cfg)) if n not in skip],
            [n for n in R.names(R.disc_specs(cfg)) if n not in skip])


def cleared(tensors: dict, names):
    """Per entry of the named tensors, in `names`' order, on the host:
    whether it exceeds `CLEAR` times its tensor's rms."""
    return torch.cat([(t.abs() > CLEAR * t.square().mean().sqrt())
                      .reshape(-1).cpu()
                      for t in (tensors[n].detach() for n in names)])


def reference_readings(ctx, W, kept, device, precision: str, fault=None):
    """The reference's readings over the kept host batches, W's weights
    (on any device) moved to `device`. `fault`: one of `R.FAULTS`."""
    R.set_precision(precision, device)
    P = {part: {n: t.to(device) for n, t in w.items()}
         for part, w in copy(W).items()}
    cfg = config(ctx)
    g_names = R.names(R.generator_specs(cfg))
    d_names = R.names(R.disc_specs(cfg))
    g_kept, d_kept = changed_names(cfg)
    adam_g, adam_d = {}, {}
    out = {"losses": []}
    try:
        for step, host in enumerate(kept, 1):
            label, image = on_device(host, device)
            got = R.iteration(P["gen"], P["disc"], P["vgg"], label, image,
                              adam_g, adam_d, cfg, fault)
            out["losses"].append(got["terms"])
            if step == 1:
                out["fake"] = got["fake"].cpu()
                out["logits"] = {k: [t.cpu() for t in v]
                                 for k, v in got["logits"].items()}
                out["g_grad"] = flat(got["g_grads"], g_names)
                out["d_grad"] = flat(got["d_grads"], d_names)
                g_first = cleared(got["g_grads"], g_kept)
                d_first = cleared(got["d_grads"], d_kept)
            if step == 2:
                out["g_grad2"] = flat(got["g_grads"], g_names)
                out["d_grad2"] = flat(got["d_grads"], d_names)
                out["change_mask"] = g_first & cleared(
                    {n: adam_g[("m", n)] for n in g_kept}, g_kept)
                out["d_change_mask"] = d_first & cleared(
                    {n: adam_d[("m", n)] for n in d_kept}, d_kept)
            del got, label, image
    finally:
        R.set_precision("f32", device)
    for key, part, names in zip(("change", "d_change"), ("gen", "disc"),
                                (g_kept, d_kept)):
        out[key] = flat({n: P[part][n] - W[part][n].to(device)
                         for n in names}, names)
    return out


def _vec_gap(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def judge(prog: dict, ref: dict) -> dict:
    """prog: the system's readings under the same keys as
    `reference_readings`' ("losses", "fake", "logits", "g_grad",
    "d_grad", "g_grad2", "d_grad2", "change", "d_change"), on the host;
    the changes are compared where `ref`'s masks hold."""

    def rel(p, r):
        return abs(p - r) / max(abs(r), 1e-30)

    out = {"fake_gap": _vec_gap(prog["fake"], ref["fake"]),
           "d_logit_gap": max(_vec_gap(p, r) for k in ("fake", "real")
                              for p, r in zip(prog["logits"][k],
                                              ref["logits"][k])),
           "g_grad_gap": _vec_gap(prog["g_grad"], ref["g_grad"]),
           "d_grad_gap": _vec_gap(prog["d_grad"], ref["d_grad"])}
    for key in ("change", "d_change"):
        p, r, m = prog[key], ref[key], ref[f"{key}_mask"]
        out[f"{key}_gap"] = _vec_gap(p[m], r[m])
        out[f"{key}_gap.all"] = _vec_gap(p, r)
    for key in ("g_grad", "d_grad"):
        out[f"{key}_gap.2"] = _vec_gap(prog[f"{key}2"], ref[f"{key}2"])
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        suffix = "" if i == 1 else f".{i}"
        for k, short in TERMS.items():
            out[f"{short}_gap{suffix}"] = rel(p[k], r[k])
    return out
