"""The comparison that decides `correct` in the inpainting cell.

The reference (`reference.edgeconnect`: the same weights from the seed,
the same host batches and masks, Adams of its own, canny on the host)
follows the system's first two iterations at the cell's size. Each
number is a distance of the system's reading from the reference's:

- `edge_px_off`: the edge maps the edge G took (its edge channel,
  edges*(1-m)), differing pixels over all pixels, the larger of the two
  iterations';
- `edge_g_gap`: the edge G's output, |system - reference| / |reference|
  over the batch, the larger of the two iterations';
- `g_adv_gap`, `g_l1_gap`, `g_content_gap`, `g_style_gap`: G's four
  weighted loss terms of the first iteration, each relative to the
  reference's; `d_loss_gap`: D's loss; the same with `.2` for the
  second iteration, printed as readings and not compared: the second
  iteration is held by `change_gap` and `d_change_gap` (the parameters
  after it) and by the edges and edge G output of both iterations, and
  its losses' sound readings (up to 6.7e-5, the style term's) lie within
  1.3 to 6 times of the TF32 control's, too close for a limit that fresh
  seeds would not cross;
- `g_grad_gap`, `d_grad_gap`: G's and D's first gradients as their Adams
  hold them (beta1 is 0: the first moment is the gradient), |system -
  reference| / |reference| over all of the network's parameters;
- `sigma_gap`: every spectral-normed layer's sigma after the first
  iteration's power iterations (u . (W0 v), W0 the seed's weight, u and v
  the layer's vectors then), the largest relative distance: the edge
  G's layers take one power iteration, D's three;
- `change_gap`, `d_change_gap`: each network's parameters' change over
  the two iterations, |system - reference| / |reference| over all of
  them. Adam's first steps move each value by about the learning rate
  whatever its gradient's size, so precision hardly moves them; a state
  left unchanged reads 1.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import edgeconnect as R
from benchmark.weights_edgeconnect import copy

STEPS = 2                        # iterations the reference follows
TERMS = ("G_adv", "G_l1", "G_content", "G_style")
TRANSPOSED = ("decoder.0", "decoder.3")


def config(ctx) -> dict:
    """The iteration's settings from the configuration."""
    m = ctx.model_config()
    return {"lr": m["lr"], "d2g_lr": m["d2g_lr"], "beta1": m["beta1"],
            "beta2": m["beta2"], "sigma": float(m["sigma"])}


def loss_weights(ctx) -> dict:
    m = ctx.model_config()
    return {"l1": float(m["l1_loss_weight"]),
            "adv": float(m["inpaint_adv_loss_weight"]),
            "content": float(m["content_loss_weight"]),
            "style": float(m["style_loss_weight"])}


def on_device(host: dict, device, rows=None):
    """A host batch as the system stages it: uint8 images / 255 on the
    device, f32 masks."""
    sel = slice(None) if rows is None else rows
    img = torch.from_numpy(np.ascontiguousarray(host["images"][sel]))
    m = torch.from_numpy(np.ascontiguousarray(host["masks"][sel]))
    return img.to(device).float() / 255.0, m.to(device)


def sigmas(vectors: dict, W0: dict) -> dict:
    """{layer: u . (W0 v)} from {layer: (u, v)} and the seed's weights."""
    out = {}
    for name, (u, v) in vectors.items():
        w = W0[f"{name}.weight_orig"]
        if name in TRANSPOSED:
            w = w.transpose(0, 1)
        out[name] = float(torch.dot(u, torch.mv(w.reshape(w.shape[0], -1),
                                                v.to(w.device))))
    return out


def _flat(tensors: dict, names):
    return torch.cat([tensors[n].reshape(-1) for n in names])


def reference_readings(ctx, W, kept, device, precision: str, rows=None,
                       fault=None):
    """The reference's readings over the kept host batches. `rows` keeps
    only those rows of every batch; `fault` plants "no_style" (the style
    weight 0) or "no_power" (G's pass through D takes no power
    iteration)."""
    R.set_precision(precision, device)
    P = copy(W)
    weights = loss_weights(ctx)
    if fault == "no_style":
        weights["style"] = 0.0
    cfg = config(ctx)
    g_names = R.trainable_names(R.generator_specs("inpaint"))
    d_names = R.trainable_names(R.disc_specs())
    adam_g, adam_d = {}, {}
    out = {"losses": [], "edges": [], "pred": []}
    try:
        for step, host in enumerate(kept, 1):
            img, m = on_device(host, device, rows)
            got = R.iteration(P["edge"], P["inpaint"], P["disc"], P["vgg"],
                              img, m, adam_g, adam_d, cfg, weights,
                              skip_power=fault == "no_power")
            out["losses"].append({**got["terms"], "D_loss": got["d_loss"]})
            out["edges"].append(got["edges"][:, 0])
            out["pred"].append(got["pred"].cpu())
            if step == 1:
                out["g_grad"] = _flat(got["g_grads"], g_names)
                out["d_grad"] = _flat(got["d_grads"], d_names)
                vec = {n: (P[part][f"{n}.weight_u"], P[part][f"{n}.weight_v"])
                       for part in ("edge", "disc")
                       for n in R.spectral_names(
                           R.generator_specs("edge") if part == "edge"
                           else R.disc_specs())}
                out["sigma"] = sigmas(vec, {**W["edge"], **W["disc"]})
            del got, img, m
    finally:
        R.set_precision("f32", device)
    out["change"] = _flat({n: P["inpaint"][n] - W["inpaint"][n]
                           for n in g_names}, g_names)
    out["d_change"] = _flat({n: P["disc"][n] - W["disc"][n]
                             for n in d_names}, d_names)
    return out


def _vec_gap(a, b) -> float:
    return float((a.to(b.device) - b).norm() / b.norm())


def judge(prog: dict, ref: dict) -> dict:
    """prog: the system's readings under the same keys as
    `reference_readings`' ("losses", "edges", "pred", "g_grad", "d_grad",
    "sigma", "change", "d_change")."""

    def rel(p, r):
        return abs(p - r) / max(abs(r), 1e-30)

    out = {
        "edge_px_off": max(float((p != r).float().mean()) for p, r in
                           zip(prog["edges"], ref["edges"])),
        "edge_g_gap": max(_vec_gap(p, r) for p, r in
                          zip(prog["pred"], ref["pred"])),
        "g_grad_gap": _vec_gap(prog["g_grad"], ref["g_grad"]),
        "d_grad_gap": _vec_gap(prog["d_grad"], ref["d_grad"]),
        "sigma_gap": max(rel(prog["sigma"][n], v)
                         for n, v in ref["sigma"].items()),
        "change_gap": _vec_gap(prog["change"], ref["change"]),
        "d_change_gap": _vec_gap(prog["d_change"], ref["d_change"])}
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]), 1):
        suffix = "" if i == 1 else f".{i}"
        for k in TERMS:
            out[f"g_{k[2:].lower()}_gap{suffix}"] = rel(p[k], r[k])
        out[f"d_loss_gap{suffix}"] = rel(p["D_loss"], r["D_loss"])
    return out
