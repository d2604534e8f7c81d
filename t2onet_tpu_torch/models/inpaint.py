"""First-party inpainting filler for the inpaint operator slot
(counterpart of `t2onet_tpu.models.inpaint`).

The reference's InpaintOperator calls an external pretrained EdgeConnect
model (`models/edgeconnect.py` loads one); this is the trainable filler:
gated convolutions (elu(feature) * sigmoid(gate), DeepFill-v2's) around
a dilated bottleneck, no normalization, so the forward is a pure
function of (weights, img, mask).

Convention (the operator library's): img (B, 3, H, W) f32 in [0, 1];
mask (B, 1, H, W), 1 = the region to fill. H and W are multiples of 4.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2onet_tpu_torch.ops.color import abs_


class GatedConv(nn.Module):
    """A conv emitting 2F channels, split feature-first (as jnp.split):
    out = elu(feature) * sigmoid(gate)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, 2 * features, kernel, stride,
                              padding=dilation * (kernel - 1) // 2,
                              dilation=dilation)

    def forward(self, x):
        feat, gate = self.conv(x).chunk(2, dim=1)
        return F.elu(feat) * torch.sigmoid(gate)


def _upsample2(x):
    """Nearest-neighbour 2x upsample (resize, then conv: no checkerboard
    of transposed convs)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class InpaintNet(nn.Module):
    """Free-form inpainting generator: a gated-conv encoder with two
    stride-2 stages, a dilated residual gated bottleneck, a
    nearest-upsample decoder and a sigmoid RGB head. `gated` holds the
    gated convs in the JAX module's order (GatedConv_0, 1, ...), `out`
    the head (Conv_0)."""

    def __init__(self, features: int = 32,
                 dilations: Sequence[int] = (2, 4, 8, 2)):
        super().__init__()
        f = features
        self.features = features
        self.dilations = tuple(dilations)
        layers = [GatedConv(4, f, kernel=5), GatedConv(f, 2 * f, stride=2),
                  GatedConv(2 * f, 2 * f), GatedConv(2 * f, 4 * f, stride=2)]
        layers += [GatedConv(4 * f, 4 * f, dilation=d) for d in dilations]
        layers += [GatedConv(4 * f, 2 * f), GatedConv(2 * f, f)]
        self.gated = nn.ModuleList(layers)
        self.out = nn.Conv2d(f, 3, 3, padding=1)

    def forward(self, img, mask):
        """img (B, 3, H, W), mask (B, 1, H, W) -> the raw prediction of
        the whole image (callers compose it with :func:`compose`)."""
        holed = img * (1.0 - mask)
        x = torch.cat([holed, mask.to(img.dtype)], dim=1)
        g = self.gated
        n = len(self.dilations)
        for layer in g[:4]:
            x = layer(x)
        for layer in g[4:4 + n]:
            x = x + layer(x)                  # residual dilated block
        x = g[4 + n](_upsample2(x))
        x = g[5 + n](_upsample2(x))
        return torch.sigmoid(self.out(x))


def compose(pred, img, mask):
    """Keep the valid region of the input, fill the hole from the net."""
    return img * (1.0 - mask) + pred * mask


def make_inpaint_fn(net: InpaintNet, mask):
    """The `inpaint_fn(img)` closure the operator bank takes
    (ops/operators.py:inpaint). The mask (1, 1, H, W), the reference
    operator's externally set mask, broadcasts over the image batch, so
    one pair mask serves every beam row in the planner."""
    mask = torch.as_tensor(mask)

    def inpaint_fn(img):
        m = mask.to(img.device, img.dtype).expand(
            (img.shape[0], 1) + tuple(img.shape[2:]))
        return compose(net(img, m), img, m)

    return inpaint_fn


def inpaint_loss(pred, target, mask, hole_weight: float = 6.0):
    """Weighted reconstruction L1: the hole counts `hole_weight` times the
    valid region (|.| with jnp.abs's gradient at 0, `ops.color.abs_`)."""
    err = abs_(pred - target)
    hole = (err * mask).sum() / (mask.sum() * err.shape[1] + 1e-8)
    valid = (err * (1.0 - mask)).sum() / (
        (1.0 - mask).sum() * err.shape[1] + 1e-8)
    return hole_weight * hole + valid


def random_freeform_masks(rng: np.random.Generator, batch: int, h: int,
                          w: int, max_strokes: int = 4) -> np.ndarray:
    """Random free-form training masks: thick polyline strokes plus an
    occasional rectangle, (B, 1, H, W) f32 in {0, 1}; host numpy, the same
    draws from `rng` and the same masks as the JAX package's. Each disk of
    a stroke is tested only over its bounding box and a pixel's margin
    (outside it no pixel is within `thick`), which at 600² is ~10x
    faster than testing the whole image."""
    masks = np.zeros((batch, 1, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for b in range(batch):
        for _ in range(rng.integers(1, max_strokes + 1)):
            if rng.uniform() < 0.3:                   # rectangle
                y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
                y1 = y0 + rng.integers(h // 8 + 1, h // 2 + 1)
                x1 = x0 + rng.integers(w // 8 + 1, w // 2 + 1)
                masks[b, 0, y0:y1, x0:x1] = 1.0
            else:                                     # thick polyline
                n_pts = rng.integers(2, 5)
                pts = np.stack([rng.integers(0, h, n_pts),
                                rng.integers(0, w, n_pts)], 1)
                thick = rng.integers(max(h // 16, 2), max(h // 6, 3))
                for (y0, x0), (y1, x1) in zip(pts[:-1], pts[1:]):
                    steps = max(abs(y1 - y0), abs(x1 - x0), 1)
                    for t in np.linspace(0.0, 1.0, steps + 1):
                        cy = y0 + t * (y1 - y0)
                        cx = x0 + t * (x1 - x0)
                        ya = max(int(np.floor(cy - thick)) - 1, 0)
                        yb = min(int(np.ceil(cy + thick)) + 2, h)
                        xa = max(int(np.floor(cx - thick)) - 1, 0)
                        xb = min(int(np.ceil(cx + thick)) + 2, w)
                        d2 = ((yy[ya:yb, xa:xb] - cy) ** 2
                              + (xx[ya:yb, xa:xb] - cx) ** 2)
                        masks[b, 0, ya:yb, xa:xb][d2 <= thick ** 2] = 1.0
    return masks


def save_inpaint(path: str, net: InpaintNet) -> None:
    """The weights as `params.pt` (torch.save of the state_dict) beside
    the JAX package's `arch.json`."""
    os.makedirs(path, exist_ok=True)
    torch.save(net.state_dict(), os.path.join(path, "params.pt"))
    with open(os.path.join(path, "arch.json"), "w") as f:
        json.dump({"features": net.features,
                   "dilations": list(net.dilations)}, f)


def load_inpaint(path: str, device="cpu") -> InpaintNet:
    """The InpaintNet saved by :func:`save_inpaint`, on `device`, in eval
    mode."""
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    net = InpaintNet(features=arch["features"],
                     dilations=tuple(arch["dilations"]))
    net.load_state_dict(torch.load(os.path.join(path, "params.pt"),
                                   map_location="cpu", weights_only=True))
    return net.to(device).eval()


def make_train_step(net: InpaintNet, opt: torch.optim.Optimizer):
    """The self-supervised step: reconstruct images through random holes.
    Returns step(img, mask) -> the loss before the update (detached)."""

    def step(img, mask):
        net.train()
        loss = inpaint_loss(net(img, mask), img, mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step
