"""Small color helpers (counterpart of `t2onet_tpu.ops.color`)."""

from __future__ import annotations

import math

import torch


def clip(x, lo, hi):
    """jnp.clip's form, minimum(maximum(x, lo), hi): the same values as
    torch.clamp, but a tie at a bound splits the gradient in half as in
    JAX (torch.clamp passes all of it). lo and hi are floats or tensors."""
    if not torch.is_tensor(lo):
        lo = x.new_full((), lo)
    if not torch.is_tensor(hi):
        hi = x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def abs_(x):
    """jnp.abs's form: the same values as torch.abs, but at 0 the
    gradient is +1 as in JAX (torch.abs passes 0). An L1 distance to a
    target equal to the input at some pixels (GIER's local edits) meets
    exact zeros wherever an op starts at the identity."""
    return torch.where(x >= 0, x, -x)


def lerp(a, b, t):
    return (1.0 - t) * a + t * b


def rgb2lum(img):
    """Luminance with the 0.27/0.67/0.06 weights. (B,3,H,W) -> (B,1,H,W)."""
    lum = 0.27 * img[:, 0] + 0.67 * img[:, 1] + 0.06 * img[:, 2]
    return lum[:, None]


def tanh01(x):
    return torch.tanh(x) * 0.5 + 0.5


def tanh_range(l: float, r: float, initial: float | None = None):
    """Squash to [l, r] with an optional resting point at `initial`."""
    if initial is not None:
        bias = math.atanh(2.0 * (initial - l) / (r - l) - 1.0)
    else:
        bias = 0.0

    def activation(x):
        return tanh01(x + bias) * (r - l) + l

    return activation
