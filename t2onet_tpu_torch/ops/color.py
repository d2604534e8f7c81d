"""Small color helpers and the branchless RGB <-> HSV pair (counterpart
of `t2onet_tpu.ops.color`).

Hue is in [0, 1) (a fraction of the color wheel), as in the JAX package.
Images are NCHW (B, 3, H, W) in [0, 1]."""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


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


def rgb_to_hsv(img):
    """RGB -> (h, s, v), each (B, 1, H, W), h in [0, 1); branchless.

    Ties between channels go to r, then g (`maxc == r` is tested first);
    the hue offset of the r sextant wraps with `torch.remainder` (jnp.mod:
    the sign of the divisor), not `torch.fmod`."""
    r, g, b = img[:, 0:1], img[:, 1:2], img[:, 2:3]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    v = maxc
    s = delta / (maxc + _EPS)
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    h_r = torch.remainder((g - b) / safe_delta, 6.0)
    h_g = (b - r) / safe_delta + 2.0
    h_b = (r - g) / safe_delta + 4.0
    h = torch.where(maxc == r, h_r, torch.where(maxc == g, h_g, h_b))
    h = torch.where(delta > 0, h / 6.0, torch.zeros_like(h))
    return h, s, v


def hsv_to_rgb(h, s, v):
    """(h, s, v), each (B, 1, H, W), -> RGB (B, 3, H, W); h wraps mod 1
    (h = 1 is h = 0). The sextant is the floored float h*6, picked by
    equality tests, without a gather."""
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i0, i1, i2, i3, i4, i5 = (i == k for k in range(6))
    r = torch.where(i0 | i5, v, torch.where(i1, q, torch.where(i4, t, p)))
    g = torch.where(i0, t, torch.where(i1 | i2, v, torch.where(i3, q, p)))
    b = torch.where(i2, t, torch.where(i3 | i4, v, torch.where(i5, q, p)))
    return torch.cat([r, g, b], dim=1)
