"""The editing operators, frozen in plain PyTorch for the benchmark's
reference.

Two forms of the eight operators are kept, as the system defines them:

- the operator formulas (`brightness` ... `white`, `mask_blend`), which
  the decode's execute at the probe resolution applies, one selected op
  per image (`execute_selected`);
- the chain step as the kernels compute it (`chain_forward`: the min-form
  curves, the polynomial cosine of contrast, saturation's single scaled
  quotient), and its VJP written out with the tie rules of the reference
  framework (`chain_step_vjp`): clip passes half the cotangent at 0 and 1,
  a pairwise max or min splits a tie in half. `ChainStep` makes the two an
  autograd function: the episode's execute.

Slot ids: 0 identity, 1..8 = brightness, contrast, saturation, color,
inpaint (identity), tone, sharpness, white. Decoder vocabulary ids map to
slots as id - 2 for ids >= 3, and to 0 below.

This file imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_PARAM = 24
CURVE_STEPS = 8
# the chain's arithmetic type: float32, or bfloat16 in the control
# (`model.set_precision("tf32")`), the nearest type below float32 for
# element-wise work
CHAIN_DTYPE = torch.float32
N_OPS = 8
PARAM_COUNTS = (1, 1, 1, 24, 1, 8, 1, 1)
_S = 1048576.0                  # 2^20, saturation's exact scaling


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



def _s(param):
    """Per-image param (B,), (B,1) or (B,k) -> (B,1,1,1) from column 0."""
    if param.ndim == 1:
        param = param[:, None]
    return param[:, 0:1, None, None]


def mask_blend(out, img, mask=None):
    """Blend the processed image into the unmasked original, then clamp."""
    if mask is not None:
        out = out * mask + img * (1.0 - mask)
    return clip(out, 0.0, 1.0)


def brightness(img, param):
    """HSV value scale computed in RGB: rgb * clip(v(1+p)) / v."""
    v = torch.amax(img, dim=1, keepdim=True)
    k = clip(v * (1.0 + _s(param)), 0.0, 1.0) / (v + 1e-12)
    return img * k


def contrast(img, param):
    """Cosine-luminance contrast curve."""
    lum = clip(rgb2lum(img), 0.0, 1.0)
    contrast_lum = -torch.cos(math.pi * lum) * 0.5 + 0.5
    contrast_img = img / (lum + 1e-6) * contrast_lum
    return lerp(img, contrast_img, _s(param))


def saturation(img, param):
    """HSV saturation scale computed in RGB: c' = v - r (v - c)."""
    v = torch.amax(img, dim=1, keepdim=True)
    mn = torch.amin(img, dim=1, keepdim=True)
    s = (v - mn) / (v + 1e-8)
    ratio = clip(s * (1.0 + _s(param)), 0.0, 1.0) / (s + 1e-12)
    return v - ratio * (v - img)


def _piecewise_curve(img, curve):
    """out = (sum_i clip(img - i/S, 0, 1/S) * c_i) * S / sum(c);
    curve (B, C, S) with C in {1, 3}."""
    s = curve.shape[2]
    curve = curve[:, :, :, None, None]                      # (B, C, S, 1, 1)
    curve_sum = curve.sum(2) + 1e-10                        # (B, C, 1, 1)
    steps = torch.arange(s, dtype=img.dtype, device=img.device) / s
    seg = clip(img[:, :, None] - steps[None, None, :, None, None],
               0.0, 1.0 / s)
    total = (seg * curve).sum(2)
    return total * s / curve_sum


def tone_curve(img, param):
    return _piecewise_curve(img, param.reshape(-1, 1, CURVE_STEPS))


def color_curve(img, param):
    return _piecewise_curve(img, param.reshape(-1, 3, CURVE_STEPS))


# host-side taps: each is a Python float in the sum
_LAPLACIAN = np.array(
    [[0.0, -1.0, 0.0], [-1.0, 4.0, -1.0], [0.0, -1.0, 0.0]], dtype=np.float32)


def _conv3x3_same(img, kernel):
    """Depthwise zero-padded 3x3 'same' convolution as shifted adds, in
    the JAX package's tap order (dy, then dx, zero taps skipped). kernel:
    a numpy (3, 3)."""
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            w = float(kernel[dy, dx])
            if w == 0.0:
                continue
            shifted = torch.roll(img, shifts=(1 - dy, 1 - dx), dims=(2, 3))
            if dy == 0:
                shifted[:, :, 0, :] = 0.0
            elif dy == 2:
                shifted[:, :, -1, :] = 0.0
            if dx == 0:
                shifted[:, :, :, 0] = 0.0
            elif dx == 2:
                shifted[:, :, :, -1] = 0.0
            out = out + w * shifted
    return out


def sharpness(img, param):
    """img + p * Laplacian(img)."""
    return img + _s(param) * _conv3x3_same(img, _LAPLACIAN)


def white(img, param):
    del param
    return torch.ones_like(img)


# ---------------------------------------------------------------------------
# the chain step as the kernels compute it: forward, and its VJP
# ---------------------------------------------------------------------------

def _clip01(x):
    return clip(x, 0.0, 1.0)


def _scalar(p):
    """Column 0 of the (B, 24) params as (B, 1, 1, 1)."""
    return p[:, 0].view(-1, 1, 1, 1)


def _brightness(img, p):
    v = torch.maximum(torch.maximum(img[:, 0:1], img[:, 1:2]), img[:, 2:3])
    k = _clip01(v * (1.0 + _scalar(p))) / (v + 1e-12)
    return img * k


def _saturation(img, p):
    s = 1048576.0                                   # 2^20, an exact scaling
    v = torch.maximum(torch.maximum(img[:, 0:1], img[:, 1:2]), img[:, 2:3])
    mn = torch.minimum(torch.minimum(img[:, 0:1], img[:, 1:2]), img[:, 2:3])
    d = v - mn
    ve = v + 1e-8
    num = clip(d * (1.0 + _scalar(p)), 0.0, ve) * s
    ratio = num / (d * s + (1e-12 * s) * ve)
    return v - ratio * (v - img)


# sin(pi*u)/u as an even polynomial in u^2 (pallas_fused._SINPI_C)
_SINPI_C = (3.1415926536, -5.1677127683, 2.5501634534,
            -5.9925387121e-1, 8.2058791186e-2, -7.0429524662e-3)


def _contrast(img, p):
    lum = _clip01(0.27 * img[:, 0:1] + 0.67 * img[:, 1:2]
                  + 0.06 * img[:, 2:3])
    u = lum - 0.5
    v = u * u
    w = v * v
    c = _SINPI_C
    acc = (c[0] + c[1] * v) + w * ((c[2] + c[3] * v) + w * (c[4] + c[5] * v))
    clum = (acc * u) * 0.5 + 0.5
    ratio = clum / (lum + 1e-6)
    pk = _scalar(p)
    k = (1.0 - pk) + pk * ratio
    return img * k


def _curve(x, knots):
    """Min-form 8-knot curve: x (B,C,H,W), knots (B,C|1,8). With t=S*x,
    sum_i p_i clip(x - i/S, 0, 1/S) S/csum equals
    a x - sum_j b_j min(x, j/S), a = S p_{S-1}/csum,
    b_j = S (p_j - p_{j-1})/csum."""
    p = knots[:, :, :, None, None]                  # (B, C|1, 8, 1, 1)
    csum = torch.full_like(p[:, :, 0], 1e-10)
    for i in range(CURVE_STEPS):
        csum = csum + p[:, :, i]
    s = CURVE_STEPS / csum
    out = (s * p[:, :, CURVE_STEPS - 1]) * x
    for j in range(1, CURVE_STEPS):
        out = out - (s * (p[:, :, j] - p[:, :, j - 1])) * torch.minimum(
            x, x.new_full((), j / CURVE_STEPS))
    return out


def _tone(img, p):
    return _curve(img, p[:, None, 0:CURVE_STEPS])


def _color(img, p):
    return _curve(img, p.reshape(-1, 3, CURVE_STEPS))


def _sharpness(img, p):
    z = torch.zeros_like(img[:, :, :1])
    up = torch.cat([z, img[:, :, :-1]], dim=2)          # img[y-1, x]
    down = torch.cat([img[:, :, 1:], z], dim=2)         # img[y+1, x]
    zc = torch.zeros_like(img[:, :, :, :1])
    left = torch.cat([zc, img[:, :, :, :-1]], dim=3)    # img[y, x-1]
    right = torch.cat([img[:, :, :, 1:], zc], dim=3)    # img[y, x+1]
    delta = 4.0 * img - up - down - left - right
    return img + _scalar(p) * delta


def _white(img, p):
    return torch.ones_like(img)


_BRANCHES = {1: _brightness, 2: _contrast, 3: _saturation, 4: _color,
             6: _tone, 7: _sharpness, 8: _white}


def fused_chain_reference(imgs, op_slots, params, mask=None):
    """Plain PyTorch chain: imgs (B,3,H,W) f32, op_slots (B,K) int,
    params (B,K,24) f32, optional mask (B,1,H,W) -> (B,3,H,W) f32.
    Out-of-range slots clamp into 0..8, as `lax.switch` clamps its index.
    With a mask, each executed step is clip(op(x)*m + x*(1-m), 0, 1)."""
    out = imgs
    slots = op_slots.clamp(0, 8)
    if mask is not None:
        mask = mask.to(imgs.dtype)
    for k in range(op_slots.shape[1]):
        sk = slots[:, k].view(-1, 1, 1, 1)
        pk = params[:, k]
        nxt = out
        for slot, branch in _BRANCHES.items():
            y = branch(out, pk)
            if mask is not None:
                y = y * mask + out * (1.0 - mask)
            nxt = torch.where(sk == slot, _clip01(y), nxt)
        out = nxt
    return out


def _clip_d(y):
    """d clip(y, 0, 1) / dy with jnp's ties: 1 inside, 1/2 at 0 and 1."""
    inside = (y > 0.0) & (y < 1.0)
    edge = (y == 0.0) | (y == 1.0)
    return torch.where(inside, 1.0, torch.where(edge, 0.5, 0.0))


def _dmax(a, b):
    """d max(a, b) / da with jnp's ties."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _dmin(a, b):
    """d min(a, b) / da with jnp's ties."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _csum3(t):
    """Sum over the channel axis of (n, 3, H, W) in the order (c0+c1)+c2."""
    return (t[:, 0] + t[:, 1]) + t[:, 2]


def _col(p, j):
    return p[:, j].view(-1, 1, 1)


def _blend_ct(o, x, g, m):
    """(the op's cotangent, x's direct term or None) for out = clip(y):
    y = o, or with a mask m (n, H, W) y = o*m + x*(1-m)."""
    if m is None:
        return g * _clip_d(o), None
    m = m[:, None]
    gy = g * _clip_d(o * m + x * (1.0 - m))
    return gy * m, gy * (1.0 - m)


def _plus(direct, t):
    return t if direct is None else direct + t


def _bwd_brightness(x, g, p, m=None):
    r, gg, b = x[:, 0], x[:, 1], x[:, 2]
    m1 = torch.maximum(r, gg)
    v = torch.maximum(m1, b)
    onep = 1.0 + _col(p, 0)
    t = v * onep
    c = clip(t, 0.0, 1.0)
    den = v + 1e-12
    k = c / den
    gc, direct = _blend_ct(x * k[:, None], x, g, m)
    dx = _plus(direct, gc * k[:, None])
    ct_k = _csum3(gc * x)
    ct_c = ct_k / den
    ct_den = -((ct_k * (1.0 / (den * den))) * c)
    ct_t = ct_c * _clip_d(t)
    ct_v = ct_den + ct_t * onep
    ct_m1 = ct_v * _dmax(m1, b)
    dimg = dx + torch.stack([ct_m1 * _dmax(r, gg), ct_m1 * _dmax(gg, r),
                             ct_v * _dmax(b, m1)], dim=1)
    return dimg, [ct_t * v]


def _bwd_contrast(x, g, p, m=None):
    r, gg, b = x[:, 0], x[:, 1], x[:, 2]
    p0 = _col(p, 0)
    c = _SINPI_C
    lum_raw = (0.27 * r + 0.67 * gg) + 0.06 * b
    lum = clip(lum_raw, 0.0, 1.0)
    u = lum - 0.5
    v = u * u
    w = v * v
    wc = c[4] + c[5] * v
    y_ = (c[2] + c[3] * v) + w * wc
    acc = (c[0] + c[1] * v) + w * y_
    au = acc * u
    clum = au * 0.5 + 0.5
    den = lum + 1e-6
    ratio = clum / den
    k = (1.0 - p0) + p0 * ratio
    gc, direct = _blend_ct(x * k[:, None], x, g, m)
    dx = _plus(direct, gc * k[:, None])
    ct_k = _csum3(gc * x)
    ct_ratio = ct_k * p0
    ct_clum = ct_ratio / den
    ct_den = -((ct_ratio * (1.0 / (den * den))) * clum)
    ct_au = ct_clum * 0.5
    ct_acc = ct_au * u
    ct_u = ct_au * acc
    ct_y = ct_acc * w
    ct_w = ct_acc * y_
    ct_wc = ct_y * w
    ct_w = ct_w + ct_y * wc
    ct_v = ct_wc * c[5]
    ct_v = ct_v + ct_y * c[3]
    ct_v = ct_v + ct_acc * c[1]
    ct_v = ct_v + ct_w * v
    ct_v = ct_v + ct_w * v
    ct_u = ct_u + ct_v * u
    ct_u = ct_u + ct_v * u
    ct_lr = (ct_den + ct_u) * _clip_d(lum_raw)
    dimg = dx + torch.stack([ct_lr * 0.27, ct_lr * 0.67, ct_lr * 0.06], dim=1)
    return dimg, [ct_k * ratio, ct_k]


def _bwd_saturation(x, g, p, m=None):
    r, gg, b = x[:, 0], x[:, 1], x[:, 2]
    m1 = torch.maximum(r, gg)
    v = torch.maximum(m1, b)
    n1 = torch.minimum(r, gg)
    mn = torch.minimum(n1, b)
    d = v - mn
    ve = v + 1e-8
    onep = 1.0 + _col(p, 0)
    t = d * onep
    mt = torch.maximum(t, t.new_full((), 0.0))
    nc = torch.minimum(mt, ve)
    num = nc * _S
    den = d * _S + (1e-12 * _S) * ve
    ratio = num / den
    e = v[:, None] - x
    gc, direct = _blend_ct(v[:, None] - ratio[:, None] * e, x, g, m)
    dx = _plus(direct, gc * ratio[:, None])
    ngc = -gc
    ct_e = ngc * ratio[:, None]
    ct_ratio = _csum3(ngc * e)
    ct_num = ct_ratio / den
    ct_den = -((ct_ratio * (1.0 / (den * den))) * num)
    ct_d = ct_den * _S
    ct_ve = ct_den * (1e-12 * _S)
    ct_nc = ct_num * _S
    ct_m = ct_nc * _dmin(mt, ve)
    ct_ve = ct_ve + ct_nc * _dmin(ve, mt)
    ct_t = ct_m * _dmax(t, t.new_full((), 0.0))
    ct_d = ct_d + ct_t * onep
    ct_v = ((_csum3(gc) + _csum3(ct_e)) + ct_ve) + ct_d
    ct_mn = -ct_d
    ct_n1 = ct_mn * _dmin(n1, b)
    ct_m1 = ct_v * _dmax(m1, b)
    dr = (dx[:, 0] + ct_n1 * _dmin(r, gg)) + ct_m1 * _dmax(r, gg)
    dg = (dx[:, 1] + ct_n1 * _dmin(gg, r)) + ct_m1 * _dmax(gg, r)
    db = (dx[:, 2] + ct_mn * _dmin(b, n1)) + ct_v * _dmax(b, m1)
    return torch.stack([dr, dg, db], dim=1), [ct_t * d]


def _curve_coeffs(knots):
    """knots (..., 8) -> csum, s, a, b (..., 7) of the min-form curve."""
    csum = torch.full_like(knots[..., 0], 1e-10)
    for i in range(CURVE_STEPS):
        csum = csum + knots[..., i]
    s = CURVE_STEPS / csum
    a = s * knots[..., CURVE_STEPS - 1]
    bj = [s * (knots[..., j] - knots[..., j - 1])
          for j in range(1, CURVE_STEPS)]
    return csum, s, a, bj


def _bwd_curve(x, g, knots, m=None):
    """x, g (n, C, H, W); knots (n, C|1, 8); optional mask m (n, H, W).
    Returns d_x and the per-pixel quantities [gc*x, -gc*min(x, j/8) for
    j = 1..7], gc the curve's cotangent."""
    _, _, a, bj = _curve_coeffs(knots)
    a = a[..., None, None]
    bj = [t[..., None, None] for t in bj]
    mins = [torch.minimum(x, x.new_full((), j / CURVE_STEPS))
            for j in range(1, CURVE_STEPS)]
    out = a * x
    for j in range(1, CURVE_STEPS):
        out = out - bj[j - 1] * mins[j - 1]
    gc, dx = _blend_ct(out, x, g, m)
    ngc = -gc
    for j in range(CURVE_STEPS - 1, 0, -1):
        term = (ngc * bj[j - 1]) * _dmin(x, x.new_full((), j / CURVE_STEPS))
        dx = term if dx is None else dx + term
    dx = dx + gc * a
    return dx, [gc * x] + [ngc * m for m in mins]


def _curve_params(knots, q):
    """The scalar end of a curve's VJP. knots (n, 8); q (n, 8) sums of
    [gc*x, -gc*min(x, j/8)]. Returns d knots (n, 8)."""
    csum, s, _, _ = _curve_coeffs(knots)
    cdiff = [q[:, j] * s for j in range(1, CURVE_STEPS)]        # j = 1..7
    ct_s = q[:, 7] * (knots[:, 7] - knots[:, 6])
    for j in range(CURVE_STEPS - 2, 0, -1):
        ct_s = ct_s + q[:, j] * (knots[:, j] - knots[:, j - 1])
    ct_s = ct_s + q[:, 0] * knots[:, 7]
    ct_csum = -((ct_s * (1.0 / (csum * csum))) * float(CURVE_STEPS))
    out = []
    for i in range(CURVE_STEPS):
        if i == CURVE_STEPS - 1:
            d = cdiff[i - 1] + q[:, 0] * s
        elif i == 0:
            d = -cdiff[0]
        else:
            d = -cdiff[i] + cdiff[i - 1]
        out.append(d + ct_csum)
    return torch.stack(out, dim=1)


def _shift(t, dy, dx):
    """out[y, x] = t[y - dy, x - dx], zero outside: `_shift_zero`."""
    if dy == 1:
        t = torch.cat([torch.zeros_like(t[:, :, :1]), t[:, :, :-1]], dim=2)
    elif dy == -1:
        t = torch.cat([t[:, :, 1:], torch.zeros_like(t[:, :, :1])], dim=2)
    if dx == 1:
        t = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], dim=3)
    elif dx == -1:
        t = torch.cat([t[..., 1:], torch.zeros_like(t[..., :1])], dim=3)
    return t


def _bwd_sharpness(x, g, p, m=None):
    p0 = _col(p, 0)[:, None]
    delta = 4.0 * x
    delta = delta - _shift(x, 1, 0) - _shift(x, -1, 0)
    delta = delta - _shift(x, 0, 1) - _shift(x, 0, -1)
    gc, direct = _blend_ct(x + p0 * delta, x, g, m)
    cd = gc * p0
    d = _plus(direct, gc)
    d = d - _shift(cd, 0, 1)            # cd[y, x-1]
    d = d - _shift(cd, 0, -1)           # cd[y, x+1]
    d = d - _shift(cd, 1, 0)            # cd[y-1, x]
    d = d - _shift(cd, -1, 0)           # cd[y+1, x]
    d = d + cd * 4.0
    return d, [gc * delta]


def _sum(t, dims):
    """Sum of f32 per-pixel quantities, taken in f64 and rounded to f32
    once (as the kernel does: the quantities cancel, and f32 sums in two
    orders would differ by more than the rounding of the result)."""
    return t.double().sum(dim=dims).float()


def _finish_scalar(q, n):
    out = q.new_zeros((n, MAX_PARAM))
    out[:, 0] = q[:, 0]
    return out


def _bwd_white(x, g, p, m):
    """Masked white: y = 1*m + x*(1-m) passes x its direct term only."""
    return _blend_ct(torch.ones_like(x), x, g, m)[1]


def fused_step_bwd_reference(imgs, op_slots, params, g, mask=None):
    """Plain PyTorch VJP of one chain step: imgs, g (B,3,H,W) f32,
    op_slots (B,) int (clamped into 0..8 as `lax.switch` does), params
    (B,24) f32, optional mask (B,1,H,W) -> (d_img (B,3,H,W), d_params
    (B,24)). Slots 0 and 5 pass g through and slot 8 (white) passes
    nothing, or with a mask gy*(1-m); both give zero d_params."""
    slots = op_slots.clamp(0, 8)
    d_img = torch.zeros_like(imgs)
    d_params = params.new_zeros((imgs.shape[0], MAX_PARAM))
    ident = (slots == 0) | (slots == 5)
    d_img[ident] = g[ident]
    if mask is not None:
        mask = mask.to(imgs.dtype)[:, 0]
    for slot in (1, 2, 3, 4, 6, 7, 8):
        sel = (slots == slot).nonzero()[:, 0]
        if sel.numel() == 0 or (slot == 8 and mask is None):
            continue
        x, gs, ps = imgs[sel], g[sel], params[sel]
        ms = None if mask is None else mask[sel]
        n = sel.numel()
        if slot == 8:
            d_img[sel] = _bwd_white(x, gs, ps, ms)
            continue
        if slot == 4:
            dimg, qs = _bwd_curve(x, gs, ps.reshape(n, 3, CURVE_STEPS), ms)
            q = torch.stack([_sum(t, (2, 3)) for t in qs], dim=2)
            dp = torch.cat([_curve_params(ps[:, 8 * c:8 * c + 8], q[:, c])
                            for c in range(3)], dim=1)
        elif slot == 6:
            dimg, qs = _bwd_curve(x, gs, ps[:, None, :CURVE_STEPS], ms)
            q = torch.stack([_sum(t, (1, 2, 3)) for t in qs], dim=1)
            dp = ps.new_zeros((n, MAX_PARAM))
            dp[:, :CURVE_STEPS] = _curve_params(ps[:, :CURVE_STEPS], q)
        else:
            fn = {1: _bwd_brightness, 2: _bwd_contrast, 3: _bwd_saturation,
                  7: _bwd_sharpness}[slot]
            dimg, qs = fn(x, gs, ps, ms)
            dims = tuple(range(1, qs[0].ndim))
            q = torch.stack([_sum(t, dims) for t in qs], dim=1)
            if slot == 2:
                q = (q[:, 0] - q[:, 1])[:, None]
            dp = _finish_scalar(q, n)
        d_img[sel] = dimg
        d_params[sel] = dp
    return d_img, d_params




# ---------------------------------------------------------------------------
# the pieces the actor's decode and training use
# ---------------------------------------------------------------------------

def vocab_to_slot(op_vocab_ids):
    """Decoder vocab ids -> chain slots (0 for <NONE>, <START>, <END>)."""
    return torch.where(op_vocab_ids < 3, torch.zeros_like(op_vocab_ids),
                       op_vocab_ids - 2)


_OPS_BY_SLOT = {1: brightness, 2: contrast, 3: saturation,
                4: lambda x, p: color_curve(x, p),
                6: lambda x, p: tone_curve(x, p[:, :8]),
                7: sharpness, 8: white}


def execute_selected(img, op_vocab_ids, chosen, mask=None):
    """Each image's selected op by the operator formulas, blended through
    `mask` and clamped; identity, <END> and inpaint leave it as it is.
    img (B, 3, H, W); op_vocab_ids (B,); chosen (B, 24) its parameters."""
    slots = vocab_to_slot(op_vocab_ids)
    out = img
    for slot, fn in _OPS_BY_SLOT.items():
        sel = slots == slot
        if not bool(sel.any()):
            continue
        y = torch.clamp(fn(img, chosen), -1e4, 1e4)
        y = mask_blend(y, img, mask)
        out = torch.where(sel.view(-1, 1, 1, 1), y, out)
    return out


def squash_params(raw, op_cfg):
    """Raw head features (B, 8, 24) -> each op's parameters, zero past
    its count. op_cfg: dict with brightness_range, saturation_range,
    sharpness_range."""
    b = raw.shape[0]
    x0 = raw[:, :, 0]
    br = tanh_range(-op_cfg["brightness_range"], op_cfg["brightness_range"],
                    initial=0.0)
    sat_lo, sat_hi = op_cfg["saturation_range"]

    def col(vec):
        z = raw.new_zeros((b, MAX_PARAM))
        z[:, 0] = vec
        return z

    sat = (torch.tanh(F.relu(x0[:, 2])) * sat_hi
           + torch.tanh(F.relu(-x0[:, 2])) * sat_lo)
    tone = raw.new_zeros((b, MAX_PARAM))
    tone[:, :8] = raw[:, 5, :8]
    cols = [col(br(x0[:, 0])), col(torch.tanh(x0[:, 1])), col(sat),
            raw[:, 3, :], raw.new_zeros((b, MAX_PARAM)), tone,
            col(torch.sigmoid(x0[:, 6]) * op_cfg["sharpness_range"]),
            col(torch.sigmoid(x0[:, 7]))]
    return torch.stack(cols, dim=1)


def chain_forward(imgs, op_slots, params, mask=None):
    """The chain as the kernels compute it: imgs (B, 3, H, W), op_slots
    (B, K), params (B, K, 24); in CHAIN_DTYPE, returned as float32."""
    t = CHAIN_DTYPE
    return fused_chain_reference(
        imgs.to(t), op_slots, params.to(t),
        None if mask is None else mask.to(t)).to(torch.float32)


def chain_step_vjp(imgs, op_slots, params, g, mask=None):
    """(d_img, d_params) of one chain step."""
    return fused_step_bwd_reference(imgs, op_slots, params, g, mask)


class ChainStep(torch.autograd.Function):
    """One differentiable chain step: forward `chain_forward` at K=1, and
    `chain_step_vjp` in float32 for its gradients (the mask gets none)."""

    @staticmethod
    def forward(ctx, imgs, op_slots, params, mask):
        ctx.save_for_backward(imgs, op_slots, params, mask)
        return chain_forward(imgs, op_slots[:, None], params[:, None], mask)

    @staticmethod
    def backward(ctx, g):
        imgs, op_slots, params, mask = ctx.saved_tensors
        d_img, d_params = chain_step_vjp(imgs, op_slots, params,
                                         g.contiguous(), mask)
        return d_img, None, d_params, None


def chain_step(imgs, op_slots, params, mask=None):
    if mask is not None:
        mask = mask.detach().to(imgs.dtype)
    return ChainStep.apply(imgs, op_slots.long(), params, mask)
