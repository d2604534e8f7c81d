"""The executor's eight editing operators and the five extras (exposure,
bnw, blur, hue, white balance) as functions on tensors (counterpart of
`t2onet_tpu.ops.operators`, same formulas and order of arithmetic). Each
maps (img (B,3,H,W), param (B,k)) -> img; masking and the final clamp
are `mask_blend`. `OP_FNS` names all thirteen."""

from __future__ import annotations

import math

import numpy as np
import torch

from t2onet_tpu_torch.ops.color import (clip, hsv_to_rgb, lerp, rgb2lum,
                                     rgb_to_hsv)

OP_NAMES = (
    "brightness",
    "contrast",
    "saturation",
    "color",
    "inpaint",
    "tone",
    "sharpness",
    "white",
)
PARAM_COUNTS = (1, 1, 1, 24, 1, 8, 1, 1)

CURVE_STEPS = 8


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


def inpaint(img, param, inpaint_fn=None):
    """Inpainting slot: a pluggable backend, identity without one."""
    del param
    if inpaint_fn is not None:
        return inpaint_fn(img)
    return img


# ---------------------------------------------------------------------------
# the extras (the reverse fits, the sweeps)
# ---------------------------------------------------------------------------

def exposure(img, param):
    """img * 2^p, as exp(p log 2) (exp2 differs in the last ulp)."""
    return img * torch.exp(_s(param) * torch.log(img.new_tensor(2.0)))


def bnw(img, param):
    """Desaturate toward luminance."""
    return lerp(img, rgb2lum(img), _s(param))


def _gauss3x3_sigma2():
    """The normalised 3x3 Gaussian of sigma 2, built in f32 numpy."""
    coords = np.arange(3, dtype=np.float32)
    g = np.exp(-((coords - 1.0) ** 2) / (2.0 * 4.0))
    k = np.outer(g, g)
    return k / k.sum()


_GAUSS3 = _gauss3x3_sigma2()


def blur(img, param):
    """lerp(img, gauss3x3_sigma2(img), p)."""
    return lerp(img, _conv3x3_same(img, _GAUSS3), _s(param))


def hue(img, param):
    """Replace the hue with p (h in [0, 1))."""
    _, s, v = rgb_to_hsv(img)
    return hsv_to_rgb(_s(param).expand_as(s), s, v)


def white_balance(img, param):
    """Per-channel gains; param (B, 3)."""
    return img * param[:, :, None, None]


# name -> fn, for the reverse fits, the sweeps and the planner
OP_FNS = {
    "brightness": brightness,
    "contrast": contrast,
    "saturation": saturation,
    "color": color_curve,
    "inpaint": inpaint,
    "tone": tone_curve,
    "sharpness": sharpness,
    "white": white,
    "exposure": exposure,
    "bnw": bnw,
    "blur": blur,
    "hue": hue,
    "whitebalance": white_balance,
}


def apply_op_by_index(img, op_index: int, param, mask=None,
                      inpaint_fn=None):
    """Apply executor op `op_index` with masking and the clamp; a negative
    index is the identity of the special tokens, and the inpaint slot runs
    `inpaint_fn` (identity without one)."""
    if op_index < 0:
        return img
    name = OP_NAMES[op_index]
    if name == "inpaint":
        return mask_blend(inpaint(img, param, inpaint_fn), img, mask)
    return mask_blend(OP_FNS[name](img, param), img, mask)
