"""The differentiable single chain step of episode training.

`fused_step` replaces the Pallas `fused_step` of
`t2onet_tpu/ops/pallas_fused.py` (`_make_fused_step`): the forward is
`chain.fused_chain` at K=1 (kernel B1, or B2 with a mask, on a CUDA
tensor), the backward is `step_bwd`, which on a CUDA tensor launches the
hand-written kernel of `csrc/step_bwd.cu` (it replaces `_step_bwd_kernel`,
and with a mask `_masked_step_bwd_kernel`: B3 and B4) and on a CPU tensor
runs `fused_step_bwd_reference`, the same VJP written out in plain
PyTorch. Only the selected branch of each image is differentiated.

With a (B,1,H,W) mask m the step is clip(y, 0, 1), y = op(x)*m + x*(1-m):
with gy = g * clip'(y), the op's cotangent is gy*m, x also gets gy*(1-m)
directly (first, as JAX's reverse pass adds it), and the mask gets no
gradient. Masked white passes gy*(1-m); slots 0 and 5 are never blended.

The VJP is JAX's, tie rules included: clip(y, 0, 1) passes half the
cotangent at y == 0 or 1, a pairwise maximum or minimum splits a tie in
half (.25/.25/.5 over three equal channels), and the curves follow the
min form of the forward: at x == j/8 the knot's min() splits the tie, so
at x == 0 the curve's slope is S*p0/csum, as `fused_step` gives (twice
the bank's value there, `pallas_fused.py:500-503`).

d_params is the sum over all pixels of each image. Both versions first
reduce per-pixel quantities (one for the scalar ops, two for contrast,
eight per curve; f32 values summed in f64 and rounded once) and then turn
those sums into the 24 parameter gradients with the same f32 scalar
arithmetic, in the order JAX's reverse pass accumulates it. The kernel
does it in one launch (`plan` gives its cut): the last block of each
image to finish sums the image's block sums in block order, so a call
gives the same bits every time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from t2onet_tpu_torch.ops import build, chain
from t2onet_tpu_torch.ops.color import clip

MAX_PARAM = chain.MAX_PARAM
CURVE_STEPS = chain.CURVE_STEPS
TILE = 32                       # sharpness tile side; a pointwise run is
TILE_PIXELS = TILE * TILE       # as many pixels: 4 per thread of 256
NQ = 24                         # f64 sums per kernel block, at most
MAX_BATCH = 65535               # the grid's y limit
MIN_BLOCKS_PER_SM = 4           # the kernel's kMinBlocks (see plan)
_S = 1048576.0                  # 2^20, the saturation quotient's scaling
_SINPI_C = chain._SINPI_C


# ---------------------------------------------------------------------------
# the plain version: the VJP of each branch, written out
# ---------------------------------------------------------------------------

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
# the CUDA kernel
# ---------------------------------------------------------------------------

class StepPlan(NamedTuple):
    """How the kernel cuts one (b, 3, h, w) call (csrc/step_bwd.cu)."""
    tiles: int               # 32x32 tiles per image
    tiles_per_block: int     # a block's tiles, or 1,024-pixel runs
    blocks_per_image: int    # the grid is (blocks_per_image, b)
    vector: bool             # 16-byte loads and stores of the flat planes
    partials: int            # f64 scratch: NQ per block
    counters: int            # int32 counters, one per image

    @property
    def scratch_bytes(self):
        """One buffer per call: the f64 partials, then the counters (which
        the launch zeroes)."""
        return 8 * self.partials + 4 * self.counters


@functools.lru_cache(maxsize=256)
def plan(b, h, w, aligned=True, sms=132):
    """The kernel's decomposition, the counterpart of `chain.plan`.

    A block takes `tiles_per_block` 32x32 tiles of a sharpness image, or
    as many runs of 1,024 pixels of another image's flat planes: the
    largest of 4, 2 and 1 that still gives the grid MIN_BLOCKS_PER_SM
    blocks on each of the card's `sms` multiprocessors (more pixels per
    block spread each block's fixed cost, its sums and its count, thinner).
    MIN_BLOCKS_PER_SM is the kernel's `kMinBlocks` (its
    `__launch_bounds__`, how many blocks the registers let a SM hold): the
    two change together. The pointwise paths use 16-byte accesses when
    h*w % 4 == 0 and every tensor is 16-byte `aligned`."""
    tiles = -(-h // TILE) * -(-w // TILE)
    for tpb in (4, 2, 1):
        blocks = -(-tiles // tpb)
        if b * blocks >= MIN_BLOCKS_PER_SM * sms:
            break
    return StepPlan(tiles, tpb, blocks, aligned and (h * w) % 4 == 0,
                    b * blocks * NQ, b)


def _library():
    lib = build.library("step_bwd")
    if lib.t2o_step_bwd_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.t2o_step_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, p]
        lib.t2o_step_bwd_launch.restype = i
        lib.t2o_step_bwd_masked_launch.argtypes = [p, p, p, p, p, p, p, p, p,
                                                   i, i, i, i, i, i, p]
        lib.t2o_step_bwd_masked_launch.restype = i
    return lib


def _check(imgs, op_slots, params, g):
    for name, t in (("imgs", imgs), ("params", params), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"step_bwd wants float32 {name}, got {t.dtype}")
    if op_slots.dtype != torch.int32:
        raise TypeError(f"step_bwd wants int32 op_slots, got {op_slots.dtype}")
    if imgs.ndim != 4 or imgs.shape[1] != 3:
        raise ValueError(f"imgs must be (B, 3, H, W), got {tuple(imgs.shape)}")
    b, _, h, w = imgs.shape
    if tuple(g.shape) != tuple(imgs.shape):
        raise ValueError(f"g must be {tuple(imgs.shape)}, got "
                         f"{tuple(g.shape)}")
    if tuple(op_slots.shape) != (b,):
        raise ValueError(f"op_slots must be ({b},), got "
                         f"{tuple(op_slots.shape)}")
    if tuple(params.shape) != (b, MAX_PARAM):
        raise ValueError(f"params must be {(b, MAX_PARAM)}, got "
                         f"{tuple(params.shape)}")
    for name, t in (("imgs", imgs), ("op_slots", op_slots),
                    ("params", params), ("g", g)):
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, imgs on "
                             f"{imgs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > MAX_BATCH:
        raise ValueError(f"grid too large for batch {b}")


def step_bwd(imgs, op_slots, params, g, mask=None):
    """VJP of one chain step (see `fused_step_bwd_reference`): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if imgs.device.type == "cpu":
        return fused_step_bwd_reference(imgs, op_slots, params, g, mask)
    if imgs.device.type != "cuda":
        raise ValueError(f"step_bwd runs on cpu or cuda, not {imgs.device}")
    _check(imgs, op_slots, params, g)
    masked = mask is not None
    if masked:
        mask = mask.to(imgs.dtype)
        chain._check_mask(mask, imgs, "step_bwd")
    lib = _library()
    b, _, h, w = imgs.shape
    dev = imgs.device
    d_img = torch.empty_like(imgs)
    d_params = torch.empty((b, MAX_PARAM), dtype=torch.float32, device=dev)
    tensors = (imgs, g, d_img) + ((mask,) if masked else ())
    cut = plan(b, h, w, all(t.data_ptr() % 16 == 0 for t in tensors),
               build.sm_count(dev.index))
    # the call's own scratch (a CUDA graph captures it with the call, and
    # the launch's memset of the counters as a node of its own)
    scratch = torch.empty(cut.scratch_bytes, dtype=torch.uint8, device=dev)
    partials = scratch.data_ptr()
    ptrs = (op_slots.data_ptr(), params.data_ptr(), g.data_ptr(),
            d_img.data_ptr(), partials, partials + 8 * cut.partials,
            d_params.data_ptr(), b, h, w, cut.tiles_per_block,
            cut.blocks_per_image, int(cut.vector),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if masked:
            rc = lib.t2o_step_bwd_masked_launch(imgs.data_ptr(),
                                                mask.data_ptr(), *ptrs)
        else:
            rc = lib.t2o_step_bwd_launch(imgs.data_ptr(), *ptrs)
    if rc != 0:
        raise RuntimeError(f"step_bwd kernel launch failed: "
                           f"{lib.t2o_error_string(rc).decode()}")
    chain.LAUNCHES["step_bwd_masked" if masked else "step_bwd"] += 1
    return d_img, d_params


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

class _FusedStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, imgs, op_slots, params, mask):
        ctx.save_for_backward(imgs, op_slots, params, mask)
        return chain.fused_chain(imgs, op_slots[:, None].contiguous(),
                                 params[:, None].contiguous(), mask)

    @staticmethod
    def backward(ctx, g):
        want_img, _, want_params, _ = ctx.needs_input_grad
        if not (want_img or want_params):
            return None, None, None, None
        imgs, op_slots, params, mask = ctx.saved_tensors
        d_img, d_params = step_bwd(imgs, op_slots, params, g.contiguous(),
                                   mask)
        return (d_img if want_img else None, None,
                d_params if want_params else None, None)


def fused_step(imgs, op_slots, params, mask=None):
    """Differentiable single chain step (the episode rollout's execute).

    :param imgs: (B, 3, H, W) float32 in [0, 1].
    :param op_slots: (B,) int32 slot ids (0 identity, 1..8 executor + 1).
    :param params: (B, 24) float32 chosen parameter rows.
    :param mask: optional (B, 1, H, W) mask of the local edit (cast to
        imgs' dtype); it gets no gradient.
    :return: (B, 3, H, W) float32; gradients flow to imgs and params.
    """
    if mask is not None:
        mask = mask.detach().to(imgs.dtype).contiguous()
    return _FusedStep.apply(imgs.contiguous(), op_slots.to(torch.int32)
                            .contiguous(), params.contiguous(), mask)
