"""The operator chain: K steps of a selected op per image, in one pass.

`fused_chain` replaces the Pallas `fused_chain` of
`t2onet_tpu/ops/pallas_fused.py`: `_chain_kernel`, and with a mask
`_masked_chain_kernel` (GIER local edits). On a CUDA tensor it launches
the hand-written kernel in `csrc/chain.cu`; on a CPU tensor it runs
`fused_chain_reference`, the same function in plain PyTorch. There is no
fallback from one to the other: a CUDA call that cannot launch raises.

Slot ids (as in the JAX package): 0 identity, 1..8 = brightness,
contrast, saturation, color, inpaint (identity here), tone, sharpness,
white. Slots 0 and 5 leave the image as it is (no clamp); every other
step is `out = clip(op(out, params[b, k]), 0, 1)`, or with a (B,1,H,W)
mask m `clip(op(out)*m + out*(1-m), 0, 1)`. The maths follows
`pallas_fused.py` (not the bank): brightness with eps 1e-12, the
single-division saturation with its 2^20 scaling, the polynomial cos of
contrast, and the min-form curves. The kernel does each multiply and add
in the same order, rounded on its own, so the two agree bit for bit.
`plan` says how the kernel cuts a call: a flat path in registers for
images whose chain has no sharpness step, 32x32 tiles with a halo for the
others. Unmasked, a white step sets every pixel to 1 whatever its input,
so a chain with no sharpness step after its last white one runs only the
steps after it, on the flat path, and reads no input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from t2onet_tpu_torch.ops import build
from t2onet_tpu_torch.ops.color import clip

MAX_PARAM = 24
CURVE_STEPS = 8
TILE = 32                     # output tile side of the tile path; a flat
TILE_PIXELS = TILE * TILE     # run is as many pixels: 4 per thread of 256
THREADS = 256                 # a kernel block's threads
MAX_STEPS = 16                # the longest chain the kernel takes (kMaxSteps)
MAX_BATCH = 65535             # the grid's y limit
# The kernel's instantiations (chain.cu's launch): the tile path's pixels
# per thread, fixed at compile time, and the blocks per SM that its
# registers are held to (kMinBlocks: see plan).
INSTANCES = {5: 4, 7: 3, 9: 3, 16: 2}
WAVES = 2                     # the grid fills the card at least this often
SMEM_LIMIT = 232448           # shared memory one Hopper block can use

# Kernel launches by wrapper, incremented only where a kernel is launched
# ("step_bwd" and "step_bwd_masked" by ops/step.py:step_bwd).
LAUNCHES = {"chain": 0, "chain_masked": 0, "step_bwd": 0,
            "step_bwd_masked": 0}


# ---------------------------------------------------------------------------
# the plain version: one selected branch per image, torch.where over slots
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


def vocab_ops_to_slots(op_vocab_ids):
    """Decoder vocab ids (B, K) -> kernel slot ids (identity for ids < 3)."""
    exec_idx = op_vocab_ids - 3
    return torch.where(exec_idx < 0, torch.zeros_like(exec_idx),
                       exec_idx + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel: built at first use (ops/build.py), bound with ctypes
# ---------------------------------------------------------------------------

class ChainPlan(NamedTuple):
    """How the kernel cuts one (b, 3, h, w) call of a k-step chain
    (csrc/chain.cu)."""
    tiles_per_block: int     # a block's tiles, or 1,024-pixel runs
    blocks_per_image: int    # the grid is (blocks_per_image, b)
    vector: bool             # 16-byte loads and stores of the flat planes
    pixels_per_thread: int   # the tile path's, 0 when k > MAX_STEPS
    smem_bytes: int          # dynamic shared memory of a block


@functools.lru_cache(maxsize=256)
def plan(b, h, w, k, aligned=True, sms=132):
    """The kernel's decomposition, the counterpart of `step.plan`.

    A block takes `tiles_per_block` 32x32 tiles of an image whose chain
    has a sharpness step, or as many runs of 1,024 pixels of another
    image's flat planes: the largest of 4, 2 and 1 that still gives the
    grid WAVES times the blocks that the card's `sms` multiprocessors hold
    at once (more pixels per block spread each block's fixed cost, its
    params and curves, thinner; a second wave evens out blocks of unequal
    cost, flat against tile). The tile path holds a tile and its halo of
    up to k pixels, (32 + 2k)^2, in registers: `pixels_per_thread` is the
    smallest instantiation that holds them, which also fixes the blocks a
    multiprocessor holds (INSTANCES, the kernel's `__launch_bounds__`: the
    two change together). Its shared memory is one copy of the three
    planes for a sharpness step's neighbours, the same with a mask. The
    flat path uses 16-byte accesses when h*w % 4 == 0 and every tensor is
    16-byte `aligned`."""
    side = TILE + 2 * k
    need = -(-side * side // THREADS)
    npt = next((n for n in sorted(INSTANCES) if n >= need), 0)
    tiles = -(-h // TILE) * -(-w // TILE)
    for tpb in (4, 2, 1):
        blocks = -(-tiles // tpb)
        if b * blocks >= WAVES * INSTANCES.get(npt, 1) * sms:
            break
    return ChainPlan(tpb, blocks, aligned and (h * w) % 4 == 0, npt,
                     3 * side * side * 4)


# the longest chain's planes fit in a block's shared memory
assert plan(1, 1, 1, MAX_STEPS).smem_bytes <= SMEM_LIMIT


def _library():
    lib = build.library("chain")
    if lib.t2o_chain_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.t2o_chain_launch.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.t2o_chain_launch.restype = i
        lib.t2o_chain_masked_launch.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.t2o_chain_masked_launch.restype = i
    return lib


def _check_mask(mask, imgs, who):
    """A (B,1,H,W) float32 contiguous mask on imgs' device."""
    b, _, h, w = imgs.shape
    if mask.dtype != torch.float32:
        raise TypeError(f"{who} wants a float32 mask, got {mask.dtype}")
    if tuple(mask.shape) != (b, 1, h, w):
        raise ValueError(f"mask must be {(b, 1, h, w)}, got "
                         f"{tuple(mask.shape)}")
    if mask.device != imgs.device:
        raise ValueError(f"mask is on {mask.device}, imgs on {imgs.device}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")


def _check(imgs, op_slots, params):
    if imgs.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"fused_chain wants float32 imgs and params, got "
                        f"{imgs.dtype} and {params.dtype}")
    if op_slots.dtype != torch.int32:
        raise TypeError(f"fused_chain wants int32 op_slots, got "
                        f"{op_slots.dtype}")
    if imgs.ndim != 4 or imgs.shape[1] != 3:
        raise ValueError(f"imgs must be (B, 3, H, W), got {tuple(imgs.shape)}")
    b = imgs.shape[0]
    if op_slots.ndim != 2 or op_slots.shape[0] != b:
        raise ValueError(f"op_slots must be (B, K) with B={b}, got "
                         f"{tuple(op_slots.shape)}")
    k = op_slots.shape[1]
    if tuple(params.shape) != (b, k, MAX_PARAM):
        raise ValueError(f"params must be {(b, k, MAX_PARAM)}, got "
                         f"{tuple(params.shape)}")
    for name, t in (("imgs", imgs), ("op_slots", op_slots),
                    ("params", params)):
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, imgs on "
                             f"{imgs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k > MAX_STEPS:
        raise ValueError(f"the chain kernel takes at most {MAX_STEPS} steps, "
                         f"not {k}")
    if b > MAX_BATCH:
        raise ValueError(f"grid too large for batch {b}")


def fused_chain(imgs, op_slots, params, mask=None):
    """Apply per-image op chains.

    :param imgs: (B, 3, H, W) float32 in [0, 1].
    :param op_slots: (B, K) int32 slot ids. On a CUDA tensor K is at most
        MAX_STEPS (16, the tile path's largest instantiation): a longer
        chain raises before any launch (the JAX kernel has no limit; the
        default config decodes 5 steps, the GIER trainer's 8).
    :param params: (B, K, 24) float32.
    :param mask: optional (B, 1, H, W) in [0, 1]: each step's output is
        blended into the unedited region (the GIER local edits), cast to
        imgs' dtype as the JAX package casts it.
    :return: (B, 3, H, W) float32.
    """
    if imgs.device.type == "cpu":
        return fused_chain_reference(imgs, op_slots, params, mask)
    if imgs.device.type != "cuda":
        raise ValueError(f"fused_chain runs on cpu or cuda, not "
                         f"{imgs.device}")
    masked = mask is not None
    _check(imgs, op_slots, params)
    if masked:
        mask = mask.to(imgs.dtype)
        _check_mask(mask, imgs, "fused_chain")
    lib = _library()
    b, _, h, w = imgs.shape
    k = op_slots.shape[1]
    dev = imgs.device
    out = torch.empty_like(imgs)
    tensors = (imgs, out) + ((mask,) if masked else ())
    cut = plan(b, h, w, k, all(t.data_ptr() % 16 == 0 for t in tensors),
               build.sm_count(dev.index))
    ptrs = (op_slots.data_ptr(), params.data_ptr(), out.data_ptr(), b, h, w,
            k, cut.tiles_per_block, cut.blocks_per_image, int(cut.vector),
            cut.pixels_per_thread, cut.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if masked:
            rc = lib.t2o_chain_masked_launch(imgs.data_ptr(), mask.data_ptr(),
                                             *ptrs)
        else:
            rc = lib.t2o_chain_launch(imgs.data_ptr(), *ptrs)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: "
                           f"{lib.t2o_error_string(rc).decode()}")
    LAUNCHES["chain_masked" if masked else "chain"] += 1
    return out


def fused_chain_sharded(imgs, op_slots, params, mesh, mask=None):
    """`fused_chain` over a device mesh (counterpart of the JAX package's
    `fused_chain_sharded`): the batch cut into the mesh's contiguous row
    blocks, one `fused_chain` per shard on the shard's device (its
    current CUDA stream there), no collectives (op chains are per-image).
    The mesh's size must divide B.

    :param imgs, op_slots, params, mask: as `fused_chain`'s: tensors,
        whose shards are moved to their devices and whose results are
        gathered back in order on imgs' device; or lists of the shards,
        one per mesh entry and each on its device, and then the list of
        the shards' results comes back, each where it ran.
    :param mesh: `parallel.mesh.Mesh`, or a sequence of devices.
    """
    from t2onet_tpu_torch.parallel.mesh import as_mesh, shard_batch

    mesh = as_mesh(mesh)
    gather = isinstance(imgs, torch.Tensor)
    if gather:
        home = imgs.device
        imgs, op_slots, params, mask = (
            None if t is None else shard_batch(t, mesh)
            for t in (imgs, op_slots, params, mask))
    elif len(imgs) != mesh.size:
        raise ValueError(f"{len(imgs)} shards for a mesh of {mesh.size}")
    masks = [None] * mesh.size if mask is None else mask
    outs = [fused_chain(i, s, p, mask=m)
            for i, s, p, m in zip(imgs, op_slots, params, masks)]
    if not gather:
        return outs
    return torch.cat([o.to(home) for o in outs])
