"""The executor bank (counterpart of `t2onet_tpu.ops.bank`).

Every op runs on the whole batch and a one-hot weight picks each image's
result, so a batch of mixed ops is one fixed-shape computation. The decode
stage executes through this bank; the native-resolution execute goes
through the chain kernel (`ops/chain.py`), which computes only the
selected op.

Op indexing: executor index 0..7 (order of OP_NAMES); a decoder vocab id
maps to it as `vocab_id - 3`, and ids < 3 (<NONE>/<START>/<END>) execute
as identity.

The parameter modes: exploration noise on the predicted parameters
(`add_param_noise`) and the discrete (classification) mode
(`discrete_param_grid`, `gt_param_bins`, `select_discrete_params`). Their
random draws come from a `torch.Generator`, or are fed in as tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from t2onet_tpu_torch.ops import operators as O
from t2onet_tpu_torch.ops.color import clip, tanh_range

N_OPS = 8
MAX_PARAM = 24
VOCAB_OFFSET = 3


def raw_head_features(w1, b1, w2, b2, context):
    """All-op parameter heads: context (B, ctx) -> raw (B, N_OPS, 24).

    w1 (N_OPS, ctx, fc), b1 (N_OPS, fc), w2 (N_OPS, fc, 24) zero-padded
    past each op's parameter count, b2 (N_OPS, 24)."""
    h = torch.einsum("bc,ocf->obf", context, w1) + b1[:, None]
    h = F.leaky_relu(h, negative_slope=0.01)
    out = torch.einsum("obf,ofp->obp", h, w2) + b2[:, None]
    return out.permute(1, 0, 2)


def squash_params(raw, cfg):
    """Each op's output squashing on its slice of the raw features;
    entries past each op's parameter count are zero. cfg: OperatorConfig."""
    b = raw.shape[0]
    x0 = raw[:, :, 0]
    br = tanh_range(-cfg.brightness_range, cfg.brightness_range, initial=0.0)
    sat_lo, sat_hi = cfg.saturation_range

    def col(vec):
        z = raw.new_zeros((b, MAX_PARAM))
        z[:, 0] = vec
        return z

    sat = (torch.tanh(F.relu(x0[:, 2])) * sat_hi
           + torch.tanh(F.relu(-x0[:, 2])) * sat_lo)
    tone = raw.new_zeros((b, MAX_PARAM))
    tone[:, :8] = raw[:, 5, :8]
    cols = [
        col(br(x0[:, 0])),                                   # brightness
        col(torch.tanh(x0[:, 1])),                           # contrast
        col(sat),                                            # saturation
        raw[:, 3, :],                                        # color: raw 24
        raw.new_zeros((b, MAX_PARAM)),                       # inpaint
        tone,                                                # tone: raw 8
        col(torch.sigmoid(x0[:, 6]) * cfg.sharpness_range),  # sharpness
        col(torch.sigmoid(x0[:, 7])),                        # white
    ]
    return torch.stack(cols, dim=1)


def param_ranges(cfg):
    """Per-op (ub, lb, initial) f32 arrays in executor order."""
    ub = np.asarray([cfg.brightness_range, 1.0, cfg.saturation_range[1],
                     cfg.color_curve_range[1], 0.0, cfg.tone_curve_range[1],
                     cfg.sharpness_range, 1.0], np.float32)
    lb = np.asarray([-cfg.brightness_range, -1.0, cfg.saturation_range[0],
                     cfg.color_curve_range[0], 0.0, cfg.tone_curve_range[0],
                     0.0, 0.0], np.float32)
    initial = np.asarray(
        [0.0, 0.0, 0.0,
         (cfg.color_curve_range[0] + cfg.color_curve_range[1]) / 2, 0.0,
         (cfg.tone_curve_range[0] + cfg.tone_curve_range[1]) / 2,
         cfg.sharpness_range / 2, 0.5], np.float32)
    return ub, lb, initial


def _param_valid_mask():
    """(N_OPS, MAX_PARAM): 1 where column j is a real parameter of op i."""
    m = np.zeros((N_OPS, MAX_PARAM), np.float32)
    for i, k in enumerate(O.PARAM_COUNTS):
        m[i, :k] = 1.0
    return m


def add_param_noise(params, cfg, factor: float = 0.6, generator=None,
                    normal=None):
    """Exploration noise on predicted parameters: standard-normal draws
    scaled so that +3 sigma spans `factor` of (initial..ub) and -3 sigma
    `factor` of (lb..initial), then clamped to [lb, ub]; padding columns
    stay as they are. The negative branch subtracts (the JAX package's
    two-sided sign; the reference adds both terms, so its noise only ever
    pushes parameters up).

    :param params: (B, N_OPS, 24) squashed per-op params.
    :param generator: torch.Generator on params' device for the draws,
        unless `normal` (a (B, N_OPS, 24) tensor of standard-normal draws)
        is fed in.
    """
    if normal is None:
        if generator is None:
            raise ValueError("add_param_noise needs a generator or fed "
                             "normal draws")
        normal = torch.randn(params.shape, generator=generator,
                             device=params.device, dtype=params.dtype)
    ub, lb, initial = (torch.as_tensor(v, device=params.device)[None, :, None]
                       for v in param_ranges(cfg))
    scaled = (F.relu(normal) * (ub - initial)
              - F.relu(-normal) * (initial - lb)) / 3.0 * factor
    noised = clip(params + scaled, lb, ub)
    valid = torch.as_tensor(_param_valid_mask(), device=params.device)[None]
    return torch.where(valid > 0, noised, params)


def discrete_param_grid(cfg, num: int = 10):
    """Candidate values per op for the discrete mode: a range starting at
    0 takes linspace(0, ub, num + 1) without the 0, a symmetric range
    linspace(lb, ub, num + 1) without its middle 0. Ops with several
    parameters, the (0, 0) inpaint range and saturation's asymmetric
    range are unsupported and keep the regression output.
    Returns (grid (N_OPS, num) f32, supported (N_OPS,) bool)."""
    ub, lb, _ = param_ranges(cfg)
    grid = np.zeros((N_OPS, num), np.float32)
    supported = np.zeros((N_OPS,), bool)
    for i in range(N_OPS):
        if O.PARAM_COUNTS[i] != 1 or (ub[i] == 0 and lb[i] == 0):
            continue
        if lb[i] == 0:
            grid[i] = np.delete(np.linspace(0, ub[i], num + 1), 0)
        elif lb[i] == -ub[i]:
            grid[i] = np.delete(np.linspace(lb[i], ub[i], num + 1), num // 2)
        else:
            continue
        supported[i] = True
    return grid, supported


_GRIDS = {}              # discrete_param_grid's tensors by device, made once


def device_grid(cfg, num: int, device):
    """`discrete_param_grid(cfg, num)` as tensors on `device`, made there
    once, outside inference mode, so that a training step can save them
    for its backward after serving made them; never written in place.
    Copying them from pageable host memory on every call would be a
    host-to-device copy that a CUDA graph's capture forbids."""
    key = (torch.device(device), cfg, num)
    got = _GRIDS.get(key)
    if got is None:
        grid, supported = discrete_param_grid(cfg, num)
        with torch.inference_mode(False):
            got = (torch.as_tensor(grid, device=key[0]),
                   torch.as_tensor(supported, device=key[0]))
        _GRIDS[key] = got
    return got


def gt_param_bins(gt_scalar, op_exec_idx, cfg, num: int = 10):
    """The nearest grid bin of each ground-truth scalar under its op's
    grid (the first of equally near bins). Returns (bins, supported):
    entries of special tokens (index < 0) and of unsupported ops are
    unsupported."""
    grid, supported = device_grid(cfg, num, gt_scalar.device)
    idx = torch.clamp(op_exec_idx, 0, N_OPS - 1).long()
    d = (grid[idx] - gt_scalar[..., None]).abs()
    bins = torch.argmin(d, dim=-1)
    sup = supported[idx] & (op_exec_idx >= 0)
    return bins, sup


def select_discrete_params(raw, cont_params, sample: bool,
                           explore_prob: float, cfg, num: int = 10,
                           generator=None, gumbel=None):
    """The discrete mode's parameters. The first `num` columns of each
    op's raw head output are bin logits, and the value is the chosen
    bin's grid entry: the argmax, or with `sample` a Gumbel-max draw over
    log(probs + 1e-30) of the softmax smoothed with explore_prob / num,
    as `jax.random.categorical` draws. Unsupported ops keep
    `cont_params`.

    :param raw: (B, N_OPS, 24) pre-squash head features.
    :param cont_params: (B, N_OPS, 24) regression params.
    :param generator: torch.Generator for the draw (sample=True), unless
        `gumbel` ((B, N_OPS, num) standard Gumbel draws) is fed in.
    :return: (params (B, N_OPS, 24), bin log-probs (B, N_OPS, num)).
    """
    grid, supported = device_grid(cfg, num, raw.device)
    dev = raw.device
    logp = F.log_softmax(raw[:, :, :num], dim=-1)
    if sample:
        probs = torch.exp(logp) * (1.0 - explore_prob) + explore_prob / num
        probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-30)
        if gumbel is None:
            if generator is None:
                raise ValueError("a sampled discrete draw needs a "
                                 "generator or fed Gumbel draws")
            gumbel = gumbel_noise(probs.shape, generator)
        ind = torch.argmax(gumbel + torch.log(probs.detach() + 1e-30), dim=-1)
    else:
        ind = torch.argmax(logp, dim=-1)
    vals = grid[torch.arange(N_OPS, device=dev)[None], ind]  # (B, N_OPS)
    disc = torch.zeros_like(cont_params)
    disc[:, :, 0] = vals
    sup = supported[None, :, None]
    return torch.where(sup, disc, cont_params), logp


def gumbel_noise(shape, generator: torch.Generator):
    """Standard Gumbel draws on the generator's device, as
    `jax.random.gumbel`: -log(-log(u)), u uniform on [tiny, 1). torch's
    generators give other numbers than JAX's keys from the same seed."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


def execute_onehot(img, onehot, params, mask=None, inpaint_fn=None):
    """Execute a (possibly different) op per image.

    :param onehot: (B, N_OPS + 1): slot 0 identity, slots 1..8 ops 0..7.
    :param params: (B, N_OPS, 24) per-op rows, or (B, 24) one shared row.
    :param mask: (B, 1|3, H, W) or None.
    """
    per_op = params.ndim == 3

    def p(i):
        return params[:, i] if per_op else params

    # A wide finite guard keeps inf from an unselected branch (a near-zero
    # curve sum) out of the one-hot blend; blend, THEN clamp.
    def g(x):
        return torch.clamp(x, -1e4, 1e4)

    outs = [
        img,
        g(O.brightness(img, p(0))),
        g(O.contrast(img, p(1))),
        g(O.saturation(img, p(2))),
        g(O.color_curve(img, p(3))),
        g(O.inpaint(img, p(4), inpaint_fn)),
        g(O.tone_curve(img, p(5)[:, :8])),
        g(O.sharpness(img, p(6))),
        O.white(img, p(7)),
    ]
    stacked = torch.stack(outs, dim=1)                # (B, 9, 3, H, W)
    blended = torch.einsum("bk,bkchw->bchw", onehot, stacked)
    out = O.mask_blend(blended, img, mask)
    # the identity slot returns the input untouched (no clamp)
    return torch.where(onehot[:, 0:1, None, None] > 0.5, img, out)


def vocab_onehot(op_vocab_ids):
    """Decoder op-vocab ids (B,) -> execute_onehot weights (B, N_OPS+1)."""
    exec_idx = op_vocab_ids - VOCAB_OFFSET
    slot = torch.where(exec_idx < 0, torch.zeros_like(exec_idx), exec_idx + 1)
    return F.one_hot(slot.long(), N_OPS + 1).to(torch.float32)


def select_params(op_vocab_ids, params):
    """Chosen (padded) parameter row per image: (B,), (B, N_OPS, 24) ->
    (B, 24); zeros for special tokens."""
    onehot = vocab_onehot(op_vocab_ids).to(params.dtype)
    return torch.einsum("bk,bkp->bp", onehot[:, 1:], params)


def execute_bank(img, op_vocab_ids, params, mask=None, inpaint_fn=None):
    """Execute a batch of mixed ops given by decoder vocab ids (B,).
    Returns (out_imgs (B,3,H,W), chosen_params (B, 24))."""
    onehot = vocab_onehot(op_vocab_ids).to(img.dtype)
    out = execute_onehot(img, onehot, params, mask, inpaint_fn)
    if params.ndim == 3:
        chosen = torch.einsum("bk,bkp->bp", onehot[:, 1:], params)
    else:
        chosen = params * (1.0 - onehot[:, 0:1])
    return out, chosen
