"""The executor bank (counterpart of `t2onet_tpu.ops.bank`).

Every op runs on the whole batch and a one-hot weight picks each image's
result, so a batch of mixed ops is one fixed-shape computation. The decode
stage executes through this bank; the native-resolution execute goes
through the chain kernel (`ops/chain.py`), which computes only the
selected op.

Op indexing: executor index 0..7 (order of OP_NAMES); a decoder vocab id
maps to it as `vocab_id - 3`, and ids < 3 (<NONE>/<START>/<END>) execute
as identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from t2onet_tpu_torch.ops import operators as O
from t2onet_tpu_torch.ops.color import tanh_range

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
    onehot = vocab_onehot(op_vocab_ids)
    return torch.einsum("bk,bkp->bp", onehot[:, 1:], params)


def execute_bank(img, op_vocab_ids, params, mask=None, inpaint_fn=None):
    """Execute a batch of mixed ops given by decoder vocab ids (B,).
    Returns (out_imgs (B,3,H,W), chosen_params (B, 24))."""
    onehot = vocab_onehot(op_vocab_ids)
    out = execute_onehot(img, onehot, params, mask, inpaint_fn)
    if params.ndim == 3:
        chosen = torch.einsum("bk,bkp->bp", onehot[:, 1:], params)
    else:
        chosen = params * (1.0 - onehot[:, 0:1])
    return out, chosen
