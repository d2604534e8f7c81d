"""Reverse operations: undo an edit by fitting its inverse op
(counterpart of `t2onet_tpu.ops.reverse`).

`rev_ops_dict` pairs each op with its inverse family (brightness <->
brightness, blur <-> sharpness, contrast <-> contrast),
`get_param_naive` fits the parameter that maps one image to another (the
L2 norm of the residual, by multi-start Adam through the differentiable
op) and `get_reverse` composes the two.

The starts run as the rows of one batch on the image's device. Inputs
that are not tensors go to `device` (default "cuda", which raises where
PyTorch finds no card).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from t2onet_tpu_torch.ops import operators as O
from t2onet_tpu_torch.ops.color import clip
from t2onet_tpu_torch.planner.fit import adam_descent

rev_ops_dict = {"brightness": "brightness", "blur": "sharpness",
                "sharpness": "blur", "contrast": "contrast"}

LEAK = 0.05          # the clamp's slope outside [0, 1] while fitting


def _tensor(x, device=None):
    """x as an f32 tensor: a tensor stays on its device unless `device`
    names one; an array goes to `device`, default "cuda"."""
    if torch.is_tensor(x):
        return x if device is None else x.to(device)
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ops.reverse: PyTorch finds no CUDA card here; "
                           "pass device='cpu' or a CPU tensor")
    return torch.as_tensor(np.array(x, np.float32), device=device)


def apply_operator(img, mask, param, opname: str, device=None):
    """Apply op `opname` with `param` (a scalar or a list) to img
    (1, 3, H, W), then the mask blend and the clamp."""
    img = _tensor(img, device)
    p = torch.as_tensor(np.atleast_1d(np.asarray(param, np.float32)),
                        device=img.device)[None]
    if mask is not None:
        mask = _tensor(mask, img.device)
    return O.mask_blend(O.OP_FNS[opname](img, p), img, mask)


def _resid(fn, img, target, params, leak: float = 0.0):
    """Each start's L2 residual of op(img, p) against target, (S,). The
    gradient goes through a clamp of slope `leak` outside [0, 1] (the hard
    clamp's zero gradient strands every start on a plateau once the edit
    saturates); with leak 0 it is the hard clamp's residual."""
    x = img.expand(params.shape[0], -1, -1, -1)
    raw = fn(x, params)
    out = O.mask_blend(raw, x) + leak * (raw - clip(raw, 0.0, 1.0))
    return torch.sqrt(((out - target) ** 2).sum(dim=(1, 2, 3)) + 1e-12)


def _fit(img, target, inits, opname: str, n_iters: int = 300,
         lr: float = 0.05):
    """Adam from each start (S, k) on the leaky residuals' sum; returns
    (params (S, k), the hard clamp's residuals (S,))."""
    fn = O.OP_FNS[opname]
    params = adam_descent(lambda p: _resid(fn, img, target, p, LEAK).sum(),
                          inits, n_iters, lr)
    with torch.no_grad():
        return params, _resid(fn, img, target, params)


def get_param_naive(img, out, mask, param0, opname: str, n_starts: int = 4,
                    n_iters: int = 300, lr: float = 0.05, device=None
                    ) -> Tuple[List[float], bool]:
    """The parameter of `opname` that maps img to out: (params as a list,
    whether the best residual is within 5% of |out|).

    Starts: param0, half of it and zero (an op that clamps inside, as
    brightness's clip(v (1 + p)), has zero gradient everywhere near a
    param0 past its knee), then param0 plus N(0, 0.3) draws from numpy's
    default_rng(0), as the JAX package draws them."""
    del mask                      # every reverse path passes None
    p0 = np.atleast_1d(np.asarray(param0, np.float32))
    rng = np.random.default_rng(0)
    fixed = [p0, 0.5 * p0, np.zeros_like(p0)]
    noise = [p0 + rng.normal(0, 0.3, p0.shape).astype(np.float32)
             for _ in range(max(n_starts - len(fixed), 1))]
    img = _tensor(img, device)
    out = _tensor(out, img.device)
    inits = torch.as_tensor(np.stack(fixed + noise), device=img.device)
    params, resids = _fit(img, out, inits, opname, n_iters, lr)
    best = int(torch.argmin(resids))
    rel = float(resids[best]) / (float(torch.sqrt((out ** 2).sum())) + 1e-8)
    return list(params[best].cpu().numpy().astype(np.float64)), rel < 0.05


def get_rev_param0(param, opname: str):
    """The reverse op's first guess."""
    if opname in ("brightness", "contrast"):
        return [-param[0]]
    if opname in ("blur", "sharpness"):
        return list(param)
    raise NameError(opname)


def get_reverse(img, out, mask, param, opname: str, device=None):
    """Fit the inverse edit out -> img: (reverse params, reverse op
    name). Raises when the fit fails."""
    rev_opname = rev_ops_dict[opname]
    rev_param0 = get_rev_param0(param, opname)
    rev_param, ok = get_param_naive(out, img, mask, rev_param0, rev_opname,
                                    device=device)
    if not ok:
        raise AssertionError("the optimization for reverse operation failed!")
    return rev_param, rev_opname
