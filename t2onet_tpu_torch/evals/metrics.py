"""Image quality metrics: L1, SSIM and the Frechet distance of FID
(counterpart of `t2onet_tpu.evals.metrics`, the reference's eval
protocol).

SSIM runs on the tensors' device as depthwise convolutions with an
11-px Gaussian window (sigma 1.5), zero-padded 'same', its statistics in
f64; `ssim_np` is the same formula on the host (scipy, f64), for
native-resolution eval where every sample has its own shape. The
Frechet distance is host numpy/scipy; FID's features come from a
`features_fn` (`evals.inception`).
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# 10 canonical requests for the output-variance probe (reference eval.py:11)
TEST_TXTS = [
    "increase the brightness", "decrease the brightness", "enhance the color",
    "decrease the color", "improve contrast", "reduce contrast",
    "increase saturation", "reduce saturation",
    "increase the brightness a little", "increase the brightness a lot",
]


def l1_distance(a, b):
    """Mean absolute distance."""
    return (a - b).abs().mean()


def _gaussian(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2)
                           / (2.0 * sigma ** 2)) for x in range(window_size)],
                 np.float32)
    return g / g.sum()


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = _gaussian(window_size, sigma)
    return np.outer(g, g)


def _depthwise_same(img, g):
    """(B, C, H, W) depthwise 'same' convolution, zero padding, with the
    window outer(g, g), taken as its two 1-D passes."""
    c, k = img.shape[1], g.shape[0]
    rows = F.conv2d(img, g.view(1, 1, 1, k).expand(c, 1, 1, k),
                    padding=(0, k // 2), groups=c)
    return F.conv2d(rows, g.view(1, 1, k, 1).expand(c, 1, k, 1),
                    padding=(k // 2, 0), groups=c)


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """SSIM with a Gaussian window over (B, C, H, W) tensors, the image
    borders zero-padded (reference utils/ssim/__init__.py:20-66), in the
    input's dtype. size_average: the mean over everything, else one value
    per image.

    The statistics are computed in f64, the window's two 1-D passes in
    turn: the variances E[x^2] - mu^2 cancel, so one f32 rounding of a
    convolution moves them far. With oneDNN's f32 depthwise convolution
    (PyTorch on the CPU) the mean over a 600 x 600 FiveK pair moved by up
    to 4.9e-5, where XLA's f32 convolution in the JAX package stays
    within 2.5e-6 of f64."""
    dtype = img1.dtype
    img1, img2 = img1.double(), img2.double()
    window = torch.as_tensor(_gaussian(window_size), dtype=torch.float64,
                             device=img1.device)
    mu1 = _depthwise_same(img1, window)
    mu2 = _depthwise_same(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_same(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_same(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_same(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean().to(dtype)
    return ssim_map.mean(dim=(1, 2, 3)).to(dtype)


def ssim_np(img1: np.ndarray, img2: np.ndarray, window_size: int = 11
            ) -> float:
    """SSIM on the host (scipy fftconvolve in f64, zero-padded 'same'):
    the formula of `ssim`, for native-resolution eval."""
    from scipy.signal import fftconvolve

    w = _gaussian_window(window_size).astype(np.float64)

    def conv(x):
        return np.stack([
            np.stack([fftconvolve(x[b, c], w, mode="same")
                      for c in range(x.shape[1])])
            for b in range(x.shape[0])])

    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    mu1, mu2 = conv(img1), conv(img2)
    s1 = conv(img1 * img1) - mu1 ** 2
    s2 = conv(img2 * img2) - mu2 ** 2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    return float(m.mean())


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6
                               ) -> float:
    """Frechet distance between two Gaussians (reference
    fid_score.py:159-230), with the eps-offset retry and the check on the
    imaginary part."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # a singular product must reach the eps-offset retry silently, not
    # warn (or raise under -W error) before isfinite() sees the NaNs
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", linalg.LinAlgWarning)
            covmean = linalg.sqrtm(sigma1.dot(sigma2))
    except linalg.LinAlgError:
        covmean = np.full_like(sigma1, np.nan)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


class ImageEvaluator:
    """Running means of L1 and SSIM, input and output each against the
    ground truth, and with `features_fn` the corpus FID of the inputs and
    of the outputs against the ground truths (reference eval.py:13-90).
    With host_metrics the images are numpy and SSIM is `ssim_np`; else
    they are tensors (numpy is taken as CPU tensors) and SSIM is `ssim`
    on their device.

    :param features_fn: (N, 3, H, W) -> (N, D) numpy features for FID
        (`evals.inception.load_fid_inception`), or None for no FID."""

    def __init__(self, window_size: int = 11, host_metrics: bool = False,
                 features_fn: Optional[Callable] = None):
        self.window_size = window_size
        self.host_metrics = host_metrics
        self.features_fn = features_fn
        self.reset()

    def reset(self):
        self.itr = 0
        self.avg_out_L1 = 0.0
        self.avg_in_L1 = 0.0
        self.avg_out_SSIM = 0.0
        self.avg_in_SSIM = 0.0
        self.arrs_in: List[np.ndarray] = []
        self.arrs_out: List[np.ndarray] = []
        self.arrs_gt: List[np.ndarray] = []

    def update(self, inp, out, gt) -> dict:
        """inp, out, gt: (1, 3, H, W) in [0, 1]. Returns this pair's
        in_L1, out_L1, in_SSIM and out_SSIM."""
        self.itr += 1
        r = 1.0 / self.itr
        if self.host_metrics:
            inp, out, gt = (np.asarray(v.cpu() if torch.is_tensor(v) else v)
                            for v in (inp, out, gt))
            in_l1 = float(np.abs(inp - gt).mean())
            out_l1 = float(np.abs(out - gt).mean())
            in_ss = ssim_np(inp, gt, self.window_size)
            out_ss = ssim_np(out, gt, self.window_size)
        else:
            inp, out, gt = (torch.as_tensor(v) for v in (inp, out, gt))
            in_l1 = float(l1_distance(inp, gt))
            out_l1 = float(l1_distance(out, gt))
            in_ss = float(ssim(inp, gt, self.window_size))
            out_ss = float(ssim(out, gt, self.window_size))
        self.avg_in_L1 += (in_l1 - self.avg_in_L1) * r
        self.avg_out_L1 += (out_l1 - self.avg_out_L1) * r
        self.avg_in_SSIM += (in_ss - self.avg_in_SSIM) * r
        self.avg_out_SSIM += (out_ss - self.avg_out_SSIM) * r
        m = {"in_L1": in_l1, "out_L1": out_l1, "in_SSIM": in_ss,
             "out_SSIM": out_ss}
        if self.features_fn is not None:
            t0 = time.perf_counter()
            self.arrs_in.append(np.asarray(self.features_fn(inp)))
            self.arrs_out.append(np.asarray(self.features_fn(out)))
            self.arrs_gt.append(np.asarray(self.features_fn(gt)))
            m["features_s"] = time.perf_counter() - t0
        return m

    def calc_fid(self):
        """(FID of the inputs, FID of the outputs), each against the
        ground truths' features; (None, None) without features."""
        if not self.arrs_gt:
            return None, None
        stats = [(a.mean(0), np.cov(a, rowvar=False)) for a in
                 (np.concatenate(arrs, 0) for arrs in
                  (self.arrs_in, self.arrs_out, self.arrs_gt))]
        return (calculate_frechet_distance(*stats[0], *stats[2]),
                calculate_frechet_distance(*stats[1], *stats[2]))

    def eval(self) -> dict:
        res = {
            "in_L1": self.avg_in_L1, "out_L1": self.avg_out_L1,
            "in_SSIM": self.avg_in_SSIM, "out_SSIM": self.avg_out_SSIM,
        }
        print(f"input L1 dist {res['in_L1']:.4f}, "
              f"output L1 dist {res['out_L1']:.4f}")
        print(f"input SSIM {res['in_SSIM']:.4f}, "
              f"output SSIM {res['out_SSIM']:.4f}")
        fid_in, fid_out = self.calc_fid()
        if fid_in is not None:
            res["in_FID"], res["out_FID"] = fid_in, fid_out
            print(f"input FID {fid_in:.4f}, output FID {fid_out:.4f}")
        return res
