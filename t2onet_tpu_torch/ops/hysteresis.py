"""Canny's hysteresis: the weak pixels 4-connected, through weak pixels, to
a strong one (scipy.ndimage.label's default structure), per image.

`hysteresis(cls)` takes a (B, H, W) uint8 map of classes (0 none, 1
weak, 2 strong: a strong pixel is weak too) and returns the (B, H, W)
bool edge map. On a CUDA tensor it launches the kernel of
`csrc/hysteresis.cu` (union-find; four launches, no read back to the
host), on a CPU tensor it runs `hysteresis_reference`, a flood fill from
the strong pixels repeated until it stops growing. `LAUNCHES` counts the
kernel's calls.
"""

from __future__ import annotations

import ctypes

import torch

from t2onet_tpu_torch.ops import build

LAUNCHES = {"hysteresis": 0}


def hysteresis_reference(cls):
    """The plain version: grow the strong pixels into their weak
    4-neighbours until nothing changes."""
    weak = cls > 0
    reach = cls == 2
    while True:
        grown = reach.clone()
        grown[:, 1:] |= reach[:, :-1]
        grown[:, :-1] |= reach[:, 1:]
        grown[:, :, 1:] |= reach[:, :, :-1]
        grown[:, :, :-1] |= reach[:, :, 1:]
        grown &= weak
        if torch.equal(grown, reach):
            return reach
        reach = grown


def _library():
    lib = build.library("hysteresis")
    if lib.t2o_hysteresis_launch.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.t2o_hysteresis_launch.argtypes = [p, p, p, i, i, i, p]
        lib.t2o_hysteresis_launch.restype = i
    return lib


def hysteresis(cls):
    """(B, H, W) uint8 classes -> (B, H, W) bool edges."""
    if cls.dtype != torch.uint8 or cls.ndim != 3:
        raise ValueError(f"hysteresis wants (B, H, W) uint8 classes, got "
                         f"{tuple(cls.shape)} {cls.dtype}")
    if cls.device.type == "cpu":
        return hysteresis_reference(cls)
    if cls.device.type != "cuda":
        raise ValueError(f"hysteresis runs on cpu or cuda, not {cls.device}")
    if not cls.is_contiguous():
        raise ValueError("classes must be contiguous")
    b, h, w = cls.shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b * h * w} pixels: the labels are int32")
    lib = _library()
    dev = cls.device
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.t2o_hysteresis_launch(
            cls.data_ptr(), labels.data_ptr(), out.data_ptr(), b, h, w,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hysteresis kernel launch failed: "
                           f"{lib.t2o_error_string(rc).decode()}")
    LAUNCHES["hysteresis"] += 1
    return out.bool()
