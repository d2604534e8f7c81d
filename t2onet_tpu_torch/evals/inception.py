"""InceptionV3 pool3 features for FID (counterpart of
`t2onet_tpu.evals.inception`; reference utils/FID/inception.py and
fid_score.py:138-156): a bilinear resize to 299, [-1, 1], the backbone
up to its final 2048-d average pool.

The modules keep torchvision's `inception_v3` names, so a torchvision
or pytorch-fid (pt_inception-2015-12-05) state_dict loads by its own
keys (fc and AuxLogits dropped); nothing here imports torchvision.
BatchNorm always runs on its running statistics (eps 1e-3). No
pretrained weights ship with the repository: `make_random_inception_pth`
writes random ones in that layout, which drive the FID path end to end
but give FIDs that compare with no published number.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _branch_pool(x, mode: str):
    """The 3x3 stride-1 branch pool in its three flavours: 'avg_tv'
    (torchvision, the zero pad counted), 'avg_tf' (pytorch-fid's
    FIDInceptionA/C/E_1, the pad not counted) and 'max' (pytorch-fid's
    FIDInceptionE_2, Mixed_7c)."""
    if mode == "max":
        return F.max_pool2d(x, 3, 1, 1)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=mode == "avg_tv")


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, pool_mode="avg_tv"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_branch_pool(x, self.pool_mode))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int, pool_mode="avg_tv"):
        super().__init__()
        c7 = channels_7x7
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_branch_pool(x, self.pool_mode))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode="avg_tv"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = self.branch_pool(_branch_pool(x, self.pool_mode))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """The backbone up to the final 2048-d average pool (no fc, no aux):
    NCHW -> (B, 2048).

    fid_variant=True is pytorch-fid's patched `fid_inception_v3`, the
    reference's default FID protocol (use_fid_inception=True): branch
    average pools that do not count the pad in Mixed_5b-d, 6b-e and 7b,
    and a max branch pool in Mixed_7c. False is torchvision's
    inception_v3. The weights are the same in both."""

    def __init__(self, fid_variant: bool = False):
        super().__init__()
        avg = "avg_tf" if fid_variant else "avg_tv"
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, avg)
        self.Mixed_5c = InceptionA(256, 64, avg)
        self.Mixed_5d = InceptionA(288, 64, avg)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, avg)
        self.Mixed_6c = InceptionC(768, 160, avg)
        self.Mixed_6d = InceptionC(768, 160, avg)
        self.Mixed_6e = InceptionC(768, 192, avg)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, avg)
        self.Mixed_7c = InceptionE(2048, "max" if fid_variant else "avg_tv")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def torchvision_inception_features(sd: Dict) -> Dict:
    """A torchvision inception_v3 state_dict -> this module's: the fc and
    AuxLogits entries dropped."""
    return {k: v for k, v in sd.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")}


def make_features_fn(model: InceptionV3Features, resize: bool = True,
                     normalize: bool = True):
    """The (N, 3, H, W) [0, 1] -> (N, 2048) extractor `ImageEvaluator`
    takes: a bilinear resize to 299 (align_corners=False and no
    antialias, pytorch-fid's F.interpolate), then [-1, 1]. Images come as
    numpy or tensors, run on the model's device; the features come back
    as f32 numpy."""
    model.eval()
    device = next(model.parameters()).device

    @torch.no_grad()
    def features(imgs):
        x = torch.as_tensor(np.asarray(imgs.cpu() if torch.is_tensor(imgs)
                                       else imgs), dtype=torch.float32)
        x = x.to(device)
        if resize and tuple(x.shape[-2:]) != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
        if normalize:
            x = 2.0 * x - 1.0
        return model(x).cpu().numpy()

    return features


@torch.no_grad()
def make_random_inception_pth(path: str, seed: int = 0) -> None:
    """Write a random InceptionV3 `.pth` under torchvision's names: each
    conv kernel normal with variance 2 / fan_in, BatchNorm weight 1,
    bias 0, mean 0, var 1. It stands in for the pretrained pt_inception
    weights, which the repository does not hold. (The JAX package's
    writer draws variance 1 / fan_in, which the ReLUs halve layer by
    layer: its pool3 features come out ~1e-4, and FIDs near 0; these are
    ~0.2.)"""
    model = InceptionV3Features()
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * math.sqrt(2.0 / fan_in))
    torch.save(model.state_dict(), path)


def load_fid_inception(path: str, device, fid_variant: bool = True):
    """An inception .pth (torchvision names: pt_inception-2015-12-05 for
    `fid_variant`, the reference's default, or torchvision's weights) ->
    its features_fn on `device`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = InceptionV3Features(fid_variant=fid_variant)
    missing, unknown = model.load_state_dict(
        torchvision_inception_features(sd), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unknown:
        raise KeyError(f"{path} does not match InceptionV3: missing "
                       f"{missing[:5]}, unknown {unknown[:5]}")
    return make_features_fn(model.to(device))

