"""ResNet vision encoder (counterpart of `t2onet_tpu.models.resnet`),
NCHW throughout: a 3x3 stride-2 stem with no max-pool, four stages of
BasicBlocks (depths 18, 34) or Bottlenecks (50, 101, 152), each stage
starting at stride 2, global mean pool and an fc head. Module names are
the reference checkpoint's (`conv1`, `bn1`, `layer{s}.{i}`, `fc`).

With `bf16` the convolutions and activations run in bfloat16, as the JAX
package's `ResNet(dtype=jnp.bfloat16)`: parameters and running statistics
stay f32, each convolution casts its weight to bf16 when it runs, each
BatchNorm reduces and normalises in f32 and hands bf16 on, and the
features return to f32 before the mean pool and `fc`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.models.common import FlaxBatchNorm2d

_CFG = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _cfg(depth: int):
    if depth not in _CFG:
        raise ValueError(f"ResNet depth {depth}: one of {sorted(_CFG)}")
    return _CFG[depth]


def blocks_per_stage(depth: int):
    return _cfg(depth)[1]


def _bn(c):
    # flax momentum 0.9 keeps 0.9 of the old running stat: torch's 0.1
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv(conv: nn.Conv2d, x):
    """`conv` in x's dtype. The f32 weight is cast to bf16 here, on every
    forward, rather than under autocast: the cast is explicit, the same on
    the CPU and the card, and keeps the master weights f32 for Adam. Its
    cost is one read of the f32 weights: on an H100, casting each weight
    once per training step instead left the trainer's steps where they
    were (scripts/torch_bf16_steps.py)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


def _norm(bn: nn.Module, x):
    """BatchNorm; a bf16 input is normalised in f32 (as flax promotes its
    statistics and its normalisation) and the result handed on in bf16."""
    if x.dtype == torch.bfloat16:
        return bn(x.float()).to(x.dtype)
    return bn(x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, bias=False),
                _bn(planes))

    def forward(self, x):
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        y = _norm(self.bn2, _conv(self.conv2, y))
        if len(self.shortcut):
            x = _norm(self.shortcut[1], _conv(self.shortcut[0], x))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 to 4 x planes. The projection shortcut
    is a 1x1 convolution with no BatchNorm, the reference's quirk
    (its BasicBlock has one)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = _bn(out_planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out_planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, out_planes, 1, stride, bias=False))

    def forward(self, x):
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        y = F.relu(_norm(self.bn2, _conv(self.conv2, y)))
        y = _norm(self.bn3, _conv(self.conv3, y))
        if len(self.shortcut):
            x = _conv(self.shortcut[0], x)
        return F.relu(y + x)


class ResNet(nn.Module):
    """(B, 3, H, W) -> (B, num_outputs), f32 in the bf16 mode."""

    def __init__(self, depth: int = 18, num_outputs: int = 512,
                 stage_widths: Sequence[int] = (64, 128, 256, 512),
                 bf16: bool = False):
        super().__init__()
        kind, n_blocks = _cfg(depth)
        block = BasicBlock if kind == "basic" else Bottleneck
        self.bf16 = bf16
        self.conv1 = nn.Conv2d(3, stage_widths[0], 3, 2, 1, bias=False)
        self.bn1 = _bn(stage_widths[0])
        in_planes = stage_widths[0]
        for s, (planes, n) in enumerate(zip(stage_widths, n_blocks), 1):
            blocks = []
            for i in range(n):
                blocks.append(block(in_planes, planes,
                                    stride=2 if i == 0 else 1))
                in_planes = planes * block.expansion
            setattr(self, f"layer{s}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_planes, num_outputs)

    def forward(self, img):
        x = img.to(torch.bfloat16) if self.bf16 else img
        x = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.bf16:
            x = x.float()
        return self.fc(torch.mean(x, dim=(2, 3)))
