"""ResNet vision encoder (counterpart of `t2onet_tpu.models.resnet`),
NCHW throughout: a 3x3 stride-2 stem with no max-pool, four stages each
starting at stride 2, global mean pool and an fc head. Module names are
the reference checkpoint's (`conv1`, `bn1`, `layer{s}.{i}`, `fc`)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.models.common import FlaxBatchNorm2d

_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def blocks_per_stage(depth: int):
    if depth not in _BLOCKS:
        raise NotImplementedError(
            f"ResNet depth {depth}: only the BasicBlock depths "
            f"{sorted(_BLOCKS)} are ported")
    return _BLOCKS[depth]


def _bn(c):
    # flax momentum 0.9 keeps 0.9 of the old running stat: torch's 0.1
    return FlaxBatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
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
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.shortcut(x))


class ResNet(nn.Module):
    """(B, 3, H, W) -> (B, num_outputs)."""

    def __init__(self, depth: int = 18, num_outputs: int = 512,
                 stage_widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, stage_widths[0], 3, 2, 1, bias=False)
        self.bn1 = _bn(stage_widths[0])
        in_planes = stage_widths[0]
        stages = zip(stage_widths, blocks_per_stage(depth))
        for s, (planes, n) in enumerate(stages, 1):
            blocks = []
            for i in range(n):
                blocks.append(BasicBlock(in_planes, planes,
                                         stride=2 if i == 0 else 1))
                in_planes = planes
            setattr(self, f"layer{s}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_planes, num_outputs)

    def forward(self, img):
        x = F.relu(self.bn1(self.conv1(img)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.mean(x, dim=(2, 3)))
