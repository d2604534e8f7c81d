"""VGG19 perceptual features and the VGG loss (counterpart of
`t2onet_tpu.models.vgg`; reference models/seq2seqGAN/networks.py:113-125,
427-461).

Five slices of torchvision's vgg19.features, ending at relu1_1, relu2_1,
relu3_1, relu4_1 and relu5_1, on an ImageNet-normalised [0, 1] RGB
input. The module keeps torchvision's `features.N` indices, so a
torchvision `vgg19` state_dict loads by its own names (the classifier's
entries are dropped); nothing here imports torchvision. No pretrained
weights ship with the repository: the user supplies the .pth.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

# torchvision vgg19.features: conv indices and widths up to relu5_1
_CONV_LAYERS = [
    (0, 64), (2, 64), (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256), (16, 256),
    (19, 512), (21, 512), (23, 512), (25, 512), (28, 512),
]
_POOLS = (4, 9, 18, 27)
# features.N index where each slice ends (exclusive)
_SLICE_ENDS = (2, 7, 12, 21, 30)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

VGG_LOSS_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class Vgg19Features(nn.Module):
    """[0, 1] RGB NCHW -> [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        widths = dict(_CONV_LAYERS)
        for idx in range(_SLICE_ENDS[-1]):
            if idx in widths:
                layers.append(nn.Conv2d(cin, widths[idx], 3, padding=1))
                cin = widths[idx]
            elif idx in _POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x) -> List[torch.Tensor]:
        x = (x - self.mean) / self.std
        outs, start = [], 0
        for end in _SLICE_ENDS:
            for idx in range(start, end):
                x = self.features[idx](x)
            outs.append(x)
            start = end
        return outs


def torchvision_vgg19_features(sd: Dict) -> Dict:
    """A torchvision vgg19 state_dict -> this module's: the `features.N`
    entries up to relu5_1; the classifier and deeper layers dropped."""
    return {k: v for k, v in sd.items()
            if k.startswith("features.") and int(k.split(".")[1]) < 30}


def make_vgg_loss(model: Vgg19Features, weights=VGG_LOSS_WEIGHTS):
    """The reference VGGLoss: perceptual_fn(x, y) = sum_i w_i *
    L1(vgg_i(x), vgg_i(y).detach()). The model's weights are frozen; the
    gradient flows to x."""
    model.requires_grad_(False)

    def perceptual_fn(x, y):
        fx = model(x)
        with torch.no_grad():
            fy = model(y)
        loss = x.new_zeros(())
        for w, a, b in zip(weights, fx, fy):
            loss = loss + w * (a - b).abs().mean()
        return loss

    return perceptual_fn


def load_vgg19(path: str, device):
    """A torchvision vgg19 .pth -> (the model on `device`, eval mode,
    perceptual_fn)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = Vgg19Features()
    model.load_state_dict(torchvision_vgg19_features(sd))
    model = model.to(device).eval()
    return model, make_vgg_loss(model)
