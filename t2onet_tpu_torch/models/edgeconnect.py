"""EdgeConnect generators (Nazeri et al. 2019) and their checkpoint
loader: pretrained-weights interop for the inpaint operator slot
(counterpart of `t2onet_tpu.models.edgeconnect`).

The reference's InpaintOperator runs EdgeConnect's MODEL=3 test path
(EdgeModel predicts edges in the hole, InpaintingModel fills RGB from
them; reference models/operators.py:625-682). Here:

- `EdgeGenerator` / `InpaintGenerator`: EdgeConnect's generators in its
  own layer layout (7x7 reflection-padded stem, two stride-2 convs, 8
  dilation-2 residual blocks, two ConvTranspose2d(4, 2, 1) upsamples,
  InstanceNorm2d without affine or running statistics), so that a
  checkpoint's state_dict keys load as they are;
- `edgeconnect_state_dict`: an `EdgeModel_gen.pth` /
  `InpaintingModel_gen.pth` state_dict with spectral norm resolved at
  load time, weight = weight_orig / (u . (W v)) from the stored u and v
  (no power iteration, so eval() changes nothing);
- `make_edgeconnect_inpaint_fn` / `load_edgeconnect`: the MODEL=3 test
  pipeline as an `inpaint_fn(img)` for the bank's inpaint slot, with
  canny edges on the host (`canny_edges`, scipy.ndimage): each call
  copies its images to the host and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from t2onet_tpu_torch.models.common import checked_device

N_RES_BLOCKS = 8


class _ResnetBlock(nn.Module):
    """Dilated 3x3 (reflection pad 2) -> IN -> ReLU -> 3x3 (reflection
    pad 1) -> IN, additive skip; `conv_block.1` and `.5` are the convs."""

    def __init__(self, dim: int = 256, dilation: int = 2):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(dilation),
            nn.Conv2d(dim, dim, 3, dilation=dilation),
            nn.InstanceNorm2d(dim),
            nn.ReLU(True),
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3),
            nn.InstanceNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class _Generator(nn.Module):
    """EdgeConnect's generator trunk: `encoder.{1,4,7}`,
    `middle.{i}.conv_block.{1,5}` and `decoder.{0,3,7}` are its layers."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.encoder = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(in_channels, 64, 7),
            nn.InstanceNorm2d(64), nn.ReLU(True),
            nn.Conv2d(64, 128, 4, stride=2, padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(True),
            nn.Conv2d(128, 256, 4, stride=2, padding=1),
            nn.InstanceNorm2d(256), nn.ReLU(True))
        self.middle = nn.Sequential(*[_ResnetBlock(256)
                                      for _ in range(N_RES_BLOCKS)])
        self.decoder = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 4, stride=2, padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(True),
            nn.ConvTranspose2d(128, 64, 4, stride=2, padding=1),
            nn.InstanceNorm2d(64), nn.ReLU(True),
            nn.ReflectionPad2d(3), nn.Conv2d(64, out_channels, 7))

    def trunk(self, x):
        return self.decoder(self.middle(self.encoder(x)))


class EdgeGenerator(_Generator):
    """[masked grayscale, masked edges, mask] (B, 3, H, W) -> the edge
    probability map (B, 1, H, W), sigmoid."""

    def __init__(self):
        super().__init__(3, 1)

    def forward(self, x):
        return torch.sigmoid(self.trunk(x))


class InpaintGenerator(_Generator):
    """[masked rgb, composed edges] (B, 4, H, W) -> RGB in [0, 1],
    (tanh + 1) / 2 (EdgeConnect's output scaling)."""

    def __init__(self):
        super().__init__(4, 3)

    def forward(self, x):
        return (torch.tanh(self.trunk(x)) + 1.0) / 2.0


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------

def _resolve_spectral(sd: Dict, base: str):
    """The weight of layer `base`, spectral norm resolved: weight_orig /
    (u . (W v)), W flattened over the dimension whose size u has (0 for
    a conv; a ConvTranspose2d's output channels, dim 1, as torch's
    spectral_norm stores it)."""
    if f"{base}.weight" in sd:
        return sd[f"{base}.weight"]
    w = sd[f"{base}.weight_orig"]
    u = sd[f"{base}.weight_u"]
    v = sd[f"{base}.weight_v"]
    wm = w if u.numel() == w.shape[0] else w.transpose(0, 1)
    sigma = torch.dot(u, torch.mv(wm.reshape(wm.shape[0], -1), v))
    return w / sigma


def edgeconnect_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """An EdgeConnect generator checkpoint -> the generator's state_dict,
    spectral norm resolved. `sd` is an `EdgeModel_gen.pth`-style
    {'iteration': ..., 'generator': state_dict} or the state_dict."""
    if "generator" in sd and not any("." in k for k in list(sd)[:2]):
        sd = sd["generator"]
    names = ([f"encoder.{i}" for i in (1, 4, 7)]
             + [f"middle.{i}.conv_block.{j}" for i in range(N_RES_BLOCKS)
                for j in (1, 5)]
             + [f"decoder.{i}" for i in (0, 3, 7)])
    out = {}
    for base in names:
        w = _resolve_spectral(sd, base).detach().to(torch.float32)
        out[f"{base}.weight"] = w
        out[f"{base}.bias"] = sd[f"{base}.bias"].detach().to(torch.float32)
    return out


def load_generator(sd: Dict, kind: str, device="cuda") -> _Generator:
    """An `EdgeGenerator` ('edge') or `InpaintGenerator` ('inpaint') from a
    checkpoint's state_dict, on `device` (the card by default; raises where
    PyTorch finds none), in eval mode."""
    device = checked_device(device)
    net = {"edge": EdgeGenerator, "inpaint": InpaintGenerator}[kind]()
    net.load_state_dict(edgeconnect_state_dict(sd))
    return net.to(device).eval()


# ---------------------------------------------------------------------------
# MODEL=3 test pipeline
# ---------------------------------------------------------------------------

def canny_edges(gray: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Canny edge map of a [0,1] grayscale (H, W): gaussian gradient,
    non-max suppression, hysteresis (scipy.ndimage), standing in for
    skimage.feature.canny, which EdgeConnect uses for the known-region
    edges."""
    from scipy import ndimage as ndi

    g = ndi.gaussian_filter(gray.astype(np.float64), sigma)
    gx = ndi.sobel(g, axis=1)
    gy = ndi.sobel(g, axis=0)
    mag = np.hypot(gx, gy)
    if mag.max() > 0:
        mag = mag / mag.max()
    ang = (np.rad2deg(np.arctan2(gy, gx)) + 180.0) % 180.0
    # non-maximum suppression over the 4 quantized directions
    q = np.zeros_like(mag)
    h, w = mag.shape
    pad = np.pad(mag, 1)
    dirs = [((0, 1), (0, -1)), ((1, 1), (-1, -1)),
            ((1, 0), (-1, 0)), ((1, -1), (-1, 1))]
    bins = (((ang + 22.5) // 45).astype(int)) % 4
    for b, ((dy1, dx1), (dy2, dx2)) in enumerate(dirs):
        n1 = pad[1 + dy1:h + 1 + dy1, 1 + dx1:w + 1 + dx1]
        n2 = pad[1 + dy2:h + 1 + dy2, 1 + dx2:w + 1 + dx2]
        keep = (bins == b) & (mag >= n1) & (mag >= n2)
        q[keep] = mag[keep]
    lo, hi = 0.1, 0.2
    strong = q >= hi
    weak = q >= lo
    # hysteresis: weak pixels connected to strong survive
    lbl, n = ndi.label(weak)
    if n:
        keep_ids = np.unique(lbl[strong])
        out = np.isin(lbl, keep_ids[keep_ids > 0]) & weak
    else:
        out = strong
    return out.astype(np.float32)


def make_edgeconnect_inpaint_fn(edge_net: EdgeGenerator,
                                inpaint_net: InpaintGenerator, mask,
                                sigma: float = 2.0):
    """The reference InpaintOperator's `model.test(img, mask)` as an
    `inpaint_fn(img (B,3,H,W) in [0,1]) -> (B,3,H,W)` for the bank's
    inpaint slot (mask: (1,1,H,W) or (H,W), 1 = hole), on the nets'
    device.

    Gray and canny on the host per image -> EdgeGenerator fills the
    hole's edges -> InpaintGenerator fills RGB -> out*mask +
    img*(1-mask), clipped."""
    m = np.asarray(mask, np.float32).reshape(np.asarray(mask).shape[-2:])
    keep = 1.0 - m

    @torch.no_grad()
    def inpaint_fn(img):
        arr = img.detach().cpu().numpy().astype(np.float32)  # (B,3,H,W)
        # skimage's rgb2gray (Rec. 709 luma), what EdgeConnect feeds the
        # edge model
        gray = (0.2125 * arr[:, 0] + 0.7154 * arr[:, 1]
                + 0.0721 * arr[:, 2])
        edges = np.stack([canny_edges(g, sigma) * keep for g in gray])
        # the hole filled white (EdgeConnect's images_masked)
        ein = np.stack([gray * keep + m, edges,
                        np.broadcast_to(m, gray.shape)], 1)
        iin = arr * keep + m
        dev = img.device
        mm = torch.from_numpy(m).to(dev)
        canny = torch.from_numpy(edges[:, None]).to(dev)
        pred_edges = edge_net(torch.from_numpy(ein).to(dev))
        # known-region edges come from canny
        pred_edges = pred_edges * mm + canny * (1.0 - mm)
        out = inpaint_net(torch.cat([torch.from_numpy(iin).to(dev),
                                     pred_edges], 1))
        comp = out * mm + torch.from_numpy(arr).to(dev) * (1.0 - mm)
        return torch.clamp(comp, 0.0, 1.0)

    return inpaint_fn


def load_edgeconnect(edge_path: str, inpaint_path: str, mask, sigma=2.0,
                     device="cuda"):
    """Load EdgeConnect's `EdgeModel_gen.pth` and
    `InpaintingModel_gen.pth` onto `device` (the card by default; raises
    where PyTorch finds none) and return the bank-ready inpaint_fn."""
    device = checked_device(device)
    esd = torch.load(edge_path, map_location="cpu", weights_only=True)
    isd = torch.load(inpaint_path, map_location="cpu", weights_only=True)
    return make_edgeconnect_inpaint_fn(
        load_generator(esd, "edge", device),
        load_generator(isd, "inpaint", device), mask, sigma)
