"""EdgeConnect (Nazeri et al. 2019; github.com/knazeri/edge-connect): the
generators, their training form and discriminator, canny on the card,
and the checkpoint loader of the inpaint operator slot (counterpart of
`t2onet_tpu.models.edgeconnect`, which has the inference form only).

The reference's InpaintOperator runs EdgeConnect's MODEL=3 test path
(EdgeModel predicts edges in the hole, InpaintingModel fills RGB from
them; reference models/operators.py:625-682). Here:

- `EdgeGenerator` / `InpaintGenerator`: EdgeConnect's generators in its
  own layer layout (7x7 reflection-padded stem, two stride-2 convs, 8
  dilation-2 residual blocks, two ConvTranspose2d(4, 2, 1) upsamples,
  InstanceNorm2d without affine or running statistics), so that a
  checkpoint's state_dict keys load as they are. `EdgeGenerator(
  spectral=True)` is the edge model as EdgeConnect trains and saves it:
  spectral norm on every conv but the last, the residual convs without
  a bias (`SNConv2d`, `SNConvTranspose2d`: torch's `spectral_norm`
  layout, `weight_orig`, `weight_u`, `weight_v`, one power iteration per
  forward in train mode);
- `Discriminator`: EdgeConnect's PatchGAN, five spectral-normed 4x4
  convs without bias, its passes' power iterations taken apart from the
  passes (`power_iterations`) so a trainer can order them;
- `edgeconnect_state_dict`: an `EdgeModel_gen.pth` /
  `InpaintingModel_gen.pth` state_dict with spectral norm resolved at
  load time, weight = weight_orig / (u . (W v)) from the stored u and v
  (no power iteration, so eval() changes nothing); a conv saved without
  a bias gets a zero one;
- `image_gray` and `edge_maps`: skimage's rgb2gray and `canny_edges` on
  the images' device, equal to `canny_edges` pixel for pixel
  (`canny_classes` up to the hysteresis); on the card the hysteresis is
  the kernel of `ops.hysteresis`, and nothing is read back to the host;
- `make_edgeconnect_inpaint_fn` / `load_edgeconnect`: the MODEL=3 test
  pipeline as an `inpaint_fn(img)` for the bank's inpaint slot, its
  edges from `edge_maps` on the nets' device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2onet_tpu_torch.models.common import checked_device
from t2onet_tpu_torch.ops.hysteresis import hysteresis

N_RES_BLOCKS = 8
SN_EPS = 1e-12                  # torch.nn.utils.spectral_norm's eps
# skimage.color.rgb2gray's weights (Rec. 709 luma), EdgeConnect's gray
GRAY_WEIGHTS = (0.2125, 0.7154, 0.0721)
CANNY_LOW, CANNY_HIGH = 0.1, 0.2   # of the image's largest gradient


# ---------------------------------------------------------------------------
# spectral norm, as torch.nn.utils.spectral_norm keeps and computes it
# ---------------------------------------------------------------------------

def weight_matrix(w, dim: int):
    """The weight flattened with dimension `dim` (0 for a conv, 1 for a
    transposed conv's output channels) as the rows."""
    if dim != 0:
        w = w.permute(dim, *[d for d in range(w.dim()) if d != dim])
    return w.reshape(w.shape[0], -1)


class _Spectral:
    """What `SNConv2d` and `SNConvTranspose2d` add to their layer: the
    parameter `weight_orig` and the buffers `weight_u`, `weight_v` in
    place of `weight`, initialised as torch's `spectral_norm` does."""

    def _make_spectral(self, dim: int):
        w = self._parameters.pop("weight").data
        self.sn_dim = dim
        self.register_parameter("weight_orig", nn.Parameter(w))
        rows, cols = weight_matrix(w, dim).shape
        self.register_buffer("weight_u", F.normalize(
            w.new_empty(rows).normal_(0, 1), dim=0, eps=SN_EPS))
        self.register_buffer("weight_v", F.normalize(
            w.new_empty(cols).normal_(0, 1), dim=0, eps=SN_EPS))

    @torch.no_grad()
    def power_iteration(self):
        """One step of the power iteration (torch's n_power_iterations=1):
        `weight_v` then `weight_u` move in place; returns their copies,
        the vectors of the forward that takes this step."""
        mat = weight_matrix(self.weight_orig, self.sn_dim)
        v = F.normalize(torch.mv(mat.t(), self.weight_u), dim=0, eps=SN_EPS,
                        out=self.weight_v)
        u = F.normalize(torch.mv(mat, v), dim=0, eps=SN_EPS,
                        out=self.weight_u)
        return u.clone(), v.clone()

    def spectral_weight(self, uv=None):
        """weight_orig / (u . (W v)), the gradient reaching weight_orig
        through sigma too. `uv` from `power_iteration`; without it a
        train-mode layer takes its step now, an eval-mode one uses the
        stored vectors."""
        if uv is None:
            uv = (self.power_iteration() if self.training
                  else (self.weight_u, self.weight_v))
        u, v = uv
        mat = weight_matrix(self.weight_orig, self.sn_dim)
        return self.weight_orig / torch.dot(u, torch.mv(mat, v))


class SNConv2d(nn.Conv2d, _Spectral):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._make_spectral(0)

    def forward(self, x, uv=None):
        return self._conv_forward(x, self.spectral_weight(uv), self.bias)


class SNConvTranspose2d(nn.ConvTranspose2d, _Spectral):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._make_spectral(1)

    def forward(self, x, uv=None):
        return F.conv_transpose2d(x, self.spectral_weight(uv), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def spectral_layers(module: nn.Module):
    """[(name, layer)] of the spectral-normed layers, in module order."""
    return [(n, m) for n, m in module.named_modules()
            if isinstance(m, _Spectral)]


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

class _ResnetBlock(nn.Module):
    """Dilated 3x3 (reflection pad 2) -> IN -> ReLU -> 3x3 (reflection
    pad 1) -> IN, additive skip; `conv_block.1` and `.5` are the convs
    (spectral-normed and without a bias where `spectral`)."""

    def __init__(self, dim: int = 256, dilation: int = 2,
                 spectral: bool = False):
        super().__init__()
        conv = (lambda *a, **k: SNConv2d(*a, bias=False, **k)) if spectral \
            else nn.Conv2d
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(dilation),
            conv(dim, dim, 3, dilation=dilation),
            nn.InstanceNorm2d(dim),
            nn.ReLU(True),
            nn.ReflectionPad2d(1),
            conv(dim, dim, 3),
            nn.InstanceNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class _Generator(nn.Module):
    """EdgeConnect's generator trunk: `encoder.{1,4,7}`,
    `middle.{i}.conv_block.{1,5}` and `decoder.{0,3,7}` are its layers;
    with `spectral` all but `decoder.7` are spectral-normed."""

    def __init__(self, in_channels: int, out_channels: int,
                 spectral: bool = False):
        super().__init__()
        conv = SNConv2d if spectral else nn.Conv2d
        up = SNConvTranspose2d if spectral else nn.ConvTranspose2d
        self.encoder = nn.Sequential(
            nn.ReflectionPad2d(3), conv(in_channels, 64, 7),
            nn.InstanceNorm2d(64), nn.ReLU(True),
            conv(64, 128, 4, stride=2, padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(True),
            conv(128, 256, 4, stride=2, padding=1),
            nn.InstanceNorm2d(256), nn.ReLU(True))
        self.middle = nn.Sequential(*[_ResnetBlock(256, spectral=spectral)
                                      for _ in range(N_RES_BLOCKS)])
        self.decoder = nn.Sequential(
            up(256, 128, 4, stride=2, padding=1),
            nn.InstanceNorm2d(128), nn.ReLU(True),
            up(128, 64, 4, stride=2, padding=1),
            nn.InstanceNorm2d(64), nn.ReLU(True),
            nn.ReflectionPad2d(3), nn.Conv2d(64, out_channels, 7))

    def trunk(self, x):
        return self.decoder(self.middle(self.encoder(x)))


class EdgeGenerator(_Generator):
    """[masked grayscale, masked edges, mask] (B, 3, H, W) -> the edge
    probability map (B, 1, H, W), sigmoid. `spectral=True` is the form
    EdgeConnect trains and saves (use_spectral_norm=True)."""

    def __init__(self, spectral: bool = False):
        super().__init__(3, 1, spectral)

    def forward(self, x):
        return torch.sigmoid(self.trunk(x))


class InpaintGenerator(_Generator):
    """[masked rgb, composed edges] (B, 4, H, W) -> RGB in [0, 1],
    (tanh + 1) / 2 (EdgeConnect's output scaling)."""

    def __init__(self):
        super().__init__(4, 3)

    def forward(self, x):
        return (torch.tanh(self.trunk(x)) + 1.0) / 2.0


class Discriminator(nn.Module):
    """EdgeConnect's inpainting discriminator: `conv1`..`conv5`, 4x4
    spectral-normed convs without bias and with padding 1, 3 -> 64 -> 128
    -> 256 (stride 2) -> 512 -> 1 (stride 1), LeakyReLU 0.2 after all but
    the last, a sigmoid on the patch map (nsgan). `features` is `conv1`
    under a second name, as EdgeConnect registers it, so both appear in
    the state_dict. forward(x, uvs) -> (outputs, [the five layers'
    outputs]); `uvs` from `power_iterations()`, else each layer takes its
    own step in train mode."""

    WIDTHS = ((64, 2), (128, 2), (256, 2), (512, 1), (1, 1))

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (cout, stride) in enumerate(self.WIDTHS):
            conv = SNConv2d(cin, cout, 4, stride=stride, padding=1,
                            bias=False)
            act = [nn.LeakyReLU(0.2, inplace=True)] if i < 4 else []
            layers.append(nn.Sequential(conv, *act))
            cin = cout
        self.conv1 = self.features = layers[0]
        self.conv2, self.conv3, self.conv4, self.conv5 = layers[1:]

    def convs(self):
        return [self.conv1[0], self.conv2[0], self.conv3[0], self.conv4[0],
                self.conv5[0]]

    def power_iterations(self):
        """One power iteration of every layer: the vectors of one pass."""
        return [c.power_iteration() for c in self.convs()]

    def forward(self, x, uvs=None):
        feats = []
        for i, seq in enumerate((self.conv1, self.conv2, self.conv3,
                                 self.conv4, self.conv5)):
            x = seq[0](x, None if uvs is None else uvs[i])
            if len(seq) > 1:
                x = seq[1](x)
            feats.append(x)
        return torch.sigmoid(x), feats


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
    spectral norm resolved, a missing bias (the spectral-normed residual
    convs', saved without one) zero. `sd` is an `EdgeModel_gen.pth`-style
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
        bias = sd.get(f"{base}.bias")
        out[f"{base}.bias"] = (
            bias.detach().to(torch.float32) if bias is not None else
            w.new_zeros(w.shape[1 if base in ("decoder.0", "decoder.3")
                                else 0]))
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
# edges
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


def image_gray(img):
    """(B, 3, H, W) RGB in [0, 1] -> (B, H, W) gray in the images' dtype:
    skimage's rgb2gray, what EdgeConnect feeds the edge model."""
    r, g, b = GRAY_WEIGHTS
    return r * img[:, 0] + g * img[:, 1] + b * img[:, 2]


def _gaussian_weights(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d's weights, computed as scipy
    computes them (f64, on the host)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def _reflected(x, dim: int, r: int):
    """x extended by r along `dim` in scipy.ndimage's 'reflect' mode (d c
    b a | a b c d | d c b a), and a function giving the view shifted by
    o, -r <= o <= r."""
    n = x.shape[dim]
    i = torch.remainder(torch.arange(-r, n + r, device=x.device), 2 * n)
    p = x.index_select(dim, torch.where(i >= n, 2 * n - 1 - i, i))
    return lambda o: p.narrow(dim, r + o, n)


def _correlate_symmetric(x, w, dim: int):
    """scipy's correlate1d with a symmetric odd kernel, in its order: the
    centre tap first, then each pair of taps from the outermost in, the
    pair summed before its weight."""
    r = len(w) // 2
    s = _reflected(x, dim, r)
    out = s(0) * float(w[r])
    for j in range(r, 0, -1):
        out = out + (s(-j) + s(j)) * float(w[r - j])
    return out


def _sobel(g, dim: int):
    """scipy.ndimage.sobel along `dim`: the central difference (next
    minus previous, as scipy's antisymmetric correlate1d gives it), then
    [1, 2, 1] along the other image axis."""
    s = _reflected(g, dim, 1)
    d = s(1) - s(-1)
    t = _reflected(d, 3 - dim, 1)
    return t(0) * 2.0 + (t(-1) + t(1))


# the two neighbours of each gradient direction bin, (dy, dx)
_NMS_DIRS = (((0, 1), (0, -1)), ((1, 1), (-1, -1)), ((1, 0), (-1, 0)),
             ((1, -1), (-1, 1)))


def canny_classes(gray, sigma: float = 2.0):
    """Canny of each (H, W) image of `gray` (B, H, W) up to the
    hysteresis, on its device, as `canny_edges` computes it: f64
    arithmetic in scipy's and numpy's order of operations for the
    gaussian, the sobel gradients, the magnitude over the image's
    largest, the direction bins and the non-maximum suppression. ->
    (B, H, W) uint8: 0 none, 1 weak, 2 strong."""
    g = gray.to(torch.float64)
    w = _gaussian_weights(sigma)
    g = _correlate_symmetric(_correlate_symmetric(g, w, 1), w, 2)
    gx, gy = _sobel(g, 2), _sobel(g, 1)
    mag = torch.hypot(gx, gy)
    top = mag.amax(dim=(1, 2), keepdim=True)
    mag = mag / torch.where(top > 0, top, torch.ones_like(top))
    ang = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)) + 180.0, 180.0)
    bins = torch.remainder(torch.div(ang + 22.5, 45.0, rounding_mode="floor"),
                           4.0)
    h, wd = mag.shape[1:]
    pad = F.pad(mag, (1, 1, 1, 1))
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for b, ((dy1, dx1), (dy2, dx2)) in enumerate(_NMS_DIRS):
        n1 = pad[:, 1 + dy1:h + 1 + dy1, 1 + dx1:wd + 1 + dx1]
        n2 = pad[:, 1 + dy2:h + 1 + dy2, 1 + dx2:wd + 1 + dx2]
        keep |= (bins == b) & (mag >= n1) & (mag >= n2)
    q = torch.where(keep, mag, torch.zeros_like(mag))
    return (q >= CANNY_LOW).to(torch.uint8) + (q >= CANNY_HIGH).to(torch.uint8)


def edge_maps(gray, sigma: float = 2.0):
    """`canny_edges` of each (H, W) image of `gray` (B, H, W), on its
    device and equal to it pixel for pixel: `canny_classes`, then
    `ops.hysteresis` (a kernel on the card), so no value is read back to
    the host. -> (B, H, W) float32 in {0, 1}."""
    return hysteresis(canny_classes(gray, sigma)).to(torch.float32)


# ---------------------------------------------------------------------------
# MODEL=3 test pipeline
# ---------------------------------------------------------------------------

def make_edgeconnect_inpaint_fn(edge_net: EdgeGenerator,
                                inpaint_net: InpaintGenerator, mask,
                                sigma: float = 2.0):
    """The reference InpaintOperator's `model.test(img, mask)` as an
    `inpaint_fn(img (B,3,H,W) in [0,1]) -> (B,3,H,W)` for the bank's
    inpaint slot (mask: (1,1,H,W) or (H,W), 1 = hole), on the nets'
    device.

    Gray and its edges (`image_gray`, `edge_maps`: the trainer's) ->
    EdgeGenerator fills the hole's edges -> InpaintGenerator fills RGB ->
    out*mask + img*(1-mask), clipped."""
    m = torch.from_numpy(np.asarray(mask, np.float32).reshape(
        np.asarray(mask).shape[-2:]))

    @torch.no_grad()
    def inpaint_fn(img):
        img = img.to(torch.float32)
        mm = m.to(img.device)
        keep = 1.0 - mm
        gray = image_gray(img)
        edges = edge_maps(gray, sigma) * keep
        # the hole filled white (EdgeConnect's images_masked)
        pred_edges = edge_net(torch.stack(
            [gray * keep + mm, edges, mm.expand_as(gray)], 1))
        # known-region edges come from canny
        pred_edges = pred_edges * mm + edges[:, None] * (1.0 - mm)
        out = inpaint_net(torch.cat([img * keep + mm, pred_edges], 1))
        return torch.clamp(out * mm + img * (1.0 - mm), 0.0, 1.0)

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
