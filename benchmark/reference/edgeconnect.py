"""EdgeConnect's inpainting stage, in plain PyTorch for the benchmark's
reference.

Written from the published description and code (Nazeri et al.,
"EdgeConnect: Generative Image Inpainting with Adversarial Edge
Learning", arXiv:1901.00212; github.com/knazeri/edge-connect,
`config.yml.example`, `src/networks.py`, `src/models.py`, `src/loss.py`,
`src/dataset.py`), as functions over flat dicts of tensors named as the
system's state_dicts name them (EdgeConnect's checkpoint names), so that
one dict of weights made by the benchmark feeds both sides:

- the generators: a 7x7 conv after a reflection pad of 3, two 4x4
  stride-2 convs, 8 residual blocks (reflection pad 2, 3x3 conv of
  dilation 2, instance norm, ReLU, reflection pad 1, 3x3 conv, instance
  norm, added to the block's input), two 4x4 stride-2 transposed convs,
  a 7x7 conv after a reflection pad of 3; instance norm (no affine, eps
  1e-5) and ReLU after every conv but the residual blocks' second and
  the last. The edge G ([gray, edges, mask] -> 1 channel, sigmoid) has
  spectral norm on every conv but the last and no bias in the residual
  blocks; the inpaint G ([rgb, edges] -> 3 channels, (tanh + 1) / 2) has
  no spectral norm;
- spectral norm as torch's `spectral_norm` computes it, written out: in
  a train-mode forward one power iteration, v = W^T u / |W^T u|, then
  u = W v / |W v| (each norm at least 1e-12), W the weight flattened
  with its output channels as rows (a transposed conv's are its second
  dimension); the weight is W / (u . W v) with u and v held fixed;
- the discriminator: 4x4 convs with padding 1, spectral-normed and
  without bias, 3 -> 64 -> 128 -> 256 (stride 2) -> 512 -> 1 (stride 1),
  LeakyReLU 0.2 after all but the last, a sigmoid (nsgan);
- VGG19's convs on the [0, 1] image as it is, to relu5_2, with
  EdgeConnect's names of the ReLUs;
- the losses of `src/loss.py`: BCE (logs at least -100, as PyTorch's),
  L1 means, the perceptual loss over relu1_1..relu5_1 with weights 1,
  the style loss over the Gram matrices f f^T / (h w ch) of relu2_2,
  relu3_4, relu4_4 and relu5_2;
- canny on the host (`canny`): skimage's rgb2gray weights, then f64
  arithmetic in scipy.ndimage's order of operations, written out with
  numpy: a gaussian of sigma 2 (radius 8, 'reflect' edges), sobel
  gradients, the magnitude over the image's largest, four direction
  bins, non-maximum suppression against the bin's two neighbours (0
  outside), thresholds 0.1 and 0.2, and the weak pixels 4-connected to a
  strong one, by a flood fill;
- Adam as PyTorch computes it, no weight decay;
- one iteration (`iteration`): the edges; the edge G in train mode on
  [gray*(1-m)+m, edges*(1-m), m] with no gradient, composed as
  pred*m + edges*(1-m); the inpaint G on [img*(1-m)+m, edges]; D's three
  power iterations, for its passes on the real images, on the fakes and
  on G's output; G's loss 0.1*BCE(D(out), 1) + L1(out, img)/mean(m) +
  0.1*perceptual(out, img) + 250*style(out*m, img*m), its gradient over
  the inpaint G, G's Adam (lr 1e-4, betas 0.0 and 0.9); D's loss
  (BCE(D(img), 1) + BCE(D(out detached), 0)) / 2, its gradient, D's
  Adam (lr 1e-5).

Departures from EdgeConnect, each the system's own too:
- canny is the port's stand-in for skimage's (`canny_edges`: a scipy
  sobel on the smoothed image, no interpolation in the suppression,
  thresholds relative to the image's largest gradient); the gray comes
  from the float32 image, not from skimage on the uint8 one;
- G's update is taken before D's: EdgeConnect steps D first and then
  backpropagates G's loss through D's pass, which current PyTorch
  refuses; the values are the same, since G's pass and D's passes all
  see D's weights before its step, and no gradient of G's loss reaches D;
- the edge G runs without a gradient (EdgeConnect builds one and
  detaches its output); the VGG19 of both losses is one set of weights
  (EdgeConnect's two instances load the same pretrained ones);
- no random flip of the training images.

Precision (`set_precision`): float32 with TF32 off, or the control's
TF32; on the CPU TF32 is emulated by rounding the operands of every conv
and matrix product. This file imports nothing of the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

N_BLOCKS = 8
IN_EPS = 1e-5
SN_EPS = 1e-12
SLOPE = 0.2
GRAY = (0.2125, 0.7154, 0.0721)
LOSS_WEIGHTS = {"l1": 1.0, "adv": 0.1, "content": 0.1, "style": 250.0}
# VGG19's convs up to relu5_2: (features.N index, width); pools after
VGG_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
             (14, 256), (16, 256), (19, 512), (21, 512), (23, 512),
             (25, 512), (28, 512), (30, 512))
VGG_POOLS = (4, 9, 18, 27)
RELU = {"relu1_1": 1, "relu2_1": 6, "relu2_2": 8, "relu3_1": 11,
        "relu3_4": 17, "relu4_1": 20, "relu4_4": 26, "relu5_1": 29,
        "relu5_2": 31}
PERCEPTUAL = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
STYLE = ("relu2_2", "relu3_4", "relu4_4", "relu5_2")
DISC = ((64, 2), (128, 2), (256, 2), (512, 1), (1, 1))

_EMULATE_TF32 = False


def set_precision(mode: str, device) -> None:
    """"f32" or "tf32" for every later conv and matrix product."""
    global _EMULATE_TF32
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _EMULATE_TF32 = tf32 and torch.device(device).type != "cuda"


def _t(x):
    """x rounded to TF32 when the CPU emulates it; the gradient passes."""
    if not _EMULATE_TF32:
        return x
    with torch.no_grad():
        i = x.detach().contiguous().view(torch.int32)
        rounded = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


# ---------------------------------------------------------------------------
# the weights' names and shapes
# ---------------------------------------------------------------------------

def generator_specs(kind: str):
    """[(name, shape, kind)] of a generator's parameters and buffers,
    kind "weight" (N(0, 0.02)), "zero" (a bias) or "u"/"v" (a
    spectral-normed layer's vectors, a normalised normal draw)."""
    cin, cout = (3, 1) if kind == "edge" else (4, 3)
    spectral = kind == "edge"
    out = []

    def conv(name, ci, co, k, bias=True, sn=spectral, transposed=False):
        shape = (ci, co, k, k) if transposed else (co, ci, k, k)
        if sn:
            out.append((f"{name}.weight_orig", shape, "weight"))
            rows = co
            out.append((f"{name}.weight_u", (rows,), "u"))
            out.append((f"{name}.weight_v", (ci * k * k,), "v"))
        else:
            out.append((f"{name}.weight", shape, "weight"))
        if bias:
            out.append((f"{name}.bias", (co,), "zero"))

    conv("encoder.1", cin, 64, 7)
    conv("encoder.4", 64, 128, 4)
    conv("encoder.7", 128, 256, 4)
    for i in range(N_BLOCKS):
        for j in (1, 5):
            conv(f"middle.{i}.conv_block.{j}", 256, 256, 3,
                 bias=not spectral)
    conv("decoder.0", 256, 128, 4, transposed=True)
    conv("decoder.3", 128, 64, 4, transposed=True)
    conv("decoder.7", 64, cout, 7, sn=False)
    return out


def disc_specs():
    out, cin = [], 3
    for i, (cout, _) in enumerate(DISC, 1):
        out += [(f"conv{i}.0.weight_orig", (cout, cin, 4, 4), "weight"),
                (f"conv{i}.0.weight_u", (cout,), "u"),
                (f"conv{i}.0.weight_v", (cin * 16,), "v")]
        cin = cout
    return out


def vgg_specs():
    out, cin = [], 3
    for idx, width in VGG_CONVS:
        out += [(f"features.{idx}.weight", (width, cin, 3, 3), "weight"),
                (f"features.{idx}.bias", (width,), "zero")]
        cin = width
    return out


def spectral_names(specs):
    """The spectral-normed layers' names, in order."""
    return [n[:-len(".weight_orig")] for n, _, _ in specs
            if n.endswith(".weight_orig")]


def trainable_names(specs):
    return [n for n, _, kind in specs if kind in ("weight", "zero")]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _matrix(w, transposed: bool):
    if transposed:
        w = w.transpose(0, 1)
    return w.reshape(w.shape[0], -1)


def _normalize(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x), SN_EPS)


def power_iteration(P, name, transposed=False):
    """One power iteration of layer `name`: P's u and v replaced by the
    new vectors (no gradient); returns them."""
    with torch.no_grad():
        mat = _matrix(P[f"{name}.weight_orig"], transposed)
        v = _normalize(torch.mv(mat.t(), P[f"{name}.weight_u"]))
        u = _normalize(torch.mv(mat, v))
    P[f"{name}.weight_u"], P[f"{name}.weight_v"] = u, v
    return u, v


def sigma(P, name, uv, transposed=False):
    u, v = uv
    return torch.dot(u, torch.mv(_matrix(P[f"{name}.weight_orig"],
                                         transposed), v))


def spectral_weight(P, name, uv, transposed=False):
    return P[f"{name}.weight_orig"] / sigma(P, name, uv, transposed)


def conv(x, w, b=None, stride=1, padding=0, dilation=1):
    return F.conv2d(_t(x), _t(w), b, stride, padding, dilation)


def conv_t(x, w, b=None):
    return F.conv_transpose2d(_t(x), _t(w), b, 2, 1)


def instance_norm(x):
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + IN_EPS)


def _reflect(x, p):
    return F.pad(x, (p, p, p, p), mode="reflect")


def generator(P, kind: str, x, train: bool = True):
    """The edge ("edge") or inpaint G's output on x. The edge G's
    spectral-normed layers take a power iteration each where `train`."""
    spectral = kind == "edge"

    def weight(name, transposed=False):
        if not spectral or name == "decoder.7":
            return P[f"{name}.weight"]
        uv = (power_iteration(P, name, transposed) if train else
              (P[f"{name}.weight_u"], P[f"{name}.weight_v"]))
        return spectral_weight(P, name, uv, transposed)

    def bias(name):
        return P.get(f"{name}.bias")

    h = conv(_reflect(x, 3), weight("encoder.1"), bias("encoder.1"))
    h = torch.relu(instance_norm(h))
    for name in ("encoder.4", "encoder.7"):
        h = torch.relu(instance_norm(conv(h, weight(name), bias(name), 2,
                                          1)))
    for i in range(N_BLOCKS):
        a, b = f"middle.{i}.conv_block.1", f"middle.{i}.conv_block.5"
        y = torch.relu(instance_norm(conv(_reflect(h, 2), weight(a), bias(a),
                                          dilation=2)))
        y = instance_norm(conv(_reflect(y, 1), weight(b), bias(b)))
        h = h + y
    for name in ("decoder.0", "decoder.3"):
        h = torch.relu(instance_norm(conv_t(h, weight(name, True),
                                            bias(name))))
    h = conv(_reflect(h, 3), weight("decoder.7"), bias("decoder.7"))
    return torch.sigmoid(h) if kind == "edge" else (torch.tanh(h) + 1) / 2


def disc_vectors(D):
    """One power iteration of every D layer: the vectors of one pass."""
    return [power_iteration(D, f"conv{i}.0") for i in range(1, 6)]


def discriminate(D, x, uvs):
    for i in range(1, 6):
        name = f"conv{i}.0"
        x = conv(x, spectral_weight(D, name, uvs[i - 1]), None,
                 DISC[i - 1][1], 1)
        if i < 5:
            x = F.leaky_relu(x, SLOPE)
    return torch.sigmoid(x)


def vgg_taps(V, x, names):
    want = {RELU[n]: n for n in names}
    out = {}
    for idx in range(max(want) + 1):
        if f"features.{idx}.weight" in V:
            x = conv(x, V[f"features.{idx}.weight"],
                     V[f"features.{idx}.bias"], 1, 1)
        elif idx in VGG_POOLS:
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(x)
        if idx in want:
            out[want[idx]] = x
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def bce(p, real: bool):
    """PyTorch's BCELoss against all ones or all zeros, written out."""
    log = torch.clamp_min(torch.log(p if real else 1 - p), -100.0)
    return -log.mean()


def l1(a, b):
    return (a - b).abs().mean()


def gram(x):
    b, ch, h, w = x.shape
    f = x.reshape(b, ch, h * w)
    return torch.matmul(_t(f), _t(f.transpose(1, 2))) / (h * w * ch)


def perceptual(V, x, y):
    fx = vgg_taps(V, x, PERCEPTUAL)
    with torch.no_grad():
        fy = vgg_taps(V, y, PERCEPTUAL)
    return sum(l1(fx[n], fy[n]) for n in PERCEPTUAL)


def style(V, x, y):
    fx = vgg_taps(V, x, STYLE)
    with torch.no_grad():
        fy = vgg_taps(V, y, STYLE)
    return sum(l1(gram(fx[n]), gram(fy[n])) for n in STYLE)


# ---------------------------------------------------------------------------
# canny, on the host
# ---------------------------------------------------------------------------

def _gaussian_weights(sigma_: float):
    radius = int(4.0 * float(sigma_) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma_ * sigma_) * x ** 2)
    return phi / phi.sum()


def _shifts(a, axis, r):
    """View shifts of `a` along `axis` over scipy's 'reflect' extension."""
    n = a.shape[axis]
    i = np.arange(-r, n + r) % (2 * n)
    p = np.take(a, np.where(i >= n, 2 * n - 1 - i, i), axis=axis)
    return lambda o: np.take(p, np.arange(r + o, r + o + n), axis=axis)


def _smooth(a, w, axis):
    r = len(w) // 2
    s = _shifts(a, axis, r)
    out = s(0) * w[r]
    for j in range(r, 0, -1):
        out = out + (s(-j) + s(j)) * w[r - j]
    return out


def _sobel(g, axis):
    s = _shifts(g, axis, 1)
    t = _shifts(s(1) - s(-1), 1 - axis, 1)
    return t(0) * 2.0 + (t(-1) + t(1))


def _flood(weak, strong):
    """The weak pixels 4-connected through weak pixels to a strong one."""
    reach = strong.copy()
    while True:
        grown = reach.copy()
        grown[1:] |= reach[:-1]
        grown[:-1] |= reach[1:]
        grown[:, 1:] |= reach[:, :-1]
        grown[:, :-1] |= reach[:, 1:]
        grown &= weak
        if (grown == reach).all():
            return reach
        reach = grown


def canny(gray: np.ndarray, sigma_: float = 2.0) -> np.ndarray:
    """One (H, W) image's edges, float32 in {0, 1} (the module's
    docstring)."""
    w = _gaussian_weights(sigma_)
    g = _smooth(_smooth(gray.astype(np.float64), w, 0), w, 1)
    gx, gy = _sobel(g, 1), _sobel(g, 0)
    mag = np.hypot(gx, gy)
    if mag.max() > 0:
        mag = mag / mag.max()
    ang = (np.rad2deg(np.arctan2(gy, gx)) + 180.0) % 180.0
    bins = ((ang + 22.5) // 45).astype(int) % 4
    h, wd = mag.shape
    pad = np.pad(mag, 1)
    q = np.zeros_like(mag)
    for b, ((y1, x1), (y2, x2)) in enumerate(
            (((0, 1), (0, -1)), ((1, 1), (-1, -1)), ((1, 0), (-1, 0)),
             ((1, -1), (-1, 1)))):
        n1 = pad[1 + y1:h + 1 + y1, 1 + x1:wd + 1 + x1]
        n2 = pad[1 + y2:h + 1 + y2, 1 + x2:wd + 1 + x2]
        keep = (bins == b) & (mag >= n1) & (mag >= n2)
        q[keep] = mag[keep]
    return _flood(q >= 0.1, q >= 0.2).astype(np.float32)


def gray_of(img):
    return GRAY[0] * img[:, 0] + GRAY[1] * img[:, 1] + GRAY[2] * img[:, 2]


# ---------------------------------------------------------------------------
# Adam and one iteration
# ---------------------------------------------------------------------------

def adam_step(P, names, grads, state, lr, b1, b2, eps=1e-8):
    """One Adam step (PyTorch's form) of P[names] in place."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    with torch.no_grad():
        for n in names:
            g = grads[n]
            m = state.setdefault(("m", n), torch.zeros_like(P[n]))
            v = state.setdefault(("v", n), torch.zeros_like(P[n]))
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            P[n].addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


def _grads(loss, P, names):
    for n in names:
        P[n].requires_grad_(True)
    got = torch.autograd.grad(loss, [P[n] for n in names])
    for n in names:
        P[n] = P[n].detach()
    return dict(zip(names, got))


def iteration(E, G, D, V, img, m, adam_g, adam_d, cfg, weights=None,
              skip_power=False):
    """One iteration on images (B, 3, H, W) and masks (B, 1, H, W): the
    edge G's `E`, the inpaint G's `G`, D's `D` (updated in place), the
    VGG's `V`. `cfg` holds lr, d2g_lr, beta1, beta2, sigma; `weights`
    the loss weights (LOSS_WEIGHTS); `skip_power` leaves out the power
    iteration of G's pass through D (a planted fault). Returns
    {"edges": the edge G's edge channel edges*(1-m) (host, bool), "pred":
    the edge G's output, "terms": G's four weighted terms, "d_loss",
    "g_grads", "d_grads"}."""
    w = dict(LOSS_WEIGHTS if weights is None else weights)
    gray = gray_of(img)
    edges = torch.from_numpy(np.stack([
        canny(g, cfg["sigma"]) for g in gray.detach().cpu().numpy()]))
    edges = edges.to(img.device)[:, None]
    with torch.no_grad():
        pred = generator(E, "edge", torch.cat(
            [gray[:, None] * (1 - m) + m, edges * (1 - m), m], 1))
        comp = pred * m + edges * (1 - m)
    g_names = trainable_names(generator_specs("inpaint"))
    for n in g_names:
        G[n].requires_grad_(True)
    out = generator(G, "inpaint", torch.cat([img * (1 - m) + m, comp], 1))
    uvs = [disc_vectors(D), disc_vectors(D)]
    uvs.append(uvs[1] if skip_power else disc_vectors(D))
    terms = {"G_adv": bce(discriminate(D, out, uvs[2]), True) * w["adv"],
             "G_l1": l1(out, img) * w["l1"] / m.mean(),
             "G_content": perceptual(V, out, img) * w["content"],
             "G_style": style(V, out * m, img * m) * w["style"]}
    g_loss = (terms["G_adv"] + terms["G_l1"] + terms["G_content"]
              + terms["G_style"])
    g_grads = _grads(g_loss, G, g_names)
    adam_step(G, g_names, g_grads, adam_g, cfg["lr"],
              cfg["beta1"], cfg["beta2"])
    d_names = trainable_names(disc_specs())
    for n in d_names:
        D[n].requires_grad_(True)
    fake = out.detach()
    d_loss = (bce(discriminate(D, img, uvs[0]), True)
              + bce(discriminate(D, fake, uvs[1]), False)) / 2
    d_grads = _grads(d_loss, D, d_names)
    adam_step(D, d_names, d_grads, adam_d, cfg["lr"] * cfg["d2g_lr"],
              cfg["beta1"], cfg["beta2"])
    return {"edges": (edges * (1 - m)).bool().cpu(), "pred": pred,
            "terms": {k: float(v.detach()) for k, v in terms.items()},
            "d_loss": float(d_loss.detach()), "g_grads": g_grads,
            "d_grads": d_grads}
