"""pix2pixHD's training iteration, in plain PyTorch for the benchmark's
reference.

Written from the published description and code (Wang et al.,
"High-Resolution Image Synthesis and Semantic Manipulation with
Conditional GANs", arXiv:1711.11585; github.com/NVIDIA/pix2pixHD,
`models/networks.py`, `models/pix2pixHD_model.py`, `train.py`,
`options/*.py`), as functions over flat dicts of tensors named as the
system's state_dicts name them (pix2pixHD's checkpoint names), so that one
dict of weights made by the benchmark feeds both sides:

- the LocalEnhancer G (`--netG local`), options `o`: ngf,
  n_downsample_global, n_blocks_global, n_local_enhancers,
  n_blocks_local. The global generator, at ngf * 2^n_local_enhancers
  on the input average-pooled n_local_enhancers times (3x3, stride 2,
  padding 1, the padding left out of the count): a reflection pad of 3
  and a 7x7 conv, n_downsample_global 3x3 stride-2 convs doubling the
  width, n_blocks_global residual blocks (reflection pad 1, 3x3 conv,
  instance norm, ReLU, reflection pad 1, 3x3 conv, instance norm, added
  to the block's input), as many 3x3 stride-2 transposed convs (padding
  1, output padding 1) halving it, each conv but the blocks' second
  followed by an instance norm and a ReLU; its last 7x7 conv and tanh
  left out. Each local enhancer: a reflection pad of 3, a 7x7 conv and a
  3x3 stride-2 conv (each with instance norm and ReLU) on its scale of
  the input, the coarser output added, n_blocks_local residual blocks, a
  transposed conv with instance norm and ReLU; the last a reflection
  pad of 3, a 7x7 conv to 3 channels and tanh. Instance norm has no
  affine and eps 1e-5, and takes each image's and channel's mean and
  biased variance;
- the multiscale D (`--num_D` scales, `--n_layers_D`, `--ndf`, `--norm
  instance`, features returned): at each scale, the full resolution
  first, then the input average-pooled as above, 4x4 convs with padding
  2: ndf stride 2 and LeakyReLU 0.2; n_layers_D - 1 more stride 2,
  doubling up to 512, with instance norm and LeakyReLU; one stride 1
  with instance norm and LeakyReLU; one to 1 channel. The scale of the
  full resolution is `scale{num_D-1}`;
- VGG19's convs to relu5_1, its five slices ending at relu1_1 .. relu5_1
  on the [-1, 1] image as it is, frozen;
- the losses: LSGAN (the mean of (logit - target)^2 of each scale's last
  map, summed over the scales), feature matching (the L1 mean between D's
  features of (input, fake) and of (input, target), every layer but the
  last, weight 4 / (n_layers_D + 1) / num_D, times lambda_feat 10), VGG
  (the L1 means of the five slices, weights 1/32, 1/16, 1/8, 1/4, 1,
  times lambda_feat);
- Adam as PyTorch computes it, no weight decay;
- one iteration (`iteration`): the images (B, 3, H, W) in [0, 1]
  normalised to [-1, 1]; fake = G(input); D's passes on (input, fake
  detached), (input, target) and (input, fake); G's loss
  LSGAN(D(input, fake), real) + feature matching + VGG, its gradient
  over G, G's Adam; D's loss (LSGAN(D(input, fake detached), fake) +
  LSGAN(D(input, target), real)) * 0.5, its gradient over D, D's Adam.

Departures from pix2pixHD, each the system's own too:
- RGB input, its `--label_nc 0 --no_instance`: no one-hot label map, no
  instance edges, no feature encoder;
- the whole G trained from the first iteration, as after
  `--niter_fix_global`, with no 512p pretrain loaded;
- VGG19's weights drawn by the benchmark (no pretrained weights are in
  the repository);
- G's loss does not carry D's weights' gradient (pix2pixHD computes it
  and zeroes it before D's step).

Precision (`set_precision`): float32 with TF32 off, or the control's
TF32; on the CPU TF32 is emulated by rounding the operands of every
conv. `fault` plants one of `FAULTS` for the check's control. This file
imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IN_EPS = 1e-5
SLOPE = 0.2
LAMBDA_FEAT = 10.0
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
# VGG19's convs up to conv5_1: (features.N index, width); pools after
VGG_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
             (14, 256), (16, 256), (19, 512), (21, 512), (23, 512),
             (25, 512), (28, 512))
VGG_POOLS = (4, 9, 18, 27)
VGG_SLICE_ENDS = (1, 6, 11, 20, 29)        # relu1_1 .. relu5_1
# planted faults: the right half of both images gray; BatchNorm on its
# running averages (mean 0, variance 1) in D's instance norms' place;
# the global output not added to the local branch
FAULTS = ("half_pixels", "d_batchnorm", "no_global")

_EMULATE_TF32 = False


def set_precision(mode: str, device) -> None:
    """"f32" or "tf32" for every later conv."""
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

def _global_layout(o):
    """[(name, cin, cout, k, kind)] of the global generator's convs in
    order, kind "conv", "down", "block" (a residual block: its two convs
    are name.conv_block.1 and .5) or "up" (transposed)."""
    ngf = o["ngf"] * 2 ** o["n_local_enhancers"]
    nd, nb = o["n_downsample_global"], o["n_blocks_global"]
    out = [("model.1", 3, ngf, 7, "conv")]
    for i in range(nd):
        out.append((f"model.{4 + 3 * i}", ngf * 2 ** i, ngf * 2 ** (i + 1),
                    3, "down"))
    width = ngf * 2 ** nd
    for i in range(nb):
        out.append((f"model.{4 + 3 * nd + i}", width, width, 3, "block"))
    for i in range(nd):
        mult = 2 ** (nd - i)
        out.append((f"model.{4 + 3 * nd + nb + 3 * i}", ngf * mult,
                    ngf * mult // 2, 3, "up"))
    return out


def _local_layout(o, n):
    """The same for local enhancer n (1-based)."""
    ngf = o["ngf"] * 2 ** (o["n_local_enhancers"] - n)
    nb = o["n_blocks_local"]
    out = [(f"model{n}_1.1", 3, ngf, 7, "conv"),
           (f"model{n}_1.4", ngf, 2 * ngf, 3, "down")]
    out += [(f"model{n}_2.{i}", 2 * ngf, 2 * ngf, 3, "block")
            for i in range(nb)]
    out.append((f"model{n}_2.{nb}", 2 * ngf, ngf, 3, "up"))
    if n == o["n_local_enhancers"]:
        out.append((f"model{n}_2.{nb + 4}", o["ngf"], 3, 7, "tail"))
    return out


def _conv_specs(name, cin, cout, k, transposed=False):
    """(name, shape, fan_in) of a conv's weight and bias; a bias's fan_in
    is torch's default init's (a transposed conv's: its output channels
    times k^2); a weight's is None."""
    shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    fan = (cout if transposed else cin) * k * k
    return [(f"{name}.weight", shape, None), (f"{name}.bias", (cout,), fan)]


def generator_specs(o):
    out = []
    layers = _global_layout(o)
    for n in range(1, o["n_local_enhancers"] + 1):
        layers += _local_layout(o, n)
    for name, cin, cout, k, kind in layers:
        if kind == "block":
            for j in (1, 5):
                out += _conv_specs(f"{name}.conv_block.{j}", cin, cout, k)
        else:
            out += _conv_specs(name, cin, cout, k, kind == "up")
    return out


def _disc_layout(o):
    """[(cin, cout, stride, norm, act)] of one scale's layers."""
    nf, n = o["ndf"], o["n_layers_D"]
    out = [(6, nf, 2, False, True)]
    for _ in range(1, n):
        prev, nf = nf, min(nf * 2, 512)
        out.append((prev, nf, 2, True, True))
    prev, nf = nf, min(nf * 2, 512)
    out.append((prev, nf, 1, True, True))
    out.append((nf, 1, 1, False, False))
    return out


def disc_specs(o):
    out = []
    for i in range(o["num_D"]):
        for j, (cin, cout, _, _, _) in enumerate(_disc_layout(o)):
            out += _conv_specs(f"scale{i}_layer{j}.0", cin, cout, 4)
    return out


def vgg_specs():
    out, cin = [], 3
    for idx, width in VGG_CONVS:
        out += _conv_specs(f"features.{idx}", cin, width, 3)
        cin = width
    return out


def names(specs):
    return [n for n, _, _ in specs]


def normed_biases(o):
    """The biases of the convs that an instance norm follows, which it
    cancels: every G conv's but the last's; D's but its first and last
    layers' at each scale."""
    g = [n for n in names(generator_specs(o)) if n.endswith(".bias")]
    last = len(_disc_layout(o)) - 1
    d = [f"scale{i}_layer{j}.0.bias" for i in range(o["num_D"])
         for j in range(1, last)]
    return set(g[:-1] + d)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def conv(x, P, name, stride=1, padding=0):
    return F.conv2d(_t(x), _t(P[f"{name}.weight"]), P[f"{name}.bias"],
                    stride, padding)


def conv_t(x, P, name):
    return F.conv_transpose2d(_t(x), _t(P[f"{name}.weight"]),
                              P[f"{name}.bias"], 2, 1, 1)


def instance_norm(x):
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) / torch.sqrt(var + IN_EPS)


def running_norm(x):
    """BatchNorm on its first running averages (mean 0, variance 1)."""
    return x / math.sqrt(1.0 + IN_EPS)


def _reflect(x, p):
    return F.pad(x, (p, p, p, p), mode="reflect")


def avg_pool(x):
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


def _run(P, layers, h):
    for name, _, _, k, kind in layers:
        if kind == "block":
            y = torch.relu(instance_norm(conv(_reflect(h, 1), P,
                                              f"{name}.conv_block.1")))
            h = h + instance_norm(conv(_reflect(y, 1), P,
                                       f"{name}.conv_block.5"))
        elif kind == "up":
            h = torch.relu(instance_norm(conv_t(h, P, name)))
        elif kind == "down":
            h = torch.relu(instance_norm(conv(h, P, name, 2, 1)))
        elif kind == "conv":
            h = torch.relu(instance_norm(conv(_reflect(h, 3), P, name)))
        else:                                       # the tail
            h = torch.tanh(conv(_reflect(h, 3), P, name))
    return h


def generator(P, x, o, fault=None):
    """G's output (B, 3, H, W) in [-1, 1] on x in [-1, 1]."""
    n_le = o["n_local_enhancers"]
    pyramid = [x]
    for _ in range(n_le):
        pyramid.append(avg_pool(pyramid[-1]))
    h = _run(P, _global_layout(o), pyramid[-1])
    for n in range(1, n_le + 1):
        layers = _local_layout(o, n)
        down = _run(P, layers[:2], pyramid[n_le - n])
        h = _run(P, layers[2:], down if fault == "no_global" else down + h)
    return h


def discriminate(D, x, o, fault=None):
    """One list a scale, the full resolution first, of every layer's
    output, the patch logits last."""
    norm = running_norm if fault == "d_batchnorm" else instance_norm
    out = []
    for i in range(o["num_D"]):
        scale = o["num_D"] - 1 - i
        h, feats = x, []
        for j, (_, _, stride, has_norm, act) in enumerate(_disc_layout(o)):
            h = conv(h, D, f"scale{scale}_layer{j}.0", stride, 2)
            if has_norm:
                h = norm(h)
            if act:
                h = F.leaky_relu(h, SLOPE)
            feats.append(h)
        out.append(feats)
        if i != o["num_D"] - 1:
            x = avg_pool(x)
    return out


def vgg_slices(V, x):
    """VGG19's relu1_1 .. relu5_1 of x as it is."""
    out, convs = [], dict(VGG_CONVS)
    for idx in range(VGG_SLICE_ENDS[-1] + 1):
        if idx in convs:
            x = conv(x, V, f"features.{idx}", 1, 1)
        elif idx in VGG_POOLS:
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(x)
        if idx in VGG_SLICE_ENDS:
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def l1(a, b):
    return (a - b).abs().mean()


def lsgan(preds, real: bool):
    target = 1.0 if real else 0.0
    return sum(((p[-1] - target) ** 2).mean() for p in preds)


def feature_matching(pred_fake, pred_real, o):
    w = 4.0 / (o["n_layers_D"] + 1) / o["num_D"] * LAMBDA_FEAT
    return sum(w * l1(f, r.detach())
               for pf, pr in zip(pred_fake, pred_real)
               for f, r in zip(pf[:-1], pr[:-1]))


def vgg_loss(V, x, y):
    fx = vgg_slices(V, x)
    with torch.no_grad():
        fy = vgg_slices(V, y)
    return sum(w * l1(a, b) for w, a, b in zip(VGG_WEIGHTS, fx, fy)) \
        * LAMBDA_FEAT


# ---------------------------------------------------------------------------
# Adam and one iteration
# ---------------------------------------------------------------------------

def adam_step(P, keys, grads, state, lr, b1, b2, eps=1e-8):
    """One Adam step (PyTorch's form) of P[keys] in place."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    with torch.no_grad():
        for n in keys:
            g = grads[n]
            m = state.setdefault(("m", n), torch.zeros_like(P[n]))
            v = state.setdefault(("v", n), torch.zeros_like(P[n]))
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            P[n].addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


def _grads(loss, P, keys):
    """{name: the gradient}, 0 where the loss does not reach."""
    got = torch.autograd.grad(loss, [P[n] for n in keys], allow_unused=True)
    out = {n: torch.zeros_like(P[n]) if g is None else g
           for n, g in zip(keys, got)}
    for n in keys:
        P[n] = P[n].detach()
    return out


def iteration(G, D, V, label, image, adam_g, adam_d, cfg, fault=None):
    """One iteration on input and target images (B, 3, H, W) in [0, 1]:
    G's `G` and D's `D` updated in place, the VGG's `V`. `cfg` holds lr,
    beta1, beta2 and the options of G and D (`generator_specs`,
    `disc_specs`); `fault` one of `FAULTS`. Returns {"fake": G's output,
    "logits": {"fake": [each scale's logits on (input, fake)], "real":
    [on (input, target)]}, "terms": G_GAN, G_GAN_Feat, G_VGG, D_real,
    D_fake, "g_grads", "d_grads"}."""
    if fault == "half_pixels":
        w = label.shape[-1]
        label, image = label.clone(), image.clone()
        label[..., w // 2:] = 0.5
        image[..., w // 2:] = 0.5
    x, y = (label - 0.5) / 0.5, (image - 0.5) / 0.5
    g_keys, d_keys = names(generator_specs(cfg)), names(disc_specs(cfg))
    for n in g_keys:
        G[n].requires_grad_(True)
    for n in d_keys:
        D[n].requires_grad_(True)
    fake = generator(G, x, cfg, fault)
    pred_fake_pool = discriminate(D, torch.cat([x, fake.detach()], 1), cfg,
                                  fault)
    pred_real = discriminate(D, torch.cat([x, y], 1), cfg, fault)
    pred_fake = discriminate(D, torch.cat([x, fake], 1), cfg, fault)
    terms = {"G_GAN": lsgan(pred_fake, True),
             "G_GAN_Feat": feature_matching(pred_fake, pred_real, cfg),
             "G_VGG": vgg_loss(V, fake, y)}
    g_grads = _grads(terms["G_GAN"] + terms["G_GAN_Feat"] + terms["G_VGG"],
                     G, g_keys)
    adam_step(G, g_keys, g_grads, adam_g, cfg["lr"], cfg["beta1"],
              cfg["beta2"])
    terms["D_fake"] = lsgan(pred_fake_pool, False)
    terms["D_real"] = lsgan(pred_real, True)
    d_grads = _grads((terms["D_fake"] + terms["D_real"]) * 0.5, D, d_keys)
    adam_step(D, d_keys, d_grads, adam_d, cfg["lr"], cfg["beta1"],
              cfg["beta2"])
    return {"fake": fake.detach(),
            "logits": {"fake": [p[-1].detach() for p in pred_fake_pool],
                       "real": [p[-1].detach() for p in pred_real]},
            "terms": {k: float(v.detach()) for k, v in terms.items()},
            "g_grads": g_grads, "d_grads": d_grads}
