"""T2ONet+D's discriminator and GAN iteration, in plain PyTorch for the
benchmark's reference.

Written from the published description (Shi et al., CVPR 2021; the
reference repo jshi31/T2ONet, `models/seq2seqGAN/networks.py` and
`seq2seqGAN.py`, `experiments/t2onet+D-L1/`), as functions over a flat
dict of tensors named as the system's state_dict names them (the
reference checkpoint's names), so that one dict of weights made by the
benchmark feeds both sides:

- the condition encoder: the request encoder's final hidden states (per
  layer, both directions side by side) flattened, Linear to `cond_nc`,
  BatchNorm1d, LeakyReLU 0.2: the sentence code;
- the multiscale PatchGAN: `num_D` discriminators, the first on the full
  image pair (source and edited, 6 channels), each next one on the pair
  average-pooled once more (`AvgPool2d(3, 2, 1,
  count_include_pad=False)`); each has `n_layers + 3` layers of 4x4
  convolutions with padding 2 and a bias, stride 2 for the first
  `n_layers`, width `ndf` doubling to at most 512, BatchNorm on every
  layer but the first and the last, LeakyReLU 0.2 on every layer but the
  last (1-channel patch logits); the sentence code is broadcast over the
  map and concatenated before layer `n_layers`. Scale i of the forward
  uses the weights `netD.scale{num_D - 1 - i}_*`, as pix2pixHD names them;
- LSGAN: the mean squared distance of each scale's last map to 1 (real)
  or 0 (fake), summed over the scales;
- feature matching: the L1 mean between every non-final layer's output
  on the fake pair and on the (detached) real pair, weighted by
  4 / (n_layers + 1), 1 / num_D and lambda_feat;
- one GAN iteration on the actor of `reference.model`: the sampled
  rollout, the fake at each sample's first <END>; G's loss G_GAN +
  G_GAN_Feat, its gradient over the actor, G's Adam; D's loss
  (D_real + D_fake) / 2 over D and the condition encoder, D's Adam; one
  train-mode forward on the real pair that moves the running averages.

Departures from the reference repo, each the system's own too:
- D's BatchNorms normalise every pass with the batch's statistics and
  move their running averages only in the one extra forward on the real
  pair after D's step, by 0.1 of the batch's mean and biased variance
  (the JAX trainer's flax BatchNorm, momentum 0.9); the reference repo's
  torch BatchNorms move them, with the unbiased variance, in every
  train-mode forward;
- the request encoder's hidden state enters the condition encoder
  without a gradient: G's loss reaches the actor through the fake image
  only, and the condition encoder learns from D's loss alone;
- no VGG perceptual term (the reference repo's `--no_vgg_loss`; the
  experiment t2onet+D-L1 names D and L1 only), and no pseudo-real
  (AdaptGAN) pair;
- G's update is taken before D's passes, which see D's weights unchanged
  by it: the same numbers as the reference repo's one forward of all
  the loss terms before either step.

Precision as `reference.model.set_precision`: float32 with TF32 off, or
the control's TF32. This file imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model as RM
from benchmark.reference import ops as R

SLOPE = 0.2                   # every LeakyReLU of D and the condition
BN_EPS = 1e-5
MOMENTUM = 0.1                # the share of a batch's statistics kept


def widths(gan: dict):
    """[(in channels, out channels, stride, BatchNorm?)] of one
    PatchGAN's layers; the layer at index n_layers also takes cond_nc."""
    n = gan["n_layers_D"]
    nf = gan["ndf"]
    out = [(6, nf, 2, False)]
    for _ in range(1, n):
        prev, nf = nf, min(nf * 2, 512)
        out.append((prev, nf, 2, True))
    prev, nf = nf, min(nf * 2, 512)
    out.append((prev + gan["cond_nc"], nf, 1, True))
    out.append((nf, nf, 1, True))
    out.append((nf, 1, 1, False))
    return out


def disc_specs(gan: dict, hidden_dim: int):
    """[(name, shape, init)] of D's and the condition encoder's parameters
    and buffers, in `reference.model.param_specs`'s form: convolutions
    and the Linear U(+-1/sqrt(fan_in)) for weight and bias, BatchNorm
    weight 1 and bias 0, running mean 0 and variance 1."""
    specs = []

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)),
                      (f"{name}.bias", (c,), ("const", 0.0)),
                      (f"{name}.running_mean", (c,), ("const", 0.0)),
                      (f"{name}.running_var", (c,), ("const", 1.0)),
                      (f"{name}.num_batches_tracked", (), ("count", 0))])

    for i in range(gan["num_D"]):
        for j, (cin, cout, _, norm) in enumerate(widths(gan)):
            p = f"netD.scale{i}_layer{j}"
            lim = 1.0 / math.sqrt(cin * 16)
            specs.append((f"{p}.0.weight", (cout, cin, 4, 4),
                          ("uniform", lim)))
            specs.append((f"{p}.0.bias", (cout,), ("uniform", lim)))
            if norm:
                bn(f"{p}.1", cout)
    lim = 1.0 / math.sqrt(hidden_dim)
    specs.append(("cond_encoder.fc.0.weight", (gan["cond_nc"], hidden_dim),
                  ("uniform", lim)))
    specs.append(("cond_encoder.fc.0.bias", (gan["cond_nc"],),
                  ("uniform", lim)))
    bn("cond_encoder.fc.1", gan["cond_nc"])
    return specs


def trainable_names(specs):
    return [n for n, _, init in specs if init[0] != "count"
            and not n.endswith(("running_mean", "running_var"))]


def _batch_norm(D, name, x, mode: str, moved):
    """mode "batch": the batch's statistics; "running": the running
    averages (a planted fault). With `moved` (a dict), the batch's mean
    and biased variance are kept there to move the averages."""
    if mode == "running":
        return F.batch_norm(x, D[f"{name}.running_mean"],
                            D[f"{name}.running_var"], D[f"{name}.weight"],
                            D[f"{name}.bias"], False, 0.0, BN_EPS)
    if moved is not None:
        dims = [0] + list(range(2, x.ndim))
        xd = x.detach()
        moved[name] = (xd.mean(dims), xd.var(dims, unbiased=False))
    return F.batch_norm(x, None, None, D[f"{name}.weight"], D[f"{name}.bias"],
                        True, 0.0, BN_EPS)


def encoder_hidden(P, cfg, tokens):
    """The request encoder's final hidden states, (B, n_layers x 2H)."""
    _, finals, _ = RM.encode_request(P, cfg, tokens)
    return torch.cat([h for h, _ in finals], dim=-1)


def condition(D, hidden, mode="batch", moved=None):
    """The sentence code (B, cond_nc) of the flattened hidden states."""
    x = RM.linear(hidden, D["cond_encoder.fc.0.weight"],
                  D["cond_encoder.fc.0.bias"])
    return F.leaky_relu(_batch_norm(D, "cond_encoder.fc.1", x, mode, moved),
                        SLOPE)


def patchgan(D, gan, scale: int, x, cond, mode="batch", moved=None):
    """Every layer's output of PatchGAN `scale`, the patch logits last."""
    layers = widths(gan)
    feats = []
    h = x
    for j, (_, _, stride, norm) in enumerate(layers):
        p = f"netD.scale{scale}_layer{j}"
        if j == gan["n_layers_D"]:
            b, _, hh, ww = h.shape
            h = torch.cat([h, cond[:, :, None, None].expand(
                b, cond.shape[1], hh, ww)], dim=1)
        h = RM.conv2d(h, D[f"{p}.0.weight"], stride, 2) \
            + D[f"{p}.0.bias"][None, :, None, None]
        if norm:
            h = _batch_norm(D, f"{p}.1", h, mode, moved)
        if j < len(layers) - 1:
            h = F.leaky_relu(h, SLOPE)
        feats.append(h)
    return feats


def discriminate(D, gan, x6, cond, mode="batch", moved=None):
    """One feature list a scale, the full resolution first."""
    out = []
    cur = x6
    for i in range(gan["num_D"]):
        out.append(patchgan(D, gan, gan["num_D"] - 1 - i, cur, cond, mode,
                            moved))
        if i != gan["num_D"] - 1:
            cur = F.avg_pool2d(cur, 3, 2, 1, count_include_pad=False)
    return out


def lsgan(preds, real: bool):
    target = 1.0 if real else 0.0
    return sum(((scale[-1] - target) ** 2).mean() for scale in preds)


def feature_matching(fake, real, gan):
    w = 4.0 / (gan["n_layers_D"] + 1) / gan["num_D"] * gan["lambda_feat"]
    total = 0.0
    for f_scale, r_scale in zip(fake, real):
        for f, r in zip(f_scale[:-1], r_scale[:-1]):
            total = total + w * (f - r.detach()).abs().mean()
    return total


def move_running(D, moved):
    """Each moved BatchNorm's running averages take MOMENTUM of the
    batch's statistics."""
    with torch.no_grad():
        for name, (mean, var) in moved.items():
            for key, stat in (("running_mean", mean), ("running_var", var)):
                r = D[f"{name}.{key}"]
                D[f"{name}.{key}"] = (1.0 - MOMENTUM) * r + MOMENTUM * stat


def rollout_fake(P, cfg, op_cfg, batch, gumbel, explore_prob: float):
    """The sampled rollout of `reference.model.episode_loss` (the same
    draws), returning each sample's image at its first <END> (else the
    last) in place of the L1."""
    x = batch["x"].long()
    img = batch["img_x"]
    b = x.shape[0]
    enc_out, carry, enc_valid = RM.encode_request(P, cfg, x)
    op_mask = torch.tensor(RM.EPISODE_OP_MASK, device=x.device) \
        .expand(b, cfg["op_vocab_size"])
    prev = torch.full((b,), RM.START_ID, dtype=torch.long, device=x.device)
    imgs, ops = [], []
    rows = torch.arange(b, device=x.device)
    for s in range(cfg["decoder_max_len"]):
        logprob, carry, context = RM.decoder_step(
            P, cfg, prev, carry, enc_out, enc_valid,
            RM.vis_feat(P, cfg, img, train=True))
        probs = RM.rollout_probs(logprob, op_mask, explore_prob)
        op = torch.argmax(gumbel(s, tuple(probs.shape))
                          + torch.log(probs.detach() + 1e-30), dim=-1)
        op_mask = op_mask * (1.0 - F.one_hot(
            op, cfg["op_vocab_size"]).to(op_mask.dtype))
        chosen = RM.pick(RM.heads(P, op_cfg, context), op)
        img = R.chain_step(img, R.vocab_to_slot(op), chosen, None)
        imgs.append(img)
        ops.append(op)
        prev = op
    ops = torch.stack(ops, dim=1)
    is_end = ops == RM.END_ID
    first = torch.argmax(is_end.to(torch.int32), dim=1)
    idx = torch.where(is_end.any(dim=1), first,
                      torch.full_like(first, ops.shape[1] - 1))
    return torch.stack(imgs, dim=1)[rows, idx]


def gan_iteration(P, names, D, d_names, cfg, op_cfg, gan, batch, gumbel,
                  explore_prob, adam_g, adam_d, lr, beta1, fault=None):
    """One GAN iteration in place on the actor's P[names] and D's
    D[d_names] (and D's running averages), stepping the two Adam states.
    `fault` plants one: "no_cond" (the sentence code left out: zeros) or
    "bn_running" (D's BatchNorms on their running averages). Returns
    (G's loss, D's loss, G's gradient {name: tensor}, D's)."""
    mode = "running" if fault == "bn_running" else "batch"
    src, gt = batch["img_x"], batch["gt_img"]
    real = torch.cat([src, gt], dim=1)
    with torch.no_grad():
        hidden = encoder_hidden(P, cfg, batch["x"].long())
        cond = condition(D, hidden, mode)
    if fault == "no_cond":
        cond = torch.zeros_like(cond)

    # G: its gradient over the actor, through the fake image
    for n in names:
        P[n].requires_grad_(True)
    fake = rollout_fake(P, cfg, op_cfg, batch, gumbel, explore_prob)
    pred_real = discriminate(D, gan, real, cond, mode)
    pred_fake = discriminate(D, gan, torch.cat([src, fake], dim=1), cond,
                             mode)
    g_loss = lsgan(pred_fake, True)
    if gan["gan_feat"]:
        g_loss = g_loss + feature_matching(pred_fake, pred_real, gan)
    got = torch.autograd.grad(g_loss, [P[n] for n in names],
                              allow_unused=True)
    g_grads = {n: (x if x is not None else torch.zeros_like(P[n]))
               for n, x in zip(names, got)}
    for n in names:
        P[n] = P[n].detach()
    fake = fake.detach()
    RM.adam_step(P, names, g_grads, adam_g, lr=lr, b1=beta1)
    del got, pred_real, pred_fake

    # D and the condition encoder, on the detached fake and the real pair
    for n in d_names:
        D[n].requires_grad_(True)
    cond = condition(D, hidden, mode)
    if fault == "no_cond":
        cond = torch.zeros_like(cond)
    d_fake = lsgan(discriminate(D, gan, torch.cat([src, fake], dim=1), cond,
                                mode), False)
    d_real = lsgan(discriminate(D, gan, real, cond, mode), True)
    d_loss = 0.5 * (d_fake + d_real)
    got = torch.autograd.grad(d_loss, [D[n] for n in d_names],
                              allow_unused=True)
    d_grads = {n: (x if x is not None else torch.zeros_like(D[n]))
               for n, x in zip(d_names, got)}
    for n in d_names:
        D[n] = D[n].detach()
    RM.adam_step(D, d_names, d_grads, adam_d, lr=lr, b1=beta1)

    # the running averages, from one forward on the real pair
    with torch.no_grad():
        moved = {}
        discriminate(D, gan, real, condition(D, hidden, "batch", moved),
                     "batch", moved)
        move_running(D, moved)
    return g_loss.detach(), d_loss.detach(), g_grads, d_grads
