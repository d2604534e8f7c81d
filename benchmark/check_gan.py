"""The comparison that decides `correct` in the GAN cell.

The reference (`reference.model` and `reference.gan`: the same actor and
discriminator weights from the seed, the same host batches, the same
Gumbel draws, Adams of its own) follows the system's first three
iterations: supervised, a GAN iteration (the sampled rollout through B1
and B3, G's update through D, D's update, the statistics update),
supervised. Each number is a relative distance, the system's against
the reference's:

- `loss_gap`: the first (supervised) loss; `loss_gap.3`, the third, is a
  reading only (`check_train`: Adam's steps on rounding-noise gradients
  can turn a near-tie of the rollout's draws);
- `g_loss_gap.2`: G's loss G_GAN + G_GAN_Feat; `d_loss_gap.2`: D's loss
  (D_real + D_fake) / 2;
- `grad_gap`: the actor's first gradient, as its Adam holds it, the
  worst leaf (`check_train`);
- `g_grad_gap_median.2`: G's gradient over the actor, as G's Adam holds
  it after its first step (the first moment over 1 - beta1), the median
  leaf; the worst (`g_grad_gap.2`) is a reading: the card's own
  nondeterministic sums, through the backward of the sampled rollout,
  move the reference's worst leaf against itself by up to a third of
  what sound runs read, and sound runs spread over a factor of nineteen
  (PERF.md);
- `d_grad_gap.2`: D's and the condition encoder's gradient, as D's Adam
  holds it, the worst leaf;
- `d_stats_gap.2`: the running averages after the statistics update:
  over the BatchNorm buffers, the largest distance between the system's
  and the reference's moves from the initial values over the
  reference's, the running means less the share of the bias before them
  (`bias_free`);
- `change_gap`: each actor leaf's change over the three iterations, the
  worst of the leaves whose reference gradient in some iteration
  reaches `check_train.SMALL_GRAD` of that iteration's median leaf.
  Adam's first steps move each value by about the learning rate whatever
  its gradient's size, so a value whose gradient is rounding noise can
  turn its step's sign: the card's own nondeterministic sums move a leaf
  of the reference against itself by up to a few hundredths, as far as
  TF32 moves some seeds (PERF.md), and the limit lies between that and
  the 1 of a state left unchanged;
- `d_change_gap`: the same for D's leaves over the GAN iteration. D's
  one Adam step moves each value by about its learning rate, so
  precision hardly moves it; a state left unchanged, or a leaf that no
  gradient reaches, reads 1;
- `pool_off` (set by the driver): `check_train`'s.
"""

from __future__ import annotations

import torch

from benchmark.check_train import (_median_leaf, _on_device, _worst_leaf,
                                   counted_leaves)
from benchmark.reference import gan as RG
from benchmark.reference import model as RM


def hidden_dim(model: dict) -> int:
    """The condition encoder's input: every encoder layer's final hidden
    state in both directions."""
    return model["n_layers"] * 2 * model["hidden_size"]


def stat_keys(state) -> list:
    """The running averages of D's and the condition encoder's
    BatchNorms, and the biases of the layers before them."""
    stats = [n for n in state if n.endswith(("running_mean",
                                             "running_var"))]
    return stats + [n.replace(".1.running_mean", ".0.bias")
                    for n in stats if n.endswith("running_mean")]


def _norms(grads: dict) -> dict:
    return {n: float(v.norm()) for n, v in grads.items()}


def reference_readings(ctx, W, WD, kept, gumbel, device, precision: str,
                       rows=None, fault=None):
    """The reference's readings over the kept iterations [(supervised?,
    host batch)]. `rows` keeps only those rows of every batch and
    `fault` is `reference.gan.gan_iteration`'s (planted faults)."""
    model, op_cfg, gan = ctx.model_config(), ctx.op_config(), \
        ctx.config["gan"]
    mix = ctx.traffic
    RM.set_precision(precision, device)
    names = RM.trainable_names(RM.param_specs(model, len(ctx.vocab())))
    d_specs = RG.disc_specs(gan, hidden_dim(model))
    d_names = RG.trainable_names(d_specs)
    P = {n: t.detach().clone() for n, t in W.items()}
    D = {n: t.detach().clone() for n, t in WD.items()}
    adam, adam_g, adam_d = {}, {}, {}
    losses, grads, out = [], [], {}
    for step, (sup, host) in enumerate(kept, 1):
        batch = _on_device(host, device, rows)
        if sup:
            for n in names:
                P[n].requires_grad_(True)
            loss = RM.supervised_loss(P, model, op_cfg, batch)
            got = torch.autograd.grad(loss, [P[n] for n in names],
                                      allow_unused=True)
            g = {n: (x if x is not None else torch.zeros_like(P[n]))
                 for n, x in zip(names, got)}
            for n in names:
                P[n] = P[n].detach()
            RM.adam_step(P, names, g, adam, lr=mix["learning_rate"])
            losses.append(float(loss.detach()))
            del got
        else:
            g_loss, d_loss, g, d_g = RG.gan_iteration(
                P, names, D, d_names, model, op_cfg, gan, batch,
                lambda k, shape, s=step: gumbel(s, k, shape),
                ctx.config["explore_prob"], adam_g, adam_d, mix["gan_lr"],
                mix["beta1"], fault)
            losses.append(float(g_loss))
            out.update(g_loss=float(g_loss), d_loss=float(d_loss),
                       d_grad_norms=_norms(d_g),
                       d_stats={n: D[n].clone()
                                for n in stat_keys(D)})
            del d_g
        grads.append(_norms(g))
        del batch, g
    RM.set_precision("f32", device)
    out.update(
        losses=losses, grad_norms=grads[0], step_grads=grads,
        g_grad_norms=grads[1] if len(grads) > 1 else {},
        change_norms={n: float((P[n] - W[n]).norm()) for n in names},
        d_change_norms={n: float((D[n] - WD[n]).norm()) for n in d_names})
    return out


def bias_free(stats: dict, initial: dict) -> dict:
    """Each running average's move from its initial value; a running
    mean's less MOMENTUM times the bias of the layer before its
    BatchNorm (in `stats` too), which the batch's mean holds whole: that
    bias's true gradient is 0 under the BatchNorm, so Adam's first step
    moves it by the learning rate with the sign of rounding noise."""
    out = {}
    for n, v in stats.items():
        if n.endswith("running_var"):
            out[n] = v - initial[n]
        elif n.endswith("running_mean"):
            bias = stats[n.replace(".1.running_mean", ".0.bias")]
            out[n] = v - initial[n] - RG.MOMENTUM * bias
    return out


def _stats_gap(prog: dict, ref: dict, initial: dict) -> float:
    """The largest distance between the system's and the reference's
    moves of a running average (`bias_free`) over the reference's."""
    p, r = bias_free(prog, initial), bias_free(ref, initial)
    gaps = [float((p[n].to(v.device) - v).norm()) / float(v.norm())
            for n, v in r.items() if float(v.norm()) > 0]
    return max(gaps, default=0.0)


def judge(prog: dict, ref: dict, initial_stats: dict) -> dict:
    """prog: the system's "losses" (the first and the third), "g_loss",
    "d_loss", "grad_norms", "g_grad_norms", "d_grad_norms", "d_stats",
    "change_norms", "d_change_norms"; `initial_stats`: the running
    averages before the run."""

    def rel(p, r):
        return abs(p - r) / max(abs(r), 1e-12)

    g_names = sorted(ref["g_grad_norms"])
    d_names = sorted(ref["d_grad_norms"])
    return {
        "loss_gap": rel(prog["losses"][0], ref["losses"][0]),
        "loss_gap.3": rel(prog["losses"][-1], ref["losses"][-1]),
        "g_loss_gap.2": rel(prog["g_loss"], ref["g_loss"]),
        "d_loss_gap.2": rel(prog["d_loss"], ref["d_loss"]),
        "grad_gap": _worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                sorted(ref["grad_norms"])),
        "g_grad_gap_median.2": _median_leaf(prog["g_grad_norms"],
                                            ref["g_grad_norms"], g_names),
        "g_grad_gap.2": _worst_leaf(prog["g_grad_norms"],
                                    ref["g_grad_norms"], g_names),
        "d_grad_gap.2": _worst_leaf(prog["d_grad_norms"],
                                    ref["d_grad_norms"], d_names),
        "d_stats_gap.2": _stats_gap(prog["d_stats"], ref["d_stats"],
                                    initial_stats),
        "change_gap": _worst_leaf(prog["change_norms"], ref["change_norms"],
                                  counted_leaves(ref)),
        "d_change_gap": _worst_leaf(
            prog["d_change_norms"], ref["d_change_norms"],
            counted_leaves({"step_grads": [ref["d_grad_norms"]]}))}
