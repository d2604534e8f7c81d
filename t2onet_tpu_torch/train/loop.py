"""Training steps: alternating supervised / end-to-end-L1 phases
(counterpart of `t2onet_tpu.train.loop`).

- odd iterations (supervised): op NLL averaged over the positions up to
  the batch's longest op sequence, plus param MSE summed and normalised by
  the number of nonzero ground-truth params;
- even iterations (episode): sampled free rollout, each sample's image at
  its first <END>, mean |.| L1 to the ground-truth image.

In the discrete parameter mode the supervised param loss adds the bin
cross-entropy (`discrete_param_loss`), which is what trains the bin
logits.

One Adam over every trainable parameter, stepped by both phases. Every
parameter takes part in every step: a parameter that got no gradient
(decoder.out_linear in the episode phase, whose ops are picked by argmax
or sampling) gets a zero gradient, so that its moments decay and its
update follows from them, as optax treats a missing gradient. Each step
returns its metrics as tensors on the actor's device and reads nothing
back to the host.

Data parallelism (`parallel/mesh.py`): under a group of W ranks each
rank steps on its rows of the global batch. The losses take their
divisors from the global batch (the position mask's any, the batch size,
the nonzero ground-truth params, the bins' mask, the L1's element
count), the episode's noise is drawn for the global batch and each rank
keeps its rows, BatchNorm normalises with the global statistics, and
`apply_gradients` sums the gradients over the ranks: the step at world
size W is the step of world size 1 up to the order of summation. The
returned metrics are the global batch's. At world size 1 nothing of this
runs.

Under a (data x model) grid all of that runs over the data group, while
the ranks of a model group split the parameter heads: each computes and
steps its own block (`models.actor.ParamHeads`), and its Adam holds
moments for those heads and the replicated rest only (the counterpart of
JAX's `state_shardings`, which shards the heads' Adam moments with the
heads). `TrainState.gather` brings every head and its moments to every
rank, as an unsharded state holds them, before a checkpoint.
"""

from __future__ import annotations

import torch

from t2onet_tpu_torch.models.actor import Actor, select_end_images
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops.color import abs_
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.parallel import mesh


def trainable(actor: Actor, owned_only: bool = True):
    """[(name, parameter)] of the actor's trainable parameters in module
    order; with `owned_only`, under a model group, the heads of other
    ranks left out."""
    own = tuple(f"executor.{OP_NAMES[i]}_op." for i in mesh.owned_heads())
    return [(n, p) for n, p in actor.named_parameters()
            if p.requires_grad and not (owned_only
                                        and n.startswith("executor.")
                                        and not n.startswith(own))]


def _head_of(name: str) -> int:
    """The op index of a head parameter's name, executor.{op}_op.*"""
    return OP_NAMES.index(name.split(".")[1][:-len("_op")])


class TrainState:
    """The actor, its Adam optimizer over the parameters this rank trains
    (`trainable`) and the step count."""

    def __init__(self, actor: Actor, learning_rate: float = 1e-3):
        self.actor = actor
        self.named = trainable(actor)
        self.params = [p for _, p in self.named]
        self.opt = torch.optim.Adam(self.params, lr=learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.step = 0
        self._gathered = None          # (step, the unsharded Adam state)

    def gather(self):
        """Under a model group: broadcast every head's weights and Adam
        moments from its owner, so that every rank's actor and
        `optimizer_state_dict()` are an unsharded state's. Every rank of
        the group calls it; without a model group it does nothing."""
        if mesh.model_size() == 1:
            return
        local = {id(p): self.opt.state[p] for p in self.params
                 if p in self.opt.state}
        # Adam's count: every rank steps its Adam alike
        step = next((st["step"] for st in local.values()), None)
        state = {}
        with torch.no_grad():
            for i, (name, p) in enumerate(trainable(self.actor, False)):
                if name.startswith("executor."):
                    src = mesh.head_owner(_head_of(name))
                    mesh.broadcast_from(p.data, src)
                if step is None:
                    continue
                if id(p) in local:
                    m = local[id(p)]["exp_avg"].clone()
                    v = local[id(p)]["exp_avg_sq"].clone()
                else:
                    m, v = torch.zeros_like(p), torch.zeros_like(p)
                if name.startswith("executor."):
                    mesh.broadcast_from(m, src)
                    mesh.broadcast_from(v, src)
                state[i] = {"step": step.clone(), "exp_avg": m,
                            "exp_avg_sq": v}
        group = dict(self.opt.state_dict()["param_groups"][0])
        group["params"] = list(range(len(trainable(self.actor, False))))
        self._gathered = (self.step, {"state": state,
                                      "param_groups": [group]})

    def optimizer_state_dict(self):
        """The Adam state as an unsharded state holds it: the optimizer's
        own, or under a model group the one `gather` made at this step."""
        if mesh.model_size() == 1:
            return self.opt.state_dict()
        if self._gathered is None or self._gathered[0] != self.step:
            raise RuntimeError("under a model group every rank calls "
                               "TrainState.gather() before a checkpoint")
        return self._gathered[1]

    def apply_gradients(self, loss):
        """Backpropagate `loss`, sum the gradients over the data-parallel
        ranks and take one Adam step over every parameter this rank
        trains. The gradients stay in `.grad` until the next step."""
        adam_step(self.opt, self.params, loss)
        self.step += 1


def adam_step(opt, params, loss):
    """Backpropagate `loss` and step `opt` over `params`: a parameter the
    loss does not reach gets a zero gradient, as optax treats a missing
    one; under a data-parallel group the gradients are summed over the
    ranks first."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.sync_gradients(params)
    opt.step()


def global_metrics(metrics):
    """Detached metrics, each a rank's share of a global loss, summed over
    the ranks in one all-reduce: the global batch's values."""
    if not mesh.active():
        return {k: v.detach() for k, v in metrics.items()}
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach() for k in keys])
    vals = mesh.global_sum(vals)
    return {k: vals[i] for i, k in enumerate(keys)}


def global_draws(generator=None, noise_fn=None, normal_fn=None):
    """(noise_fn, normal_fn) for `Actor.episode` under a data-parallel
    group: each draw is made for the global batch (from the fed function,
    or from `generator`, seeded alike on every rank) and the rank keeps
    its rows, so that every rank sees world size 1's draws. The functions
    as given at world size 1."""
    if not mesh.active():
        return noise_fn, normal_fn
    w = mesh.data_size()

    def rows(kind, fed):
        def fn(shape):
            full = (shape[0] * w,) + tuple(shape[1:])
            if fed is not None:
                draw = fed(full)
            elif generator is None:
                raise ValueError(f"a {kind} draw needs a generator or a fed "
                                 f"noise function")
            elif kind == "gumbel":
                draw = bank.gumbel_noise(full, generator)
            else:
                draw = torch.randn(full, generator=generator,
                                   device=generator.device)
            return mesh.rows_of(draw)
        return fn

    return rows("gumbel", noise_fn), rows("normal", normal_fn)


def supervised_losses(logprobs, pred_params, y, gt_params, null_id: int = 0):
    """(op_loss, param_loss). logprobs (B, T-1, n_cls); pred_params
    (B, T-2, 24); y (B, T); gt_params (B, T-2, 24)."""
    targets = y[:, 1:].long()
    # position i is inside the batch-max step iff any sample still has a
    # non-NULL token there (y is left-packed); the global batch's mask,
    # batch size and nonzero count under data parallelism
    pos_any = (targets != null_id).any(dim=0)
    nnz = (gt_params != 0).sum()
    b = logprobs.shape[0]
    if mesh.active():
        counts = mesh.global_sum(torch.cat([
            pos_any.to(torch.int64), nnz.view(1),
            torch.tensor([b], device=nnz.device)]))
        pos_any, nnz, b = counts[:-2] > 0, counts[-2], counts[-1]
    pos_mask = pos_any.to(logprobs.dtype)
    nll = -torch.gather(logprobs, 2, targets[:, :, None])[..., 0]
    op_loss = (nll * pos_mask[None, :]).sum() / (b * pos_mask.sum())
    param_loss = ((pred_params - gt_params) ** 2).sum() / torch.clamp_min(
        nnz, 1)
    return op_loss, param_loss


def discrete_param_loss(bin_logp, y, gt_params, opcfg, num: int = 10):
    """Bin cross-entropy of the discrete parameter mode: the target is the
    nearest grid bin of the ground-truth scalar under the ground-truth op,
    over steps whose op is discrete-capable with a nonzero ground-truth
    param, normalised like the param MSE.

    bin_logp (B, S, N_OPS, num); y (B, T); gt_params (B, S, 24)."""
    s = bin_logp.shape[1]
    exec_idx = y[:, 1:1 + s].long() - bank.VOCAB_OFFSET
    gt_scalar = gt_params[..., 0]
    bins, sup = bank.gt_param_bins(gt_scalar, exec_idx, opcfg, num)
    safe_idx = torch.clamp(exec_idx, 0, bank.N_OPS - 1)
    lp_op = torch.gather(bin_logp, 2, safe_idx[:, :, None, None].expand(
        -1, -1, 1, num))[:, :, 0]                           # (B, S, num)
    lp = torch.gather(lp_op, 2, bins[:, :, None])[..., 0]
    mask = (sup & (gt_scalar != 0)).to(lp.dtype)
    return -(lp * mask).sum() / torch.clamp_min(mesh.global_sum(mask.sum()),
                                                1.0)


def episode_l1_loss(imgs, ops, gt_img, end_id: int = 2):
    """Mean L1 between the <END>-selected rollout image and gt."""
    pred = select_end_images(imgs, ops, end_id)
    return mesh.global_mean(abs_(pred - gt_img))


def supervised_step(state: TrainState, batch, per_step_bn: bool = False):
    """batch: x (B,L), y (B,T), img_x (B,3,H,W), img_y (B,T-1,3,H,W),
    gt_params (B,T-2,24), all on the actor's device (under data
    parallelism, this rank's rows). `per_step_bn`: one
    ResNet forward per decode step (`Actor.supervised`)."""
    actor = state.actor
    actor.train()
    out = actor.supervised(batch["x"], batch["y"], batch["img_x"],
                           batch["img_y"], per_step_bn=per_step_bn)
    op_loss, param_loss = supervised_losses(out[2], out[1], batch["y"],
                                            batch["gt_params"])
    if actor.cfg.discrete_param:
        param_loss = param_loss + discrete_param_loss(
            out[3], batch["y"], batch["gt_params"], actor.opcfg,
            actor.cfg.discrete_step)
    loss = op_loss + param_loss
    state.apply_gradients(loss)
    return global_metrics({"loss": loss, "op_loss": op_loss,
                           "param_loss": param_loss})


def episode_step(state: TrainState, batch, generator=None, sample=True,
                 fused_exec=False, noise_fn=None, probe_size=None):
    """batch: x (B,L), img_x (B,3,H,W), gt_img (B,3,H,W), and for GIER's
    local edits masks_vocab (B,n_cls,1,H,W), the per-op masks each
    rollout step gathers by its predicted op. With `sample`, ops (and in
    the discrete mode bins) are drawn with Gumbel noise from `generator`
    (or `noise_fn`; under data parallelism both give the global batch's
    draws, `global_draws`); `fused_exec` executes each step through
    `ops.step.fused_step`; `probe_size` decodes each step at that
    resolution while execution and the L1 stay at the batch's."""
    state.actor.train()
    noise_fn, _ = global_draws(generator, noise_fn)
    out = state.actor.episode(batch["x"], batch["img_x"], sample=sample,
                              generator=generator, noise_fn=noise_fn,
                              fused_exec=fused_exec,
                              masks=batch.get("masks_vocab"),
                              probe_size=probe_size)
    loss = episode_l1_loss(out["imgs"], out["ops"], batch["gt_img"])
    state.apply_gradients(loss)
    return global_metrics({"L1_loss": loss})


@torch.no_grad()
def eval_episode(actor: Actor, batch, fused_exec: bool = False):
    """Greedy eval-mode rollout: (each sample's <END> image, rollout).
    Each step executes through the bank, or with `fused_exec` through
    `ops.step.fused_step`, whose forward is the chain kernel at K=1 on a
    CUDA tensor."""
    actor.eval()
    out = actor.episode(batch["x"], batch["img_x"], fused_exec=fused_exec)
    return select_end_images(out["imgs"], out["ops"]), out
