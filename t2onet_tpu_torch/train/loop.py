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
"""

from __future__ import annotations

import torch

from t2onet_tpu_torch.models.actor import Actor, select_end_images
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops.color import abs_


class TrainState:
    """The actor, its Adam optimizer and the step count."""

    def __init__(self, actor: Actor, learning_rate: float = 1e-3):
        self.actor = actor
        self.params = [p for p in actor.parameters() if p.requires_grad]
        self.opt = torch.optim.Adam(self.params, lr=learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def apply_gradients(self, loss):
        """Backpropagate `loss` and take one Adam step over every
        trainable parameter. The gradients stay in `.grad` until the next
        step."""
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        self.step += 1


def supervised_losses(logprobs, pred_params, y, gt_params, null_id: int = 0):
    """(op_loss, param_loss). logprobs (B, T-1, n_cls); pred_params
    (B, T-2, 24); y (B, T); gt_params (B, T-2, 24)."""
    b = logprobs.shape[0]
    targets = y[:, 1:].long()
    # position i is inside the batch-max step iff any sample still has a
    # non-NULL token there (y is left-packed)
    pos_mask = (targets != null_id).any(dim=0).to(logprobs.dtype)
    nll = -torch.gather(logprobs, 2, targets[:, :, None])[..., 0]
    op_loss = (nll * pos_mask[None, :]).sum() / (b * pos_mask.sum())
    nnz = (gt_params != 0).sum()
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
    return -(lp * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def episode_l1_loss(imgs, ops, gt_img, end_id: int = 2):
    """Mean L1 between the <END>-selected rollout image and gt."""
    pred = select_end_images(imgs, ops, end_id)
    return abs_(pred - gt_img).mean()


def supervised_step(state: TrainState, batch, per_step_bn: bool = False):
    """batch: x (B,L), y (B,T), img_x (B,3,H,W), img_y (B,T-1,3,H,W),
    gt_params (B,T-2,24), all on the actor's device. `per_step_bn`: one
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
    return {"loss": loss.detach(), "op_loss": op_loss.detach(),
            "param_loss": param_loss.detach()}


def episode_step(state: TrainState, batch, generator=None, sample=True,
                 fused_exec=False, noise_fn=None, probe_size=None):
    """batch: x (B,L), img_x (B,3,H,W), gt_img (B,3,H,W), and for GIER's
    local edits masks_vocab (B,n_cls,1,H,W), the per-op masks each
    rollout step gathers by its predicted op. With `sample`, ops (and in
    the discrete mode bins) are drawn with Gumbel noise from `generator`
    (or `noise_fn`); `fused_exec` executes each step through
    `ops.step.fused_step`; `probe_size` decodes each step at that
    resolution while execution and the L1 stay at the batch's."""
    state.actor.train()
    out = state.actor.episode(batch["x"], batch["img_x"], sample=sample,
                              generator=generator, noise_fn=noise_fn,
                              fused_exec=fused_exec,
                              masks=batch.get("masks_vocab"),
                              probe_size=probe_size)
    loss = episode_l1_loss(out["imgs"], out["ops"], batch["gt_img"])
    state.apply_gradients(loss)
    return {"L1_loss": loss.detach()}


@torch.no_grad()
def eval_episode(actor: Actor, batch, fused_exec: bool = False):
    """Greedy eval-mode rollout: (each sample's <END> image, rollout).
    Each step executes through the bank, or with `fused_exec` through
    `ops.step.fused_step`, whose forward is the chain kernel at K=1 on a
    CUDA tensor."""
    actor.eval()
    out = actor.episode(batch["x"], batch["img_x"], fused_exec=fused_exec)
    return select_end_images(out["imgs"], out["ops"]), out
