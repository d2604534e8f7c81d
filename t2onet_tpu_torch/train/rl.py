"""RL fine-tuning (counterpart of `t2onet_tpu.train.rl`): REINFORCE over
the op choices plus the pathwise gradient of the end image's L1 through
the operator chain, with the reference's entropy penalty.

- Ops: REINFORCE with a batch-mean baseline and the reward's spread as
  its scale. The reward is the negative L1 of each sample's <END> image
  to the ground truth; each sample's advantage weights the sum of its
  chosen ops' log-probs up to and including its first <END>.
- Parameters: the pathwise gradient of the same L1 through the executed
  ops (the episode phase's gradient).
- Entropy: `get_entropy_penalty` (log n_cls - H) over the same steps,
  scaled by `entropy_factor`. The default is 0.01, the JAX CLI's: the
  JAX library's 0.05 (the reference flag) measurably drowned the
  REINFORCE signal there.

The rollout samples on policy (the CLI sets explore_prob 0), optionally
with noise on the parameters, and executes through the bank, as the JAX
package's `make_rl_step` does: it launches no kernel.

Under a data-parallel group (`parallel/mesh.py`) the baseline and the
spread are the global batch's, every mean divides by the global batch,
and the draws are the global batch's rows, as in `train/loop.py`.
"""

from __future__ import annotations

import torch

from t2onet_tpu_torch.models.actor import (get_entropy_penalty,
                                           select_end_images)
from t2onet_tpu_torch.ops.color import abs_
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.train.loop import (TrainState, global_draws,
                                         global_metrics)

ENTROPY_FACTOR = 0.01
PG_WEIGHT = 0.1


def rl_losses(out, gt_img, end_id: int = 2,
              entropy_factor: float = ENTROPY_FACTOR,
              pg_weight: float = PG_WEIGHT):
    """(total loss, metrics) from an episode rollout dict (imgs, ops,
    logprobs) and the ground-truth images (B, 3, H, W)."""
    imgs, ops, logprobs = out["imgs"], out["ops"], out["logprobs"]
    pred = select_end_images(imgs, ops, end_id)
    per_sample_l1 = abs_(pred - gt_img).mean(dim=(1, 2, 3))        # (B,)

    # steps up to and including each sample's first <END> count
    is_end = (ops == end_id).to(torch.int32)
    after_end = (torch.cumsum(is_end, dim=1) - is_end) > 0
    step_w = 1.0 - after_end.to(logprobs.dtype)                    # (B, S)
    chosen_lp = torch.gather(logprobs, 2, ops[..., None].long())[..., 0]

    reward = -per_sample_l1
    with torch.no_grad():
        baseline, spread = _mean_std(reward)
        adv = (reward - baseline) / (spread + 1e-4)
    n_steps = torch.clamp_min(step_w.sum(dim=1), 1.0)
    pg_loss = -mesh.global_mean((adv[:, None] * chosen_lp * step_w)
                                .sum(dim=1) / n_steps)
    ent_loss = mesh.global_mean(
        (get_entropy_penalty(logprobs)[..., 0] * step_w).sum(dim=1))
    l1_loss = mesh.global_mean(per_sample_l1)
    total = l1_loss + pg_weight * pg_loss + entropy_factor * ent_loss
    return total, {"rl_l1": l1_loss, "rl_pg": pg_loss,
                   "rl_entropy": ent_loss,
                   "rl_reward": mesh.global_mean(reward)}


def _mean_std(x):
    """The mean and biased spread of (B,) `x` over the global batch (two
    passes, as jnp.std); x.mean(), x.std(correction=0) at world size 1."""
    if not mesh.active():
        return x.mean(), x.std(correction=0)
    n = mesh.global_sum(torch.tensor(float(x.numel()), dtype=x.dtype,
                                     device=x.device))
    mean = mesh.global_sum(x.sum()) / n
    var = mesh.global_sum(((x - mean) ** 2).sum()) / n
    return mean, torch.sqrt(var)


def rl_step(state: TrainState, batch, generator=None,
            entropy_factor: float = ENTROPY_FACTOR,
            param_noise: float = 0.0, pg_weight: float = PG_WEIGHT,
            noise_fn=None, normal_fn=None):
    """One RL step: a sampled train-mode rollout through the bank (with
    `param_noise` > 0, noise on the parameters), `rl_losses`, one Adam
    step. batch: x (B,L), img_x (B,3,H,W), gt_img (B,3,H,W) on the
    actor's device. Draws from `generator`, or the fed `noise_fn`
    (Gumbel) and `normal_fn` (normal) as `Actor.episode` takes them.
    Returns the metrics as tensors on the device."""
    state.actor.train()
    noise_fn, normal_fn = global_draws(generator, noise_fn, normal_fn)
    out = state.actor.episode(batch["x"], batch["img_x"], sample=True,
                              generator=generator, noise_fn=noise_fn,
                              normal_fn=normal_fn, param_noise=param_noise)
    total, metrics = rl_losses(out, batch["gt_img"],
                               entropy_factor=entropy_factor,
                               pg_weight=pg_weight)
    state.apply_gradients(total)
    return global_metrics({"rl_loss": total, **metrics})
