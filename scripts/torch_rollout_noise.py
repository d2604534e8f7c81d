"""How far last-bit noise in the vision encoder moves the gradients of one
sampled masked GIER episode step of the PyTorch port, on the CPU.

    python3 scripts/torch_rollout_noise.py

It takes `chip_smoke.py`'s card-vs-CPU step (b8 real GIER items at 64 px,
a full-width actor, fixed Gumbel draws), multiplies every convolution
weight of the ResNet by 1 + u * 2**-23 with u drawn from {-1, 0, 1}, and
reports ||g' - g|| / ||g|| over all gradients and the tensor worst
against `chip_smoke.py`'s per-tensor bound (5e-2 of the tensor's norm
plus 1e-6 of the whole), for 4 noise draws, through the fused step and
through the bank, with the real masks shared out to every op and with
the batch's own masks. A card and a CPU differ in the convolutions' last
bits, so these readings are the scale a card-vs-CPU gradient gap can
reach with every kernel exact. Imports nothing of JAX.
"""

import copy
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import chip_smoke  # noqa: E402
from t2onet_tpu_torch.data.loader import device_put_batch  # noqa: E402
from t2onet_tpu_torch.train import loop  # noqa: E402


def gradients(actor, batch, draws, fused):
    state = loop.TrainState(copy.deepcopy(actor))
    it = iter(draws)
    loop.episode_step(state, batch, noise_fn=lambda s: next(it),
                      fused_exec=fused)
    return {n: p.grad.double() for n, p in state.actor.named_parameters()
            if p.requires_grad}


def main():
    torch.set_num_threads(4)
    for spread in (True, False):
        batch, actor, draws = chip_smoke.gier_step_case(spread_masks=spread)
        batch = device_put_batch(batch, "cpu")
        for fused in (True, False):
            g0 = gradients(actor, batch, draws, fused)
            total = math.sqrt(sum(float((g * g).sum()) for g in g0.values()))
            readings = []
            for seed in range(1, 5):
                noisy = copy.deepcopy(actor)
                gen = torch.Generator().manual_seed(seed)
                with torch.no_grad():
                    for n, p in noisy.named_parameters():
                        if n.startswith("vis_encoder") and p.dim() == 4:
                            u = torch.randint(-1, 2, p.shape, generator=gen)
                            p.mul_(1 + u.float() * 2.0 ** -23)
                g1 = gradients(noisy, batch, draws, fused)
                diff = math.sqrt(sum(float(((g1[n] - g0[n]) ** 2).sum())
                                     for n in g0))
                worst = max((float((g1[n] - g0[n]).norm())
                             / (0.05 * float(g0[n].norm()) + 1e-6 * total), n)
                            for n in g0)
                readings.append((diff / total, round(worst[0], 4), worst[1]))
            print(f"masks {'on every op' if spread else 'of the batch'}, "
                  f"{'fused step' if fused else 'bank'}: (||g' - g|| / ||g||,"
                  f" worst tensor's error / bound, its name) for 4 noise "
                  f"draws: {[(f'{r:.3e}', w, n) for r, w, n in readings]}",
                  flush=True)


if __name__ == "__main__":
    main()
