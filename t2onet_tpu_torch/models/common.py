"""Shared cells, flax-semantics BatchNorm, and the seeded torch-default
initialisation."""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.parallel import mesh


class _FlaxBatchNorm:
    """BatchNorm whose train-mode running statistics follow
    `flax.linen.BatchNorm(momentum=0.9)`: the batch variance is the biased
    one, mean(x^2) - mean(x)^2 clipped at 0, and each update keeps 0.9 of
    the old value (torch would use the unbiased variance). Normalisation
    uses the batch statistics, with gradients through them, as torch's
    does; eval mode and the state_dict names are torch's.

    Under a data-parallel group of more than one rank the statistics are
    the global batch's, as under JAX's sharded batch: the per-channel sum,
    sum of squares and count are summed over the ranks in one
    differentiable all-reduce (its backward sums the gradients too), and
    the input is normalised with the global mean and biased variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return self._train_forward(x, update=True)

    def _train_forward(self, x, update: bool):
        self._check_input_dim(x)
        if mesh.active():
            return self._global_forward(x, update)
        if update:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                xd = x.detach()
                mean = xd.mean(dims)
                var = torch.clamp_min((xd * xd).mean(dims) - mean * mean,
                                      0.0)
                self._move_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _move_running(self, mean, var):
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var
                                   + (1.0 - keep) * var)
            self.num_batches_tracked.add_(1)

    def _global_forward(self, x, update: bool):
        c = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xs.new_full((1,), float(x.numel() // c))
        sums = mesh.sum_across_ranks(torch.cat([xs.sum(dims),
                                                (xs * xs).sum(dims), count]))
        n = sums[-1]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
        if update:
            self._move_running(mean.detach(), var.detach())
        shape = (1, c) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xs - mean.view(shape)) * scale.view(shape) \
            + self.bias.view(shape)
        return y.to(x.dtype)


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


def checked_device(device) -> torch.device:
    """`device` as a torch.device for a loader: the card by default, and
    CUDA where PyTorch finds no card raises rather than load on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: PyTorch finds no CUDA card "
                           f"here; pass device='cpu' to load on the CPU")
    return device


def freeze_second_lstm_bias(lstm: nn.LSTM):
    """The JAX package's LSTM has one bias; torch's has b_ih and b_hh. Keep
    b_ih as that bias and hold b_hh at zero and out of training, so that
    an optimizer step moves the sum as JAX moves its one bias."""
    for name, p in lstm.named_parameters():
        if name.startswith("bias_hh"):
            p.requires_grad_(False)


def lstm_step(x, carry, w_ih, w_hh, b_ih, b_hh):
    """One LSTM cell step in torch's layout and gate order (i, f, g, o).

    x (B, in); carry (h, c) each (B, H); w_ih (4H, in), w_hh (4H, H).
    Returns the new (h, c)."""
    h, c = carry
    gates = x @ w_ih.t() + b_ih + h @ w_hh.t() + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def _uniform(t, lim, generator):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * lim)


@torch.no_grad()
def init_torch_defaults(module: nn.Module, generator: torch.Generator):
    """Draw every parameter as torch's own defaults do, from `generator`
    (a CPU generator, so one seed gives the same weights on any device):
    Linear and Conv2d U(+-1/sqrt(fan_in)) for weight and bias, LSTM
    U(+-1/sqrt(hidden)) with the frozen b_hh then set to 0, Embedding
    N(0, 1), BatchNorm weight 1, bias 0, running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            lim = 1.0 / math.sqrt(fan_in)
            _uniform(m.weight, lim, generator)
            if m.bias is not None:
                _uniform(m.bias, lim, generator)
        elif isinstance(m, nn.LSTM):
            lim = 1.0 / math.sqrt(m.hidden_size)
            for name, p in m.named_parameters():
                _uniform(p, lim, generator)
                if name.startswith("bias_hh"):
                    p.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
