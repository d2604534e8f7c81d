"""Devices and data parallelism (counterpart of `t2onet_tpu.parallel.mesh`).

The JAX package runs data parallelism as one process over a 1-D device
mesh: the batch is sharded over it, and every reduction of a jitted step
(BatchNorm statistics, loss divisors, gradients) is taken over the whole
batch. The port splits that into two forms:

- **A `Mesh`** is an ordered list of `torch.device`s for work that needs
  no collective (the sharded chain, serving, the planner): shard i is the
  i-th contiguous block of rows, as `P(axis)` cuts it, run on the mesh's
  i-th device and gathered back in order. A mesh may name one device more
  than once (`[cpu, cpu]`, `[cuda:0, cuda:0]`), which tests the split on
  one device.
- **A data-parallel group** is one process per rank over
  `torch.distributed` (NCCL for CUDA, gloo for the CPU), joined from
  torchrun's environment. Each rank keeps its rows of the global batch
  (`rows_of`); the losses take their divisors from the global batch
  (`global_sum`, `global_mean`), BatchNorm its statistics
  (`models.common`), and `sync_gradients` sums the gradients, so that a
  step at world size W is the step of world size 1 up to the order of
  summation. At world size 1, with a group of one rank or with none,
  nothing is reduced and every step is exactly the one-process step.
- **A (data x model) grid** (`make_2d_mesh`, JAX's 2-D mesh) carves the
  group into data groups and model groups: rank r sits at (r //
  model_par, r % model_par). Each model group shares one block of rows
  and splits the eight parameter heads (`owned_heads`), computing its
  block of them (the input's gradient summed over the model group,
  `heads_input`) and gathering the features (`gather_heads`); the data
  group is what every reduction above runs over. Each rank's Adam holds
  moments for the heads it owns only: JAX's `state_shardings` and
  `shard_state` put the heads and their moments on the model axis, and
  here `train.loop.TrainState` builds its Adam over `trainable(actor)`,
  which under a grid leaves the other ranks' heads out. The grid is
  process-wide, as the process group it divides.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
N_HEADS = 8                 # the parameter heads a model group splits
JOIN_TIMEOUT_S = 60.0


class Mesh:
    """An ordered list of devices; shard i of a batch runs on devices[i]."""

    def __init__(self, devices: Sequence):
        """A bare "cuda" names the current card."""
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> List[torch.device]:
        """The devices in first-use order, each once."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def _indexed(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh over `devices`, or over every visible card (the CPU, once,
    when `device` is "cpu"); with `n_devices` over the first n of them. On
    the CPU `n_devices` names the CPU n times. Asking for more cards than
    are visible raises."""
    kind = torch.device(device).type
    if devices is None:
        if kind == "cpu":
            devices = ["cpu"] * (n_devices or 1)
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: PyTorch finds no CUDA card "
                                   "here; pass device='cpu'")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"a mesh of {n_devices} devices asked for, "
                             f"{len(devices)} visible")
        devices = devices[:n_devices]
    return Mesh(devices)


def as_mesh(mesh) -> Mesh:
    """A Mesh, or a sequence of devices made into one."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def shard_rows(n: int, mesh: Mesh, what: str = "batch") -> List[slice]:
    """The contiguous row block of each shard; n must divide evenly, as
    a `P(axis)` sharding needs."""
    if n % mesh.size:
        raise ValueError(f"{what} {n} not divisible by the {DATA_AXIS!r} "
                         f"mesh axis size {mesh.size}")
    per = n // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def pad_rows(a: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 to a multiple of `multiple` by repeating the last row, as
    the JAX planner and engine pad."""
    pad = (-a.shape[0]) % multiple
    if not pad:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A tensor cut into the mesh's row blocks, each moved to its device:
    a list with one entry per shard."""
    return [batch[rows].to(dev, non_blocking=True)
            for rows, dev in zip(shard_rows(batch.shape[0], mesh),
                                 mesh.devices)]


# ---------------------------------------------------------------------------
# the data-parallel group
# ---------------------------------------------------------------------------

def init_data_parallel(device="cuda", backend: Optional[str] = None,
                       timeout: Optional[float] = JOIN_TIMEOUT_S):
    """Join the group torchrun's environment describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for a CUDA device, gloo
    for the CPU, unless `backend` names one. Returns this rank's device:
    `cuda:{LOCAL_RANK}` for a bare "cuda", else `device` itself (two
    ranks may share one card over gloo). A collective that waits longer
    than `timeout` seconds raises instead of hanging (None: torch's
    default, for trainers whose other ranks wait while rank 0 validates
    and writes a checkpoint)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend, init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return device


def launched_by_torchrun() -> bool:
    """True when torchrun's environment names this process's rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def close_data_parallel():
    global _GRID
    _GRID = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# ---------------------------------------------------------------------------
# the (data x model) grid
# ---------------------------------------------------------------------------

class Grid:
    """The (data x model) layout of the group's ranks: this rank's place
    and its two groups (None without a process group)."""

    def __init__(self, data_par, model_par, data_rank, model_rank,
                 data_group, model_group, model_ranks):
        self.data_par, self.model_par = data_par, model_par
        self.data_rank, self.model_rank = data_rank, model_rank
        self.data_group, self.model_group = data_group, model_group
        self.model_ranks = model_ranks      # world ranks, in model order

    def __repr__(self):
        return (f"Grid(({self.data_par}x{self.model_par}), at "
                f"({self.data_rank}, {self.model_rank}))")


_GRID: Optional[Grid] = None


def make_2d_mesh(model_par: int = 2) -> Grid:
    """Lay the joined group out as (world / model_par) x model_par (the
    counterpart of JAX's `make_2d_mesh`): batch rows over `data`, the
    eight parameter heads over `model`. Every rank calls it, since each
    creates every group. model_par must divide both 8 and the world."""
    global _GRID
    w = world_size()
    if N_HEADS % model_par:
        raise ValueError(f"{N_HEADS} op heads not divisible by "
                         f"model_par={model_par}")
    if w % model_par:
        raise ValueError(f"{w} devices not divisible by "
                         f"model_par={model_par}")
    r, dp = rank(), w // model_par
    data_group = model_group = None
    model_ranks = [r]
    if dist.is_available() and dist.is_initialized():
        # torch.distributed wants every rank to create every group, in
        # one order
        for j in range(model_par):
            ranks = [i * model_par + j for i in range(dp)]
            group = dist.new_group(ranks)
            if r in ranks:
                data_group = group
        for i in range(dp):
            ranks = list(range(i * model_par, (i + 1) * model_par))
            group = dist.new_group(ranks)
            if r in ranks:
                model_group, model_ranks = group, ranks
    _GRID = Grid(dp, model_par, r // model_par, r % model_par, data_group,
                 model_group, model_ranks)
    return _GRID


def data_size() -> int:
    """The ranks of this rank's data group: the ways the batch is split."""
    return _GRID.data_par if _GRID is not None else world_size()


def data_rank() -> int:
    return _GRID.data_rank if _GRID is not None else rank()


def _data_group():
    return _GRID.data_group if _GRID is not None else None


def model_size() -> int:
    """The ranks that split the heads with this one (1 without a grid)."""
    return _GRID.model_par if _GRID is not None else 1


def model_rank() -> int:
    return _GRID.model_rank if _GRID is not None else 0


def owned_heads(n: int = N_HEADS) -> range:
    """The heads this rank computes and steps: its model rank's block of
    n / model_size() (all n without a grid)."""
    k = n // model_size()
    return range(model_rank() * k, (model_rank() + 1) * k)


def head_owner(i: int, n: int = N_HEADS) -> int:
    """The world rank, in this rank's model group, that owns head i."""
    if _GRID is None:
        return rank()
    return _GRID.model_ranks[i // (n // model_size())]


class _GatherHeads(torch.autograd.Function):
    """(B, k, P) features of this rank's block of heads -> (B, n, P) of
    every block, in model order. gloo moves CUDA tensors by broadcast and
    all-reduce alone, so the blocks meet in one all-reduce of a tensor
    that is zero outside each rank's block. The backward takes this
    rank's block of the gradient: the loss is the same on every rank of
    the model group, so nothing is summed there."""

    @staticmethod
    def forward(ctx, t, n):
        k = t.shape[1]
        lo = model_rank() * k
        full = t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))
        full[:, lo:lo + k] = t
        dist.all_reduce(full, group=_GRID.model_group)
        ctx.block = (lo, k)
        return full

    @staticmethod
    def backward(ctx, grad):
        lo, k = ctx.block
        return grad[:, lo:lo + k].contiguous(), None


def gather_heads(t: torch.Tensor, n: int = N_HEADS) -> torch.Tensor:
    """Differentiable gather of the model group's head blocks along dim 1
    (`t` itself without a model group)."""
    if model_size() == 1:
        return t
    return _GatherHeads.apply(t, n)


class _HeadsInput(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group, since each rank's block of heads adds its share of it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_GRID.model_group)
        return grad


def heads_input(t: torch.Tensor) -> torch.Tensor:
    """The heads' input under a model group: the same values, with its
    gradient summed over the group in the backward (`t` itself without a
    model group)."""
    if model_size() == 1:
        return t
    return _HeadsInput.apply(t)


def broadcast_from(t: torch.Tensor, src: int):
    """Broadcast `t` in place from world rank `src` over this rank's
    model group."""
    dist.broadcast(t, src=src, group=_GRID.model_group)


def active() -> bool:
    """A data group of more than one rank: reductions cross ranks."""
    return data_size() > 1


def barrier():
    if active():
        dist.barrier()


def rows_of(batch, n_global: Optional[int] = None):
    """This rank's contiguous rows of a global batch (a numpy array,
    tensor or dict of them; other values pass as they are): its data
    rank's block. The global batch must divide evenly over the data
    group."""
    if isinstance(batch, dict):
        return {k: rows_of(v, n_global) for k, v in batch.items()}
    if not hasattr(batch, "shape") or not active():
        return batch
    n = batch.shape[0] if n_global is None else n_global
    w = data_size()
    if n % w:
        raise ValueError(f"global batch {n} not divisible by the data "
                         f"group's size {w}")
    per = n // w
    return batch[data_rank() * per:(data_rank() + 1) * per]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group (no gradient; `t` itself at
    world size 1)."""
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_data_group())
    return t


def global_max(t: torch.Tensor) -> torch.Tensor:
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_data_group())
    return t


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t`'s elements over the global batch, as the local sum
    over the global count: summed over the ranks it is the global mean,
    and so are the summed gradients. `t.mean()` at world size 1."""
    if not active():
        return t.mean()
    n = global_sum(torch.tensor(float(t.numel()), dtype=torch.float64,
                                device=t.device))
    return t.sum() / n.to(t.dtype)


class _SumAcrossRanks(torch.autograd.Function):
    """all_reduce(SUM) over the data group whose backward all-reduces the
    incoming gradient, so that a gradient reaches every rank's inputs of
    the sum."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=_data_group())
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=_data_group())
        return grad


def sum_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the data group (`t` at world size 1)."""
    if not active():
        return t
    return _SumAcrossRanks.apply(t)


def sync_gradients(params: Sequence[torch.Tensor]):
    """Sum every parameter's `.grad` over the data group in one
    all-reduce (per dtype). The losses carry global divisors, so the sum
    is the global gradient. Nothing at world size 1. Under a grid that is
    a rank's own heads and the replicated rest: the model group computes
    the same loss, so nothing is summed over it."""
    if not active():
        return
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=_data_group())
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
