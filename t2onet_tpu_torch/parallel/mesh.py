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
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
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


def active() -> bool:
    """A group of more than one rank: reductions cross ranks."""
    return world_size() > 1


def barrier():
    if active():
        dist.barrier()


def rows_of(batch, n_global: Optional[int] = None):
    """This rank's contiguous rows of a global batch (a numpy array,
    tensor or dict of them; other values pass as they are). The global
    batch must divide evenly over the ranks."""
    if isinstance(batch, dict):
        return {k: rows_of(v, n_global) for k, v in batch.items()}
    if not hasattr(batch, "shape") or not active():
        return batch
    n = batch.shape[0] if n_global is None else n_global
    w = world_size()
    if n % w:
        raise ValueError(f"global batch {n} not divisible by the world "
                         f"size {w}")
    per = n // w
    return batch[rank() * per:(rank() + 1) * per]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (no gradient; `t` itself at world
    size 1)."""
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_max(t: torch.Tensor) -> torch.Tensor:
    if not active():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
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
    """all_reduce(SUM) whose backward all-reduces the incoming gradient,
    so that a gradient reaches every rank's inputs of the sum."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def sum_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the ranks (`t` at world size 1)."""
    if not active():
        return t
    return _SumAcrossRanks.apply(t)


def sync_gradients(params: Sequence[torch.Tensor]):
    """Sum every parameter's `.grad` over the ranks in one all-reduce
    (per dtype). The losses carry global divisors, so the sum is the
    global gradient. Nothing at world size 1."""
    if not active():
        return
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
