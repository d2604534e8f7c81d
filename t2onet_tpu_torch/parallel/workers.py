"""Rank processes for data-parallel work without torchrun.

`run_ranks(job, world_size, job_dir)` saves a job, starts one process a
rank with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT on a free localhost port, one torch thread
each), waits for them within a time limit and returns each rank's
result. A rank that fails stops the others at once; a rank that outlives
the limit is killed. Each rank runs

    python -m t2onet_tpu_torch.parallel.workers JOB_DIR

which joins the group (`mesh.init_data_parallel`: the job's device and
backend, gloo for the CPU and, when the job asks for it, for ranks that
share one card), runs the job's kind and writes `rank{r}.pt`. The kinds:

- "steps": training steps of the port's trainers, each from its own
  initial weights, on the rank's rows of a global batch: "supervised",
  "episode", "rl" and "gan" (`train.loop`, `train.rl`,
  `cli.train_gan.gan_step`), draws fed for the global batch;
- "bn": a train-mode forward and backward of a flax BatchNorm a case;
- "dryrun": the training surfaces of `parallel.dryrun`.

Each result holds the rank's kernel launch counts (`ops.chain.LAUNCHES`),
which count per process.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 300.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: dict, world_size: int, job_dir: str,
              timeout: float = RANK_TIMEOUT_S, env=None):
    """Run `job` on `world_size` rank processes (with `env` added to their
    environment); returns their results in rank order. Raises
    RuntimeError, with the end of each rank's log, when a rank fails or
    the time limit passes."""
    os.makedirs(job_dir, exist_ok=True)
    torch.save(job, os.path.join(job_dir, "job.pt"))
    port = free_port()
    path = os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    procs, logs = [], []
    for r in range(world_size):
        rank_env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world_size),
                        LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                        PYTHONPATH=path, **(env or {}))
        logs.append(open(os.path.join(job_dir, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "t2onet_tpu_torch.parallel.workers",
             job_dir], env=rank_env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                break
            if time.time() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        tails = []
        for r in range(world_size):
            with open(os.path.join(job_dir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} ---\n" + f.read()[-4000:])
        raise RuntimeError(f"{failed}\n" + "\n".join(tails))
    return [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------

def _tensor(a, device, dtype):
    """A numpy array as a tensor on `device`, floats in `dtype`."""
    t = torch.from_numpy(np.array(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def fed_draws(arrays, device, dtype):
    """fn(shape) handing out `arrays` in order as tensors, each checked
    against the shape asked for (under the group: the global batch's)."""
    it = iter(arrays)

    def fn(shape):
        a = next(it)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"fed draw {a.shape}, asked for {tuple(shape)}")
        return _tensor(a, device, dtype)

    return fn


def param_digest(module) -> str:
    """sha256 over every tensor of the module's state_dict, in order."""
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def build_case_actor(case, device, dtype):
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.models.actor import Actor

    actor = Actor(ModelConfig(**case["cfg"]), OperatorConfig(),
                  case["vocab_size"],
                  generator=torch.Generator().manual_seed(0),
                  explore_prob=case.get("explore_prob", 0.05))
    actor.load_state_dict(case["state_dict"])
    return actor.to(device=device, dtype=dtype)


def run_step_case(case, device):
    """One training step of `case` on this rank's rows: its metrics,
    launches, parameter digest and (with "full", the default; "rank0":
    on rank 0 only) every gradient and the updated state_dict, on the
    CPU. With "validate", rank 0 then runs `loop.eval_episode` on the
    whole batch while the other ranks wait at a barrier, as the trainers
    validate, and returns its images as "val"."""
    from t2onet_tpu_torch.cli.train_gan import GANState, gan_step
    from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses
    from t2onet_tpu_torch.ops import chain
    from t2onet_tpu_torch.parallel import mesh
    from t2onet_tpu_torch.train import loop, rl

    dtype = getattr(torch, case.get("dtype", "float32"))
    actor = build_case_actor(case, device, dtype)
    state = loop.TrainState(actor, learning_rate=case.get("lr", 1e-3))
    batch = {k: _tensor(v, device, dtype)
             for k, v in mesh.rows_of(case["batch"]).items()}
    noise = (fed_draws(case["gumbel"], device, dtype)
             if case.get("gumbel") is not None else None)
    normal = (fed_draws(case["normal"], device, dtype)
              if case.get("normal") is not None else None)
    for k in chain.LAUNCHES:
        chain.LAUNCHES[k] = 0
    kind = case["kind"]
    modules = {"actor": actor}
    if kind == "supervised":
        m = loop.supervised_step(state, batch,
                                 per_step_bn=case.get("per_step_bn", False))
    elif kind == "episode":
        m = loop.episode_step(state, batch, sample=case.get("sample", True),
                              fused_exec=case.get("fused", False),
                              noise_fn=noise)
    elif kind == "rl":
        m = rl.rl_step(state, batch, noise_fn=noise, normal_fn=normal,
                       param_noise=case.get("param_noise", 0.0))
    elif kind == "gan":
        g = case["gan"]
        bundle = DiscBundle(g["hidden_dim"], cond_nc=g.get("cond_nc", 512),
                            ndf=g["ndf"], n_layers=g["n_layers_D"],
                            num_D=g["num_D"])
        bundle.load_state_dict(g["state_dict"])
        bundle = bundle.to(device=device, dtype=dtype)
        gan = GANState(bundle, state.params, g.get("gan_lr", 2e-4),
                       g.get("beta1", 0.5))
        losses = Seq2SeqGANLosses(n_layers=g["n_layers_D"], num_D=g["num_D"],
                                  lambda_feat=g.get("lambda_feat", 10.0))
        m = gan_step(state, gan, batch, losses,
                     fused_exec=case.get("fused", False), noise_fn=noise)
        modules["disc"] = bundle
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "launches": dict(chain.LAUNCHES),
           "digest": {n: param_digest(mod) for n, mod in modules.items()}}
    if case.get("validate"):
        if mesh.rank() == 0:
            imgs, _ = loop.eval_episode(actor, {
                k: _tensor(v, device, dtype)
                for k, v in case["batch"].items()})
            out["val"] = imgs.cpu()
        mesh.barrier()
    full = case.get("full", True)
    if full == "rank0":
        full = mesh.rank() == 0
    if full:
        for n, mod in modules.items():
            out[n] = {
                "grads": {k: p.grad.detach().cpu().clone()
                          for k, p in mod.named_parameters()
                          if p.grad is not None},
                "state_dict": {k: v.detach().cpu().clone()
                               for k, v in mod.state_dict().items()}}
    return out


def run_bn_case(case, device):
    """A flax BatchNorm's train-mode forward and backward of sum(y * g)
    on this rank's rows; the affine gradients summed over the ranks."""
    from t2onet_tpu_torch.models.common import FlaxBatchNorm1d, FlaxBatchNorm2d
    from t2onet_tpu_torch.parallel import mesh

    dtype = getattr(torch, case.get("dtype", "float32"))
    x = np.asarray(case["x"])
    bn = (FlaxBatchNorm1d if x.ndim == 2 else FlaxBatchNorm2d)(
        x.shape[1], eps=1e-5, momentum=0.1).train()
    bn.load_state_dict(case["state_dict"])
    bn = bn.to(device=device, dtype=dtype)
    xt = _tensor(mesh.rows_of(x), device, dtype).requires_grad_(True)
    y = bn(xt)
    (y * _tensor(mesh.rows_of(case["g"]), device, dtype)).sum().backward()
    mesh.sync_gradients([bn.weight, bn.bias])
    return {"y": y.detach().cpu(), "x_grad": xt.grad.cpu(),
            "weight_grad": bn.weight.grad.cpu(),
            "bias_grad": bn.bias.grad.cpu(),
            "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def main(job_dir: str):
    from t2onet_tpu_torch.parallel import mesh
    from t2onet_tpu_torch.precision import set_cuda_precision

    torch.set_num_threads(1)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    device = mesh.init_data_parallel(job.get("device", "cpu"),
                                     job.get("backend"))
    if device.type == "cuda":
        set_cuda_precision()        # TF32 off, as every entry point
    try:
        if job["kind"] == "steps":
            result = {c["name"]: run_step_case(c, device)
                      for c in job["cases"]}
        elif job["kind"] == "bn":
            result = {c["name"]: run_bn_case(c, device)
                      for c in job["cases"]}
        elif job["kind"] == "dryrun":
            from t2onet_tpu_torch.parallel import dryrun

            result = dryrun.training_surfaces(job, device)
        else:
            raise ValueError(f"unknown job kind {job['kind']!r}")
        result["rank"] = mesh.rank()
        torch.save(result, os.path.join(job_dir, f"rank{mesh.rank()}.pt"))
    finally:
        mesh.close_data_parallel()


if __name__ == "__main__":
    main(sys.argv[1])
