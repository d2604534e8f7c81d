"""Planner fleet launcher: fan planning out over workers / hosts
(counterpart of `t2onet_tpu.cli.plan_fleet`).

The planning stage is embarrassingly parallel over (input, target) pairs —
each pair writes its own `{phase}{i}/{i:05d}.json` (the layout the Act
datasets consume, reference preprocess/gen_greedy_seqs_FiveK.py:66-83).
The reference runs it as one sequential host process; here the index
range shards:

- **Local fan-out** (`--workers N`): N subprocesses of
  `t2onet_tpu_torch.cli.plan_fivek` on this host, each planning a
  contiguous index chunk (`--worker_cpu` passes them `--device cpu`).
  The workers share the card, so local fan-out is mainly for CPU
  planning or overlapping the host-side JSON/JPEG writes; the batched
  fitter (`--pair_batch`, and `--data_parallel` over cards) is the
  card's throughput lever.
- **Fleet sharding** (`--shard_id I --num_shards S`): this invocation
  plans the contiguous index range [I*ceil(T/S), min((I+1)*ceil(T/S), T))
  — run one per host of a fleet against a shared filesystem. No
  collectives are needed for this stage: it is a pure scatter of indices
  and gather of files, so DCN only carries the filesystem traffic.
- **Verification** (`--verify_only`): scan the output dir for missing /
  unparsable items in [start, total) and exit non-zero if any — the
  "gather" step before training consumes the actions.

  python -m t2onet_tpu_torch.cli.plan_fleet --synthetic --total 32 \
      --workers 4 --worker_cpu
  python -m t2onet_tpu_torch.cli.plan_fleet --synthetic --total 32 \
      --shard_id 2 --num_shards 8            # on host 2 of 8
  python -m t2onet_tpu_torch.cli.plan_fleet --total 17325 --verify_only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def shard_range(total: int, shard_id: int, num_shards: int):
    """Contiguous [start, end) for this shard (last shard may be short)."""
    per = (total + num_shards - 1) // num_shards
    start = shard_id * per
    return start, min(start + per, total)


def verify(out_dir: str, phase: str, start: int, end: int):
    """Return sorted list of missing/bad indices in [start, end)."""
    bad = []
    for i in range(start, end):
        path = os.path.join(out_dir, f"{phase}{i}", f"{i:05d}.json")
        try:
            with open(path) as f:
                info = json.load(f)
            if "operation sequence" not in info:
                bad.append(i)
        except (OSError, json.JSONDecodeError):
            bad.append(i)
    return bad


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--total", type=int, required=False, default=None,
                   help="total pairs to plan (defaults to dataset size)")
    p.add_argument("--workers", type=int, default=1,
                   help="local subprocess fan-out")
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--out_dir", default="output/actions_set_1")
    p.add_argument("--phase", default="train")
    p.add_argument("--verify_only", action="store_true")
    p.add_argument("--worker_cpu", action="store_true",
                   help="pass --device cpu to workers (CPU planning fleet)")
    p.add_argument("--log_dir", default=None,
                   help="worker stdout/stderr files (default {out_dir}/logs)")
    # passthrough planner knobs (subset of plan_fivek)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_n", type=int, default=512)
    p.add_argument("--img_size", type=int, default=128)
    p.add_argument("--data_dir", default="data")
    p.add_argument("--session", type=int, default=1)
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--err", type=float, default=1e-2)
    p.add_argument("--mode", default="plain")
    p.add_argument("--n_starts", type=int, default=2)
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--pair_batch", type=int, default=1)
    p.add_argument("--dist_type", default="l1",
                   help="l1 | l2 | seq2seqGAN-disc (case-insensitive; "
                        "'disc' is an alias)")
    # disc-distance knobs, forwarded to plan_fivek when
    # --dist_type seq2seqGAN-disc (plan_fivek exits without them)
    p.add_argument("--disc_run_dir", default=None)
    p.add_argument("--torch_gan_ckpt", default=None)
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    return p


def _dataset_size(a) -> int:
    if a.synthetic:
        n = a.synthetic_n
        return n if a.phase == "train" else max(n // 8, 16)
    from t2onet_tpu_torch.data.fivek import FiveK

    ds = FiveK(os.path.join(a.data_dir, "FiveK", "images"),
               os.path.join(a.data_dir, "FiveK", "annotations"),
               a.phase, a.session, a.img_size)
    return len(ds)


def worker_cmd(a, start: int, count: int):
    cmd = [sys.executable, "-m", "t2onet_tpu_torch.cli.plan_fivek",
           "--start", str(start), "--limit", str(count),
           "--out_dir", a.out_dir, "--phase", a.phase,
           "--img_size", str(a.img_size), "--session", str(a.session),
           "--data_dir", a.data_dir,
           "--beam_size", str(a.beam_size), "--err", str(a.err),
           "--mode", a.mode, "--n_starts", str(a.n_starts),
           "--n_iters", str(a.n_iters), "--lr", str(a.lr),
           "--pair_batch", str(a.pair_batch), "--dist_type", a.dist_type]
    if a.dist_type == "seq2seqGAN-disc":
        if a.disc_run_dir:
            cmd += ["--disc_run_dir", a.disc_run_dir]
        if a.torch_gan_ckpt:
            cmd += ["--torch_gan_ckpt", a.torch_gan_ckpt]
        cmd += ["--num_D", str(a.num_D), "--n_layers_D", str(a.n_layers_D)]
    if a.synthetic:
        cmd += ["--synthetic", "--synthetic_n", str(a.synthetic_n)]
    if a.worker_cpu:
        cmd += ["--device", "cpu"]
    return cmd


def main(argv=None):
    a = build_parser().parse_args(argv)
    # canonicalize BEFORE the guard and worker_cmd: plan_fivek accepts
    # case-insensitive spellings and the 'disc' alias — an accepted alias
    # must still forward the disc args to every worker
    if a.dist_type.lower() in ("seq2seqgan-disc", "disc"):
        a.dist_type = "seq2seqGAN-disc"
    if (a.dist_type == "seq2seqGAN-disc" and not a.disc_run_dir
            and not a.torch_gan_ckpt):
        raise SystemExit("--dist_type seq2seqGAN-disc needs --disc_run_dir "
                         "or --torch_gan_ckpt (forwarded to every worker)")
    total = a.total if a.total is not None else _dataset_size(a)
    start, end = shard_range(total, a.shard_id, a.num_shards)

    if a.verify_only:
        bad = verify(a.out_dir, a.phase, start, end)
        print(json.dumps({"checked": end - start, "missing": len(bad),
                          "first_missing": bad[:20]}))
        sys.exit(1 if bad else 0)

    log_dir = a.log_dir or os.path.join(a.out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)

    # split this shard's range over local workers
    n_items = end - start
    per = (n_items + a.workers - 1) // max(a.workers, 1)
    procs, logs = [], []
    t0 = time.time()
    for w in range(a.workers):
        w_start = start + w * per
        w_count = min(per, end - w_start)
        if w_count <= 0:
            break
        log_path = os.path.join(
            log_dir, f"shard{a.shard_id}_worker{w}.log")
        logf = open(log_path, "w")
        env = dict(os.environ)
        p = subprocess.Popen(worker_cmd(a, w_start, w_count),
                             stdout=logf, stderr=subprocess.STDOUT, env=env)
        procs.append((p, w_start, w_count, log_path))
        logs.append(logf)
        print(f"worker {w}: pairs [{w_start}, {w_start + w_count}) "
              f"-> {log_path}", flush=True)

    failures = 0
    for p, w_start, w_count, log_path in procs:
        rc = p.wait()
        if rc != 0:
            failures += 1
            print(f"WORKER FAILED rc={rc} range=[{w_start},"
                  f"{w_start + w_count}) log={log_path}", flush=True)
    for f in logs:
        f.close()

    bad = verify(a.out_dir, a.phase, start, end)
    dt = time.time() - t0
    print(json.dumps({
        "shard": [a.shard_id, a.num_shards],
        "range": [start, end],
        "workers": len(procs),
        "worker_failures": failures,
        "missing_after": len(bad),
        "pairs_per_sec": round((end - start - len(bad)) / max(dt, 1e-9), 3),
    }))
    sys.exit(1 if (failures or bad) else 0)


if __name__ == "__main__":
    main()
