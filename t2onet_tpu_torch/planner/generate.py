"""Planner dataset runs: pseudo ground-truth action sequences
(counterpart of `t2onet_tpu.planner.generate`).

Writes the layout the datasets read:

  {out_dir}/{phase}{i}/{i:05d}.json
      {"request": ..., "init distance": d0,
       "operation sequence": [[(op_name, params, dist), ...] x beam]}
  {out_dir}/{phase}{i}/edit{k}.jpg    per-step images of the top beam

FiveK defaults: beam 3, ops [0,1,2,3,5,6] (no inpaint or white), err
1e-2, L1 distance. GIER adds masks and all 8 ops with err 1e-3.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Optional, Sequence

import numpy as np

from t2onet_tpu_torch.evals.visualize import save_img
from t2onet_tpu_torch.planner.beam import (batch_beam_search, beam_search,
                                           init_distance)
from t2onet_tpu_torch.planner.fit import DEFAULT_PLAN_OPS


def plan_pair(img_x: np.ndarray, img_y: np.ndarray, request: str,
              out_dir: str, index: int, phase: str = "train",
              beam_size: int = 3,
              operations: Sequence[int] = DEFAULT_PLAN_OPS,
              max_step: Optional[int] = None, err: float = 1e-2,
              mode: str = "plain", n_starts: int = 2, n_iters: int = 100,
              lr: float = 0.05, seed: int = 0, dist_type: str = "l1",
              score_fn=None, score_aux=None, device="cuda") -> dict:
    """Plan one (input, target) pair and write its JSON and edit
    images; the beam search's seed is `seed + index`. dist_type, or
    score_fn with score_aux, select the candidate distance (see
    planner.beam.beam_search)."""
    if max_step is None:
        max_step = len(operations)
    actions, images = beam_search(
        img_x, img_y, beam_size=beam_size, operations=operations,
        max_step=max_step, err=err, mode=mode, n_starts=n_starts,
        n_iters=n_iters, lr=lr, seed=seed + index, dist_type=dist_type,
        score_fn=score_fn, score_aux=score_aux, device=device)
    return _write_item(out_dir, phase, index, request, img_x, img_y,
                       actions, images)


def _write_item(out_dir, phase, index, request, img_x, img_y, actions,
                images) -> dict:
    """Write one planned pair's edit images and JSON. Images first, JSON
    last: the JSON marks the item complete, so an item cut short leaves
    no JSON whose edit{k}.jpg teachers are missing (the Act dataset
    would read zeros for them)."""
    item_dir = os.path.join(out_dir, f"{phase}{index}")
    os.makedirs(item_dir, exist_ok=True)
    info = {
        "request": request,
        "init distance": init_distance(img_x, img_y),
        "operation sequence": [[list(a) for a in seq] for seq in actions],
    }
    for k, img in enumerate(images[0]):             # top beam step images
        save_img(np.asarray(img)[0], os.path.join(item_dir, f"edit{k}.jpg"))
    with open(os.path.join(item_dir, f"{index:05d}.json"), "w") as f:
        json.dump(info, f)
    return info


def plan_dataset(pairs: Iterable, out_dir: str, phase: str = "train",
                 limit: Optional[int] = None, log_every: int = 10,
                 start_index: int = 0, score_aux_fn=None, **plan_kwargs):
    """Plan over an iterable of (img_x (1,3,H,W), img_y, request) tuples,
    one pair at a time. `start_index` keeps the written item indices
    global when `pairs` starts mid-dataset. `score_aux_fn(img_x,
    request)` gives each pair's score_aux for a learned distance
    (score_fn in plan_kwargs): the source image and the request's
    condition code."""
    os.makedirs(out_dir, exist_ok=True)
    avg_time, n = 0.0, 0
    for i, (img_x, img_y, request) in enumerate(pairs):
        if limit is not None and i >= limit:
            break
        tik = time.time()
        if score_aux_fn is not None:
            plan_kwargs["score_aux"] = score_aux_fn(np.asarray(img_x),
                                                    request)
        plan_pair(np.asarray(img_x), np.asarray(img_y), request, out_dir,
                  start_index + i, phase=phase, **plan_kwargs)
        n += 1
        avg_time += (time.time() - tik - avg_time) / n
        if n % log_every == 0:
            print(f"planned {n} pairs, avg {avg_time:.2f}s/pair", flush=True)
    print(f"done: {n} pairs, avg {avg_time:.2f}s/pair", flush=True)
    return n


def plan_dataset_batched(pairs: Iterable, out_dir: str, phase: str = "train",
                         pair_batch: int = 8, limit: Optional[int] = None,
                         start_index: int = 0, **plan_kwargs):
    """Lockstep-batched planning: `pair_batch` pairs per fit (see
    planner.beam.batch_beam_search). Writes the same per-pair layout."""
    os.makedirs(out_dir, exist_ok=True)
    buf, metas = [], []
    n, t_total = 0, time.time()
    base_seed = plan_kwargs.pop("seed", 0)

    def flush():
        nonlocal n
        if not buf:
            return
        # a short tail batch is padded to pair_batch with its last pair
        # (the extras are dropped by the zip below), as the JAX planner
        # pads it to keep one compiled shape: the same batch, the same
        # lockstep, the same plans
        if n > 0 and len(buf) < pair_batch:
            buf.extend([buf[-1]] * (pair_batch - len(buf)))
        I0 = np.concatenate([b[0] for b in buf], axis=0)
        Igt = np.concatenate([b[1] for b in buf], axis=0)
        # the seed varies per batch (its first item's index) on top of
        # the caller's base seed; only the top beam's step images are
        # written, through the uint8 wire
        results = batch_beam_search(I0, Igt,
                                    seed=base_seed + metas[0][0],
                                    replay_beams=1, replay_uint8=True,
                                    **plan_kwargs)
        for (actions, images), (idx, request, img_x, img_y) in zip(results,
                                                                   metas):
            _write_item(out_dir, phase, idx, request, img_x, img_y,
                        actions, images)
            n += 1
        buf.clear()
        metas.clear()
        dt = time.time() - t_total
        print(f"planned {n} pairs, {dt / max(n, 1):.2f}s/pair", flush=True)

    for i, (img_x, img_y, request) in enumerate(pairs):
        if limit is not None and i >= limit:
            break
        buf.append((np.asarray(img_x), np.asarray(img_y)))
        metas.append((start_index + i, request, np.asarray(img_x),
                      np.asarray(img_y)))
        if len(buf) >= pair_batch:
            flush()
    flush()
    return n
