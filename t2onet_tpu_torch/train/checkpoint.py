"""Checkpoint / resume with best-model tracking (counterpart of
`t2onet_tpu.train.checkpoint`, in `torch.save` files instead of orbax
directories).

Each checkpoint holds the whole training state: the actor's state_dict
(weights and BatchNorm statistics), the optimizer's state, the step, and
optionally the state of the episode generator, so a resume continues
exactly. Layout under `ckpt_dir`: `checkpoint_iter{itr:08d}.pt`,
`checkpoint_best.pt` and `stats.json` (val L1 per checkpoint, best iter).
An eval reads the actor's part alone (`restore_actor`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import torch

_FINAL_RE = re.compile(r"^checkpoint_iter\d+\.pt$")


def _final_ckpts(ckpt_dir: str):
    return sorted(d for d in os.listdir(ckpt_dir) if _FINAL_RE.match(d))


def _resolve_ckpt_path(ckpt_dir: str, which: str) -> str:
    """'best' / 'latest' / explicit path -> checkpoint file."""
    if which == "best":
        path = os.path.join(ckpt_dir, "checkpoint_best.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no best checkpoint in {ckpt_dir}")
        return path
    if which == "latest":
        cands = _final_ckpts(ckpt_dir)
        if not cands:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        return os.path.join(ckpt_dir, cands[-1])
    return which


def restore_actor(actor, ckpt_dir: str, which: str = "best") -> str:
    """Load only the actor's weights and BatchNorm statistics from a
    checkpoint ('best', 'latest' or a path) into `actor`, in place, for
    eval: no optimizer state is read. Returns the file read."""
    path = _resolve_ckpt_path(ckpt_dir, which)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    actor.load_state_dict(blob["model"])
    return path


def _save(obj, path: str):
    """torch.save to a temporary file, then an atomic rename: a crash mid
    save never leaves a truncated checkpoint under a final name."""
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _prune_old(ckpt_dir: str, max_to_keep: Optional[int]):
    """Drop the oldest step checkpoints beyond max_to_keep (the best one is
    never pruned), and temporary files a crash left behind."""
    for d in os.listdir(ckpt_dir):
        if d.startswith("checkpoint_") and d.endswith(".tmp"):
            os.remove(os.path.join(ckpt_dir, d))
    if not max_to_keep:
        return
    for d in _final_ckpts(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, d))


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        """max_to_keep: prune all but the newest N step checkpoints
        (default None keeps everything)."""
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.stats: Dict[str, Any] = {
            "val_dist": [],
            "train_iter": [],
            "best_iter": 0,
            "best_val_dist": float("inf"),
        }
        self._load_stats()

    def _stats_path(self) -> str:
        return os.path.join(self.ckpt_dir, "stats.json")

    def _load_stats(self):
        if os.path.exists(self._stats_path()):
            try:
                with open(self._stats_path()) as f:
                    self.stats = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                # advisory (best-model tracking): a truncated file must not
                # brick the run dir
                print(f"warning: corrupt {self._stats_path()} ({e}); "
                      "resetting best-model stats")

    def _save_stats(self):
        tmp = self._stats_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.stats, f)
        os.replace(tmp, self._stats_path())

    @staticmethod
    def _state_dict(state, generator=None):
        out = {"step": state.step,
               "model": state.actor.state_dict(),
               "optimizer": state.opt.state_dict()}
        if generator is not None:
            out["generator"] = generator.get_state()
        return out

    def save(self, state, itr: int, val_dist: Optional[float] = None,
             generator=None) -> bool:
        """Save a step checkpoint; track the best by val L1. Returns
        whether it is the best so far."""
        blob = self._state_dict(state, generator)
        _save(blob, os.path.join(self.ckpt_dir, f"checkpoint_iter{itr:08d}.pt"))
        is_best = False
        if val_dist is not None:
            self.stats["val_dist"].append(float(val_dist))
            self.stats["train_iter"].append(int(itr))
            if val_dist < self.stats["best_val_dist"]:
                self.stats["best_val_dist"] = float(val_dist)
                self.stats["best_iter"] = int(itr)
                _save(blob, os.path.join(self.ckpt_dir, "checkpoint_best.pt"))
                is_best = True
        _prune_old(self.ckpt_dir, self.max_to_keep)
        self._save_stats()
        return is_best

    def restore(self, state, which: str = "best", generator=None):
        """Load a checkpoint into `state` (and `generator`) in place and
        return `state`."""
        path = _resolve_ckpt_path(self.ckpt_dir, which)
        # loaded on the host: load_state_dict copies the weights and moves
        # the optimizer's moments to each parameter's device, and keeps
        # Adam's step counts on the host where torch wants them
        blob = torch.load(path, map_location="cpu", weights_only=True)
        state.actor.load_state_dict(blob["model"])
        state.opt.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        if generator is not None and "generator" in blob:
            generator.set_state(blob["generator"])
        return state
