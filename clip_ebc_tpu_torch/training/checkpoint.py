"""Checkpoints, a rolling full-state checkpoint plus best-k weight
snapshots: counterpart of ``clip_ebc_tpu/training/checkpoint.py`` on
``torch.save`` instead of Orbax.

``latest.pt`` holds the trainer's state (model, optimizer, step) and is
replaced atomically; ``best/{epoch}.pt`` holds the weights (a model state
dict, loadable by ``cli.predict --weight_path``) of every epoch that is in
the top ``save_best_k`` of some metric; ``meta.json`` maps each metric to
its ranked ``[score, epoch]`` list, with the score history and the
per-epoch loss history, and snapshots that fell out of every list are
deleted.

In a process group every rank calls every method; rank 0 alone writes,
prunes and updates ``meta.json``, and a barrier after each write holds
the others until it is on disk (the JAX package fences its primary-only
file work the same way). Every rank restores the same ``latest.pt`` onto
its own device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import barrier, is_primary

METRICS = ("mae", "rmse")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, save_best_k: int = 3) -> None:
        self.dir = os.path.abspath(ckpt_dir)
        self.save_best_k = save_best_k
        self._primary = is_primary()
        if self._primary:
            os.makedirs(os.path.join(self.dir, "best"), exist_ok=True)
        barrier()
        self._meta_path = os.path.join(self.dir, "meta.json")

    def _load_meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {
            "epoch": 0,
            "hist_scores": {m: [] for m in METRICS},
            "best_scores": {m: [] for m in METRICS},  # ranked [score, epoch]
            "loss_history": [],
        }

    def _save_meta(self, meta: Dict[str, Any]) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self._meta_path)

    def save_latest(self, state: dict, epoch: int, loss_info: Optional[Dict[str, float]] = None) -> None:
        """Replace ``latest.pt`` with ``state`` (``Trainer.state_dict()``)."""
        if self._primary:
            _atomic_save(state, os.path.join(self.dir, "latest.pt"))
            meta = self._load_meta()
            meta["epoch"] = epoch
            if loss_info:
                meta["loss_history"].append(
                    {"epoch": epoch, **{k: float(v) for k, v in loss_info.items()}})
            self._save_meta(meta)
        barrier()

    def restore_latest(self) -> Optional[Tuple[dict, int]]:
        """Auto-resume: ``(state, next_epoch)``, or None without a checkpoint."""
        path = os.path.join(self.dir, "latest.pt")
        if not os.path.exists(path):
            return None
        state = torch.load(path, map_location="cpu", weights_only=True)
        return state, int(self._load_meta()["epoch"]) + 1

    def update_best(self, scores: Dict[str, float], epoch: int, weights: Dict[str, torch.Tensor]
                    ) -> Dict[str, List[Tuple[float, int]]]:
        """Insert this epoch's val scores; save ``weights`` (a model state
        dict) if the epoch entered any top-k; prune snapshots that left
        every list. Returns the ranked tables (on every rank)."""
        if self._primary:
            self._update_best(scores, epoch, weights)
        barrier()
        meta = self._load_meta()
        return {m: [tuple(x) for x in meta["best_scores"][m]] for m in METRICS}

    def _update_best(self, scores: Dict[str, float], epoch: int,
                     weights: Dict[str, torch.Tensor]) -> None:
        meta = self._load_meta()
        entered = False
        for m in METRICS:
            if m not in scores:
                continue
            # a re-run epoch supersedes its earlier score
            meta["hist_scores"][m] = [x for x in meta["hist_scores"][m] if x[1] != epoch]
            meta["hist_scores"][m].append([float(scores[m]), epoch])
            table = [tuple(x) for x in meta["best_scores"][m] if x[1] != epoch]
            table.append((float(scores[m]), epoch))
            table = sorted(table)[: self.save_best_k]
            entered = entered or any(e == epoch for _, e in table)
            meta["best_scores"][m] = [list(x) for x in table]
        best_root = os.path.join(self.dir, "best")
        if entered:
            _atomic_save(weights, os.path.join(best_root, f"{epoch}.pt"))
        keep = {f"{int(e)}.pt" for m in METRICS for _, e in meta["best_scores"][m]}
        for name in os.listdir(best_root):
            if name.endswith(".pt") and name not in keep:
                os.remove(os.path.join(best_root, name))
        self._save_meta(meta)
