"""The train step and epoch: counterpart of ``clip_ebc_tpu/training/trainer.py``
(``make_train_step``, ``Trainer``) and ``state.py``.

One process drives one device. The train state is the model (its
parameters and BatchNorm statistics, which move in train mode as the JAX
``batch_stats`` do), the optimizer and a step count;
:meth:`Trainer.state_dict` gathers them for checkpoints. A CLIP-EBC
model's frozen text features are encoded once per epoch and passed into
every step; a model without a text tower (the Classifier and Regressor
heads) is called as ``model(images)`` and returns ``(logits, density)``
(``(None, density)`` for a Regressor). Step metrics stay on the device
until the epoch ends, then are averaged with one host read.

In a process group (``parallel.mesh``) the model steps under
``DistributedDataParallel``: each rank takes its shard of the global
batch and DDP averages the gradients, so with the rank-aware loss
(``losses.make_loss_fn(cfg, world_size)``), BatchNorm statistics synced
over the ranks (``axis_name``) and the prompt dropout drawn for the
global batch, N ranks of ``batch_size`` take the step one process takes
on N x ``batch_size``, as the JAX ``Trainer`` does under its mesh. Frozen
parameters have no gradient and no DDP hook; the synced statistics are
equal on every rank, so DDP broadcasts no buffer. The epoch's loss terms
are the global batch's (``parallel.mesh.reduce_metrics``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.loader import Batch
from ..losses import SUMMED_TERMS
from ..parallel.mesh import is_distributed, reduce_metrics
from .optim import make_optimizer, make_schedule


class Trainer:
    """Owns the optimizer, the schedule and the prompt-dropout generator
    of a model that lives on its device; ``net`` is the model, or its DDP
    wrapper in a process group."""

    def __init__(self, cfg, model: torch.nn.Module, loss_fn: Callable) -> None:
        self.cfg = cfg
        self.model = model
        self.loss_fn = loss_fn
        self.device = next(model.parameters()).device
        self.net = model
        if is_distributed():
            from torch.nn.parallel import DistributedDataParallel

            self.net = DistributedDataParallel(
                model, device_ids=[self.device] if self.device.type == "cuda" else None,
                broadcast_buffers=False)
        self.schedule = make_schedule(cfg)
        self.optimizer = make_optimizer(model, cfg.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0

    def text_features(self) -> Optional[torch.Tensor]:
        """The frozen prompt features of the current weights (None for a
        model without a text tower)."""
        if not hasattr(self.model, "encode_text"):
            return None
        with torch.no_grad():
            return self.model.encode_text()

    def set_epoch_lr(self, epoch: int) -> float:
        """Set the learning rate of 1-based ``epoch`` from the schedule."""
        lr = float(self.schedule(epoch - 1))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def train_step(self, batch: Batch, text_feats: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch already on the device; returns the
        loss terms as device scalars."""
        if text_feats is None:
            logits, density = self.net(batch.images)
        else:
            logits, density = self.net(batch.images, text_feats=text_feats,
                                       generator=self.generator)
        loss, info = self.loss_fn(logits, density, batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return info

    def train_epoch(self, loader, epoch: int) -> Tuple[Dict[str, float], int]:
        """One epoch over ``loader``: ``(averaged loss terms + lr, steps)``;
        the terms are the global batch's in a process group."""
        lr = self.set_epoch_lr(epoch)
        self.model.train()
        text_feats = self.text_features()
        loader.set_epoch(epoch)
        infos = [self.train_step(batch.to(self.device, non_blocking=True), text_feats)
                 for batch in loader]
        metrics = reduce_metrics({k: torch.stack([i[k] for i in infos]).mean()
                                  for k in (infos[0] if infos else {})}, SUMMED_TERMS)
        metrics["lr"] = lr
        return metrics, len(infos)

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
