"""Optimizer and schedule: counterpart of ``clip_ebc_tpu/training/optim.py``.

``torch.optim.Adam`` with ``weight_decay`` adds the decay to the gradient
before the moment update: coupled L2, not AdamW, as the JAX package's
``add_decayed_weights`` -> ``scale_by_adam`` chain. It takes only the
parameters that require a gradient, which replaces the JAX package's
``multi_transform`` mask over the frozen subtrees; a model with nothing
frozen (the Classifier and Regressor heads) trains every parameter, as
the JAX ``make_optimizer`` with no frozen predicate. The learning rate is
set once per epoch from :func:`make_schedule`.
"""

from __future__ import annotations

from typing import Callable

import torch

from .schedule import warmup_cosine_restarts


def make_optimizer(model: torch.nn.Module, weight_decay: float = 1e-4) -> torch.optim.Adam:
    """Adam(b1 0.9, b2 0.999, eps 1e-8, coupled L2) over the trainable
    parameters of ``model``; the learning rate is set per epoch."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no parameter that requires a gradient")
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def make_schedule(cfg) -> Callable[[int], float]:
    """Epoch (0-based) -> lr from an ExperimentConfig."""
    return warmup_cosine_restarts(
        base_lr=cfg.lr,
        warmup_epochs=cfg.warmup_epochs,
        warmup_lr=cfg.warmup_lr,
        T_0=cfg.T_0,
        T_mult=cfg.T_mult,
        eta_min=cfg.eta_min,
    )
