"""Learning-rate schedule, linear warmup then cosine annealing with warm
restarts: the port's copy of ``clip_ebc_tpu/training/schedule.py`` (the
reference's per-epoch LambdaLR, as an absolute learning rate per epoch).
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_restarts(
    base_lr: float,
    warmup_epochs: int,
    warmup_lr: float,
    T_0: int,
    T_mult: int,
    eta_min: float,
) -> Callable[[int], float]:
    """Return epoch -> learning rate.

    Linear ramp warmup_lr -> base_lr over ``warmup_epochs`` epochs, then
    cosine annealing restarting with period T_0, T_0*T_mult, T_0*T_mult^2, ...
    down to eta_min.
    """
    if T_0 < 1 or T_mult < 1:
        raise ValueError(f"T_0 and T_mult must be >= 1, got {T_0}, {T_mult}")
    if not (base_lr > eta_min > 0 and warmup_lr >= eta_min):
        raise ValueError(
            f"need base_lr > eta_min > 0 and warmup_lr >= eta_min, "
            f"got base_lr={base_lr}, warmup_lr={warmup_lr}, eta_min={eta_min}"
        )

    def schedule(epoch: int) -> float:
        epoch = int(epoch)
        if epoch < 0:
            raise ValueError(f"epoch must be non-negative, got {epoch}")
        if epoch < warmup_epochs:
            return warmup_lr + (base_lr - warmup_lr) * epoch / warmup_epochs
        epoch -= warmup_epochs
        if T_mult == 1:
            T_cur = epoch % T_0
            T_i = T_0
        else:
            n = int(math.log(epoch / T_0 * (T_mult - 1) + 1, T_mult))
            T_cur = epoch - T_0 * (T_mult**n - 1) / (T_mult - 1)
            T_i = T_0 * T_mult**n
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * T_cur / T_i)) / 2

    return schedule
