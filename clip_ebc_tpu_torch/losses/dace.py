"""DACE loss, distribution-aware cross-entropy over the count bins plus a
count loss: counterpart of ``clip_ebc_tpu/losses/dace.py``."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .dmcount import DMCountConfig, dmcount_loss


def bin_class_map(density: torch.Tensor, bins: Sequence[Tuple[float, float]]) -> torch.Tensor:
    """Per-block counts -> bin indices: inclusive [low, high], later bins
    taking precedence where bins overlap."""
    classes = torch.zeros(density.shape, dtype=torch.long, device=density.device)
    for idx, (low, high) in enumerate(bins):
        hi = math.inf if math.isinf(high) else high
        classes = torch.where((density >= low) & (density <= hi), idx, classes)
    return classes


def cross_entropy_sum_mean(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """-log p[class] summed over the map, averaged over the batch;
    ``logits`` (B, H, W, N)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, classes[..., None])[..., 0]
    return (-picked).sum((1, 2)).mean()


def dace_loss(
    pred_logits: torch.Tensor,  # (B, H, W, N)
    pred_density: torch.Tensor,  # (B, H, W)
    target_density: torch.Tensor,  # (B, H, W) block-summed
    points: torch.Tensor,  # (B, P, 2)
    point_mask: torch.Tensor,  # (B, P)
    bins: Sequence[Tuple[float, float]],
    weight_count_loss: float = 1.0,
    count_loss: str = "mae",
    dm_cfg: Optional[DMCountConfig] = None,
    world_size: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy over the bins (summed over the map, averaged over the
    batch) + ``weight_count_loss`` x the count loss; ``world_size`` weights
    DMCount's OT sum for data parallelism (:func:`~.dmcount.dmcount_loss`)."""
    if pred_density.shape != target_density.shape:
        raise ValueError(
            f"pred/target density shape mismatch: {tuple(pred_density.shape)} vs "
            f"{tuple(target_density.shape)}"
        )
    count_loss = count_loss.lower()
    if count_loss not in ("mae", "mse", "dmcount"):
        raise ValueError(f"count_loss must be mae|mse|dmcount, got {count_loss}")
    target_density = target_density.float()
    pred_density = pred_density.float()
    ce = cross_entropy_sum_mean(pred_logits, bin_class_map(target_density, bins))

    if count_loss == "dmcount":
        if dm_cfg is None:
            raise ValueError("dm_cfg is required when count_loss='dmcount'")
        cl, info = dmcount_loss(pred_density, target_density, points, point_mask, dm_cfg,
                                world_size)
        info["ce_loss"] = ce.detach()
    else:
        diff = pred_density - target_density
        cl = (diff.abs() if count_loss == "mae" else diff * diff).sum((1, 2)).mean()
        info = {"ce_loss": ce.detach(), f"{count_loss}_loss": cl.detach()}
    loss = ce + weight_count_loss * cl
    info["loss"] = loss.detach()
    return loss, info
