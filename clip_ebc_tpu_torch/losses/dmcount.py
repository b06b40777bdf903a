"""DMCount loss, entropic OT + total variation + count L1: counterpart of
``clip_ebc_tpu/losses/dmcount.py``.

The whole batch solves its Sinkhorn systems at once (the batched
:func:`~.sinkhorn.sinkhorn_separable`) over padded point sets. fp32
throughout; the OT gradient is a detached tensor, as in the JAX package
(and the reference's own OT loss).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .sinkhorn import sinkhorn_separable

EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class DMCountConfig:
    input_size: int
    reduction: int
    norm_cood: bool = False
    num_iters: int = 100
    reg: float = 10.0
    weight_ot: float = 0.1
    weight_tv: float = 0.01


def _block_centers(cfg: DMCountConfig, device) -> torch.Tensor:
    """1-D block-center coordinates in input-pixel space."""
    cood = torch.arange(0, cfg.input_size, cfg.reduction, dtype=torch.float32, device=device)
    cood = cood + cfg.reduction / 2
    if cfg.norm_cood:
        cood = cood / cfg.input_size * 2 - 1
    return cood


def ot_loss(
    pred_density: torch.Tensor,  # (B, H, W) fp32, non-negative
    points: torch.Tensor,  # (B, P, 2) padded xy
    mask: torch.Tensor,  # (B, P) bool
    cood: torch.Tensor,  # (H,) block centers (H == W)
    cfg: DMCountConfig,
) -> torch.Tensor:
    """Per-image OT surrogate losses ``(B,)``, 0 for an image with no
    points: sum(pred * g) with g = d(OT)/d(pred), detached."""
    b, h, w = pred_density.shape
    n = mask.float().sum(1)
    pts = points.float()
    if cfg.norm_cood:
        pts = pts / cfg.input_size * 2 - 1
    # squared L2 cost between points and block centers is separable:
    # cost[p, (y, x)] = dy[p, y] + dx[p, x], so the Gibbs kernel factors
    kx = torch.exp(-((pts[..., 0:1] - cood) ** 2) / cfg.reg)  # (B, P, W)
    ky = torch.exp(-((pts[..., 1:2] - cood) ** 2) / cfg.reg)  # (B, P, H)

    source = pred_density.detach().reshape(b, -1)
    source_count = source.sum(1)
    source_prob = source / (source_count[:, None] + EPS)
    target_prob = torch.where(mask, 1.0 / n.clamp_min(1.0)[:, None], 0.0)
    beta = sinkhorn_separable(
        target_prob, source_prob.reshape(b, h, w), ky, kx, reg=cfg.reg,
        max_iters=cfg.num_iters, a_mask=mask,
    ).beta  # (B, H*W)
    c2 = source_count**2 + EPS
    grad1 = (source_count / c2)[:, None] * beta
    grad2 = (source * beta).sum(1) / c2
    gradient = (grad1 - grad2[:, None]).detach()
    ot = (pred_density.reshape(b, -1) * gradient).sum(1)
    return torch.where(n > 0, ot, torch.zeros((), device=ot.device))


def dmcount_loss(
    pred_density: torch.Tensor,  # (B, H, W)
    target_density: torch.Tensor,  # (B, H, W) block-summed dot map
    points: torch.Tensor,  # (B, P, 2)
    point_mask: torch.Tensor,  # (B, P) bool
    cfg: DMCountConfig,
    world_size: int = 1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """loss = weight_ot * OT (summed over the batch) + weight_tv * TV +
    count L1; ``info`` holds the detached terms.

    Under data parallelism each of ``world_size`` ranks holds an equal
    shard of the global batch and DDP averages the ranks' gradients: the
    means (TV, count) average to the global ones as they are, and the OT
    sum is weighted by ``world_size`` so that the average is the global
    batch's sum, as the JAX package computes it under its mesh.
    ``info["ot_loss"]`` stays this shard's own sum (the ranks' sums add up
    to the global one)."""
    pred_density = pred_density.float()
    target_density = target_density.float()
    b, h, w = pred_density.shape
    cood = _block_centers(cfg, pred_density.device)
    if cood.shape[0] != h or h != w:
        raise ValueError(
            f"pred density {h}x{w} incompatible with input_size/reduction grid {cood.shape[0]}"
        )
    pred_count = pred_density.reshape(b, -1).sum(1)
    target_count = point_mask.float().sum(1)

    ot = ot_loss(pred_density, points, point_mask, cood, cfg).sum()
    normed_pred = pred_density / (pred_count[:, None, None] + EPS)
    normed_target = target_density / (target_count[:, None, None] + EPS)
    tv = ((normed_pred - normed_target).abs().sum((1, 2)) * target_count).mean()
    count = (pred_count - target_count).abs().mean()

    loss = ot * (cfg.weight_ot * world_size) + tv * cfg.weight_tv + count
    info = {"loss": loss.detach(), "ot_loss": ot.detach(), "tv_loss": tv.detach(),
            "count_loss": count.detach()}
    return loss, info
