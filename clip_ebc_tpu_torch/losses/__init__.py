"""Losses: counterpart of ``clip_ebc_tpu/losses``."""

from .dace import bin_class_map, cross_entropy_sum_mean, dace_loss
from .dmcount import DMCountConfig, dmcount_loss
from .sinkhorn import SinkhornResult, sinkhorn, sinkhorn_separable


def make_loss_fn(cfg):
    """``loss_fn(pred_logits, pred_density, batch) -> (loss, info)`` from an
    ExperimentConfig: DACE over the bins, or plain DMCount on the density
    for a regression model (``cfg.bins`` None)."""
    dm_cfg = DMCountConfig(input_size=cfg.input_size, reduction=cfg.reduction)
    if cfg.bins is None:
        def loss_fn(pred_logits, pred_density, batch):
            return dmcount_loss(pred_density, batch.density, batch.points, batch.point_mask, dm_cfg)

        return loss_fn

    bins = tuple(tuple(b) for b in cfg.bins)

    def loss_fn(pred_logits, pred_density, batch):
        return dace_loss(
            pred_logits, pred_density, batch.density, batch.points, batch.point_mask,
            bins=bins, weight_count_loss=cfg.weight_count_loss,
            count_loss=cfg.count_loss, dm_cfg=dm_cfg,
        )

    return loss_fn


__all__ = [
    "DMCountConfig", "SinkhornResult", "bin_class_map", "cross_entropy_sum_mean",
    "dace_loss", "dmcount_loss", "make_loss_fn", "sinkhorn", "sinkhorn_separable",
]
