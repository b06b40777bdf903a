"""Losses: counterpart of ``clip_ebc_tpu/losses``."""

from .dace import bin_class_map, cross_entropy_sum_mean, dace_loss
from .dmcount import DMCountConfig, dmcount_loss
from .sinkhorn import SinkhornResult, sinkhorn, sinkhorn_separable


# The loss terms that are sums over the batch (the others are means): the
# ranks' values of these add up to the global batch's.
SUMMED_TERMS = ("ot_loss",)


def make_loss_fn(cfg, world_size: int = 1):
    """``loss_fn(pred_logits, pred_density, batch) -> (loss, info)`` from an
    ExperimentConfig: DACE over the bins, or plain DMCount on the density
    for a regression model (``cfg.bins`` None). With ``world_size`` ranks
    each rank's loss is the one whose average over the ranks (DDP's
    gradient) is the global batch's loss."""
    dm_cfg = DMCountConfig(input_size=cfg.input_size, reduction=cfg.reduction)
    if cfg.bins is None:
        def loss_fn(pred_logits, pred_density, batch):
            return dmcount_loss(pred_density, batch.density, batch.points, batch.point_mask, dm_cfg,
                                world_size)

        return loss_fn

    bins = tuple(tuple(b) for b in cfg.bins)

    def loss_fn(pred_logits, pred_density, batch):
        return dace_loss(
            pred_logits, pred_density, batch.density, batch.points, batch.point_mask,
            bins=bins, weight_count_loss=cfg.weight_count_loss,
            count_loss=cfg.count_loss, dm_cfg=dm_cfg, world_size=world_size,
        )

    return loss_fn


__all__ = [
    "DMCountConfig", "SUMMED_TERMS", "SinkhornResult", "bin_class_map", "cross_entropy_sum_mean",
    "dace_loss", "dmcount_loss", "make_loss_fn", "sinkhorn", "sinkhorn_separable",
]
