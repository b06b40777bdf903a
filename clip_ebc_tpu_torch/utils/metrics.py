"""Count-error metrics (MAE and RMSE): counterpart of
``clip_ebc_tpu/utils/metrics.py`` (``count_errors``,
``CountErrorAccumulator``)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def count_errors(pred_counts: np.ndarray, gt_counts: np.ndarray) -> Dict[str, float]:
    """MAE and RMSE between per-image predicted and ground-truth counts."""
    pred_counts = np.asarray(pred_counts, dtype=np.float64)
    gt_counts = np.asarray(gt_counts, dtype=np.float64)
    if pred_counts.shape != gt_counts.shape:
        raise ValueError(f"pred/gt count shapes differ: {pred_counts.shape} vs {gt_counts.shape}")
    diff = pred_counts - gt_counts
    return {"mae": float(np.mean(np.abs(diff))), "rmse": float(np.sqrt(np.mean(diff * diff)))}


class CountErrorAccumulator:
    """Streaming MAE and RMSE: three running sums, no per-image storage."""

    def __init__(self) -> None:
        self.n = 0
        self.abs_sum = 0.0
        self.sq_sum = 0.0

    def update(self, pred_count: float, gt_count: float) -> None:
        diff = float(pred_count) - float(gt_count)
        self.n += 1
        self.abs_sum += abs(diff)
        self.sq_sum += diff * diff

    def update_batch(self, pred_counts: np.ndarray, gt_counts: np.ndarray) -> None:
        diff = np.asarray(pred_counts, np.float64) - np.asarray(gt_counts, np.float64)
        self.n += diff.size
        self.abs_sum += float(np.sum(np.abs(diff)))
        self.sq_sum += float(np.sum(diff * diff))

    def result(self) -> Dict[str, float]:
        if self.n == 0:
            return {"mae": float("nan"), "rmse": float("nan")}
        return {"mae": self.abs_sum / self.n, "rmse": float(np.sqrt(self.sq_sum / self.n))}
