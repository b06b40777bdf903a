"""Density-map rasterization and block-sum pooling: the port's copy of
``clip_ebc_tpu/data/density.py``.

The ground-truth density map is a dot map: 1.0 at each (clamped, floored)
point coordinate. The reference assigns (not accumulates) 1.0 per pixel
(reference datasets/utils.py:24), so coincident points collapse to a
single unit; this copy does the same.
"""

from __future__ import annotations

import numpy as np


def rasterize_points(points: np.ndarray, height: int, width: int) -> np.ndarray:
    """Build an (H, W) float32 dot density map from (N, 2) xy points.

    Coordinates are truncated toward zero then clamped into the image, the
    same int-cast+clamp the reference applies (reference datasets/utils.py:20-24).
    """
    density = np.zeros((height, width), dtype=np.float32)
    points = np.asarray(points, dtype=np.float32)
    if points.size > 0:
        if points.ndim != 2 or points.shape[1] != 2:
            raise ValueError(f"points must be (N, 2), got {points.shape}")
        xs = np.clip(points[:, 0].astype(np.int64), 0, width - 1)
        ys = np.clip(points[:, 1].astype(np.int64), 0, height - 1)
        density[ys, xs] = 1.0
    return density


def block_sum(density: np.ndarray, reduction: int) -> np.ndarray:
    """Sum-pool (..., H, W) -> (..., H/r, W/r); exactly count-preserving.

    Numpy twin of the device-side op in losses (reference losses/utils.py:4-9).
    """
    h, w = density.shape[-2], density.shape[-1]
    if h % reduction or w % reduction:
        raise ValueError(f"density {h}x{w} not divisible by reduction {reduction}")
    shape = density.shape[:-2] + (h // reduction, reduction, w // reduction, reduction)
    return density.reshape(shape).sum(axis=(-1, -3))
