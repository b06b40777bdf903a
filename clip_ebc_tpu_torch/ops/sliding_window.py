"""Sliding-window inference: counterpart of ``clip_ebc_tpu/ops/sliding_window.py``.

Window starts form a static, edge-clamped grid (:func:`window_grid`).
Windows are cut out with one advanced-indexing gather (the counterpart of
both ``gather_windows_dense`` and the vmapped ``dynamic_slice`` path), run
through the model as one batch, and reassembled by overlap-averaging
(or max) with one scatter. Eager torch does not recompile per window
count, so the batch is not padded to a bucket. In a process group of more
than one rank the window batch is split over the ranks, as the JAX
package shards it on its mesh's ``data`` axis: each rank runs its own
windows and the per-window densities are gathered back by one all-reduce
(``parallel.mesh.gather_rows``), so every rank must predict the same
image. :func:`resize_density_map` resizes a
density map and keeps its mass.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import gather_rows, get_world_size, shard_rows


def window_grid(
    image_hw: Tuple[int, int], window: Tuple[int, int], stride: Tuple[int, int]
) -> np.ndarray:
    """Static ``(N, 2)`` array of ``(y, x)`` window starts, row-major, with
    the last row/column clamped to the image edge."""
    (h, w), (wh, ww), (sh, sw) = image_hw, window, stride
    if wh > h or ww > w:
        raise ValueError(f"window {window} larger than image {image_hw}")
    rows = int(np.ceil((h - wh) / sh) + 1)
    cols = int(np.ceil((w - ww) / sw) + 1)
    starts = [
        (min(i * sh, h - wh), min(j * sw, w - ww))
        for i in range(rows)
        for j in range(cols)
    ]
    return np.asarray(starts, np.int32)


def gather_windows(
    image: torch.Tensor, window: Tuple[int, int], stride: Tuple[int, int]
) -> torch.Tensor:
    """``(H, W, C)`` -> ``(N, wh, ww, C)`` windows in :func:`window_grid`
    order, gathered in one indexing op."""
    h, w, _ = image.shape
    wh, ww = window
    starts = torch.as_tensor(window_grid((h, w), window, stride), device=image.device).long()
    rows = starts[:, 0, None] + torch.arange(wh, device=image.device)  # (N, wh)
    cols = starts[:, 1, None] + torch.arange(ww, device=image.device)  # (N, ww)
    return image[rows[:, :, None], cols[:, None, :]]


def _flat_block_index(
    image_hw: Tuple[int, int], window: Tuple[int, int], stride: Tuple[int, int],
    reduction: int,
) -> np.ndarray:
    """``(N, bh, bw)`` flat indices of every window's output blocks in the
    ``(H/r, W/r)`` map."""
    h, w = image_hw
    bh, bw = window[0] // reduction, window[1] // reduction
    wr = w // reduction
    starts = window_grid((h, w), window, stride) // reduction
    oy, ox = np.mgrid[0:bh, 0:bw]
    return ((starts[:, 0, None, None] + oy) * wr + (starts[:, 1, None, None] + ox)).astype(
        np.int64
    )


def assemble_windows(
    preds: torch.Tensor,  # (N, wh/r, ww/r) per-window densities, grid order
    image_hw: Tuple[int, int],
    window: Tuple[int, int],
    stride: Tuple[int, int],
    reduction: int,
    strategy: str = "average",
) -> torch.Tensor:
    """Overlap-average (or -max) of per-window densities into the full
    ``(H/r, W/r)`` fp32 map."""
    h, w = image_hw
    hr, wr = h // reduction, w // reduction
    idx_np = _flat_block_index(image_hw, window, stride, reduction).reshape(-1)
    idx = torch.as_tensor(idx_np, device=preds.device)
    vals = preds.float().reshape(-1)
    if strategy == "average":
        cnt = np.bincount(idx_np, minlength=hr * wr).astype(np.float32)
        acc = torch.zeros(hr * wr, dtype=torch.float32, device=preds.device)
        acc.index_add_(0, idx, vals)
        div = torch.as_tensor(np.maximum(cnt, 1.0), device=preds.device)
        return (acc / div).reshape(hr, wr)
    if strategy == "max":
        acc = torch.full((hr * wr,), -float("inf"), dtype=torch.float32, device=preds.device)
        acc.scatter_reduce_(0, idx, vals, reduce="amax")
        return torch.where(torch.isfinite(acc), acc, 0.0).reshape(hr, wr)
    raise ValueError(f"strategy must be 'average' or 'max', got {strategy}")


def sliding_window_predict(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],  # (N, wh, ww, 3) -> (N, wh/r, ww/r)
    image: torch.Tensor,  # (H, W, 3)
    window: Tuple[int, int],
    stride: Tuple[int, int],
    reduction: int,
    strategy: str = "average",
) -> torch.Tensor:
    """Predict the full-image ``(H/r, W/r)`` density map by sliding windows:
    one gather, one batched forward, one assembly. In a process group every
    rank holds the same image and runs its share of the windows (their
    count rounded up to a multiple of the world size, ``ceil(N / world)``
    a rank, ``parallel.mesh.shard_rows``); the densities are gathered in
    fp32 and every rank assembles the same map."""
    h, w, _ = image.shape
    windows = gather_windows(image, window, stride)
    bh, bw = window[0] // reduction, window[1] // reduction
    if get_world_size() > 1:
        n, rows = windows.shape[0], shard_rows(windows.shape[0])
        # a rank whose share is empty runs nothing and adds zeros
        local = (apply_fn(windows[rows]) if rows.stop > rows.start
                 else windows.new_zeros((0, bh, bw), dtype=torch.float32))
        _check_blocks(local, window, reduction)
        preds = gather_rows(local, rows, n)
    else:
        preds = apply_fn(windows)
        _check_blocks(preds, window, reduction)
    return assemble_windows(preds, (h, w), window, stride, reduction, strategy)


def _check_blocks(preds: torch.Tensor, window: Tuple[int, int], reduction: int) -> None:
    bh, bw = window[0] // reduction, window[1] // reduction
    if tuple(preds.shape[-2:]) != (bh, bw):
        raise ValueError(
            f"model produced {tuple(preds.shape[-2:])} blocks for window {window} "
            f"at reduction {reduction}"
        )


def resize_density_map(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an ``(H, W)`` density map, rescaled to keep its
    total mass (0 when the resized map sums to 0). ``jax.image.resize``'s
    bilinear filter widens with the scale when it downsamples; here that
    is ``antialias=True`` (upsampling is the same either way)."""
    total = x.sum()
    out = F.interpolate(x[None, None].float(), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)[0, 0]
    new_total = out.sum()
    scale = torch.where(new_total > 0, total / new_total, torch.zeros_like(new_total))
    return out * scale
