"""Torch-semantics bicubic resize: counterpart of ``clip_ebc_tpu/ops/interpolate.py``.

The JAX package reimplements torch's bicubic kernel (a = -0.75, half-pixel
centers, border-replicate) because ``jax.image.resize`` uses a = -0.5;
here the kernel is torch's own ``F.interpolate``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def torch_bicubic_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize ``(H, W, C)`` -> ``(size[0], size[1], C)`` (bicubic,
    ``align_corners=False``), computed in fp32 and cast back."""
    h, w, _ = x.shape
    if (h, w) == tuple(size):
        return x
    out = F.interpolate(
        x.float().permute(2, 0, 1)[None], size=tuple(size), mode="bicubic",
        align_corners=False,
    )
    return out[0].permute(1, 2, 0).to(x.dtype)
