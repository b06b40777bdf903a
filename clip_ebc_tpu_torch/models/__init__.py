"""Model factory: counterpart of ``clip_ebc_tpu/models/__init__.py`` ``get_model``.

Only the flagship ``clip_vit_b_16`` is ported so far; every other
backbone raises ``NotImplementedError`` naming its ROADMAP queue.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

CLIP_BACKBONES = (
    "resnet50",
    "resnet50x4",
    "resnet50x16",
    "resnet50x64",
    "resnet101",
    "vit_b_16",
    "vit_b_32",
    "vit_l_14",
    "vit_l_14_336px",
)
PORTED_CLIP_BACKBONES = ("vit_b_16",)


def get_model(
    backbone: str,
    input_size: int,
    reduction: int,
    bins: Optional[Sequence[Tuple[float, float]]] = None,
    anchor_points: Optional[Sequence[float]] = None,
    dtype: torch.dtype = torch.float32,
    **kwargs: Any,
):
    """The JAX factory's signature; ``input_size`` sets no weight shape of
    a ViT (its positional embedding resizes to any window) and is unused.
    ``kwargs`` go to :func:`build_clip_ebc` (``device``, ``seed``,
    ``attn_backend`` "auto" | "fused" | "flash" | "sdpa", ``fused_head``
    ...)."""
    del input_size
    backbone = backbone.lower()
    if not backbone.startswith("clip_"):
        raise NotImplementedError(
            f"model {backbone!r} is not ported yet (ROADMAP Queue 1, non-CLIP models)"
        )
    name = backbone[len("clip_"):]
    if name not in CLIP_BACKBONES:
        raise ValueError(f"CLIP backbone must be one of {CLIP_BACKBONES}, got {name}")
    if name not in PORTED_CLIP_BACKBONES:
        raise NotImplementedError(
            f"CLIP backbone {name!r} is not ported yet (ROADMAP Queue 1, other CLIP backbones)"
        )
    from .clip.model import build_clip_ebc

    return build_clip_ebc(
        backbone=name, bins=bins, anchor_points=anchor_points, reduction=reduction,
        dtype=dtype, **kwargs,
    )


__all__ = ["get_model", "CLIP_BACKBONES", "PORTED_CLIP_BACKBONES"]
