"""Prediction heads: counterpart of ``clip_ebc_tpu/models/heads.py``.

- ``Classifier``: backbone -> 1x1 conv(s) -> per-block bin logits; the
  count of a block is softmax(logits) . anchor_points.
- ``Regressor``: backbone -> 1x1 conv -> ReLU -> density.

Both take ``(B, H, W, 3)`` images, as the JAX heads do, and hand the
backbone a channels-last NCHW view cast to the compute ``dtype`` (the JAX
package's first convolution casts its input the same way). Outputs are
NHWC: logits ``(B, H, W, N)`` in the compute dtype, density ``(B, H, W)``
in fp32. In training mode (``model.train()``) ``forward`` returns
``(logits, density)``, ``(None, density)`` for the Regressor. The
submodules carry the reference's torch names (``backbone``,
``classifier`` or ``classifier.{0,2}``, ``regressor.0``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .blocks import BatchNorm, Conv2d, init_conv_, lecun_normal_


def expectation_from_logits(logits: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis . anchors, in fp32: ``(..., N) -> (...)``."""
    probs = torch.softmax(logits.float(), dim=-1)
    return (probs * anchor_points.float()).sum(-1)


def _head_conv(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 1, kernel_init="kaiming_out")


class _Head(nn.Module):
    def __init__(self, backbone: nn.Module, dtype: torch.dtype) -> None:
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype

    @property
    def reduction(self) -> int:
        return self.backbone.reduction

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` images -> the backbone's NCHW features."""
        return self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "_Head":
        """Random initialization from ``generator`` (a CPU generator; call
        before moving the model to another device) by the JAX package's
        initializers: each ``Conv2d`` by its ``kernel_init``, dense and
        attention projections and the patchify lecun normal, biases zero,
        norms at scale 1 and shift 0 (BatchNorm statistics at mean 0,
        variance 1), and what a module's own ``init_extra_`` sets."""
        from .transformer import Linear, MultiHeadAttention, PatchifyMatmul

        g = generator
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_conv_(m, g)
            elif isinstance(m, (Linear, PatchifyMatmul)):
                lecun_normal_(m.weight, m.weight[0].numel(), g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], g)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.LayerNorm, BatchNorm)):
                m.reset_parameters()
            if hasattr(m, "init_extra_"):
                m.init_extra_(g)
        return self


class Classifier(_Head):
    """Blockwise bin classifier; a backbone wider than 512 channels gets a
    512-wide hidden 1x1 conv and ReLU before the output conv."""

    def __init__(self, backbone: nn.Module, bins: Sequence[Tuple[float, float]],
                 anchor_points: Sequence[float], dtype: torch.dtype = torch.float32) -> None:
        super().__init__(backbone, dtype)
        if len(bins) != len(anchor_points):
            raise ValueError(
                f"bins and anchor_points must have equal length, got "
                f"{len(bins)} and {len(anchor_points)}"
            )
        for (lo, hi), a in zip(bins, anchor_points):
            if not lo <= a <= hi:
                raise ValueError(f"anchor {a} not within bin ({lo}, {hi})")
        self.bins = tuple(tuple(b) for b in bins)
        n, c = len(bins), backbone.channels
        if c > 512:
            self.classifier = nn.Sequential(_head_conv(c, 512), nn.ReLU(), _head_conv(512, n))
        else:
            self.classifier = _head_conv(c, n)
        self.register_buffer(
            "anchor_points", torch.tensor(list(anchor_points), dtype=torch.float32), persistent=False
        )

    def forward(self, x: torch.Tensor):
        logits = self.classifier(self.features(x)).permute(0, 2, 3, 1)  # (B, H, W, N)
        density = expectation_from_logits(logits, self.anchor_points)
        return (logits, density) if self.training else density


class Regressor(_Head):
    """Density regressor: a 1x1 conv to one channel, ReLU in fp32."""

    def __init__(self, backbone: nn.Module, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(backbone, dtype)
        self.regressor = nn.Sequential(_head_conv(backbone.channels, 1), nn.ReLU())

    def forward(self, x: torch.Tensor):
        # ReLU is exact in bf16, so it is the fp32 ReLU of the widened output
        density = self.regressor(self.features(x)).float()[:, 0]  # (B, H, W)
        return (None, density) if self.training else density
