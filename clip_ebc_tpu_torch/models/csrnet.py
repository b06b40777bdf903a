"""CSRNet and CANNet crowd-counting backbones: counterpart of
``clip_ebc_tpu/models/csrnet.py``.

- CSRNet: VGG16 front end (through conv4_3, reduction 8) + dilated-conv
  back end.
- CANNet: CSRNet + the multi-scale ``ContextualModule`` between the two.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, VGGStage, _resize, resize_bilinear, resize_to

EPS = 1e-6

# VGG16 through conv4_3: three pools -> reduction 8
ENCODER_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
DECODER_CFG = (512, 512, 512, 256, 128, 64)


def adaptive_avg_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    """The JAX package's pool to ``(size, size)``: the mean of equal blocks
    when ``size`` divides both sides, else an antialiased bilinear resize
    (which is not torch's ``adaptive_avg_pool2d`` on ragged windows)."""
    b, c, h, w = x.shape
    if h % size == 0 and w % size == 0:
        return x.reshape(b, c, size, h // size, size, w // size).mean(dim=(3, 5))
    return _resize(x, (size, size))


class ContextualModule(nn.Module):
    """Scale-aware context: average-pool pyramids re-upsampled and gated by
    sigmoid contrast weights."""

    def __init__(self, channels: int = 512, features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6)) -> None:
        super().__init__()
        self.sizes = tuple(sizes)
        self.weight_net = Conv2d(channels, channels, 1, kernel_init="kaiming_out")
        for size in self.sizes:
            self.add_module(f"scale_{size}",
                            Conv2d(channels, channels, 1, bias=False, kernel_init="kaiming_out"))
        self.bottleneck = Conv2d(2 * channels, features, 1, kernel_init="kaiming_out")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        num = den = 0
        for size in self.sizes:
            up = resize_to(getattr(self, f"scale_{size}")(adaptive_avg_pool(x, size)), (h, w))
            weight = torch.sigmoid(self.weight_net(x - up))
            num = num + up * weight
            den = den + weight
        fused = num / (den + EPS)
        return F.relu(self.bottleneck(torch.cat([fused, x], dim=1)))


class CSRNet(nn.Module):
    channels = 64
    encoder_reduction = 8

    def __init__(self, use_bn: bool = False, reduction: int = 8, use_context: bool = False,
                 sizes: Sequence[int] = (1, 2, 3, 6), axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.reduction = reduction
        self.features = VGGStage(3, ENCODER_CFG, use_bn=use_bn, axis_name=axis_name)
        self.context = ContextualModule(512, 512, sizes) if use_context else None
        self.backend = VGGStage(512, DECODER_CFG, use_bn=use_bn, dilation=2,
                                axis_name=axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        if self.context is not None:
            x = self.context(x)
        x = resize_bilinear(x, self.encoder_reduction / self.reduction)
        return self.backend(x)
