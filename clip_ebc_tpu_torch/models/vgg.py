"""VGG backbones: counterpart of ``clip_ebc_tpu/models/vgg.py``.

- ``VGGEncoder``: VGG features only, 512 channels, native reduction 16,
  bilinearly re-scaled to the requested reduction.
- ``VGGAutoEncoder``: VGG features + the 512 -> 256 -> 128 3x3
  regression head (``reg_layer``: convs with bias, no BN, each followed by
  a ReLU) -- the ``vgg19_ae`` DMCount/BL baseline.

The backbone contract of the port (``models/__init__.py``): NCHW in,
NCHW features out at stride ``reduction``; attributes ``channels``,
``reduction`` and ``encoder_reduction``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import VGG_CFGS, ConvBNAct, VGGStage, resize_bilinear


class VGGEncoder(nn.Module):
    channels = 512
    encoder_reduction = 16

    def __init__(self, cfg_key: str = "E", use_bn: bool = False, reduction: int = 8,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.reduction = reduction
        self.features = VGGStage(3, VGG_CFGS[cfg_key], use_bn=use_bn, axis_name=axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(self.features(x), self.encoder_reduction / self.reduction)


class VGGAutoEncoder(VGGEncoder):
    channels = 128

    def __init__(self, cfg_key: str = "E", use_bn: bool = False, reduction: int = 8,
                 axis_name: Optional[str] = None) -> None:
        super().__init__(cfg_key, use_bn, reduction, axis_name)
        self.reg_layer = nn.Sequential(
            *ConvBNAct(512, 256, 3, use_bn=False, bias=True),
            *ConvBNAct(256, 128, 3, use_bn=False, bias=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reg_layer(super().forward(x))


_VGG_KEYS = {"vgg11": "A", "vgg13": "B", "vgg16": "D", "vgg19": "E"}


def make_vgg(name: str, reduction: int, axis_name: Optional[str] = None) -> VGGEncoder:
    """Factory for ``vgg{11,13,16,19}[_bn][_ae]`` backbones."""
    base = name
    ae = base.endswith("_ae")
    if ae:
        base = base[: -len("_ae")]
    bn = base.endswith("_bn")
    if bn:
        base = base[: -len("_bn")]
    if base not in _VGG_KEYS:
        raise ValueError(f"unknown VGG variant {name!r}")
    cls = VGGAutoEncoder if ae else VGGEncoder
    return cls(cfg_key=_VGG_KEYS[base], use_bn=bn, reduction=reduction, axis_name=axis_name)
