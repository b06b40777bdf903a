"""Torchvision-style ResNet encoders and the residual decoder (the ``*_ae``
family): counterpart of ``clip_ebc_tpu/models/resnet.py``.

The stride of layer4 is chosen at construction (1 when ``reduction <=
16``, so the native stride is 16; else 2, native 32), and a bilinear
rescale covers the rest. Names are torchvision's (``conv1``, ``bn1``,
``layer{1-4}.{i}.conv{1-3}``/``bn{1-3}``/``downsample.{0,1}``) under
``encoder``; the decoder is ``models/blocks.py``'s ``ResNetStage``.
Convolutions have no bias and flax's default (lecun normal) init.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv2d, ResNetStage, resize_bilinear

_LAYERS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
    "resnet101": ((3, 4, 23, 3), "bottleneck"),
    "resnet152": ((3, 8, 36, 3), "bottleneck"),
}

# Decoder stacks per variant.
_DECODER_CFGS = {
    "resnet18": (512, 256, 128),
    "resnet34": (512, 256, 128),
    "resnet50": (512, 256, 256, 128),
    "resnet101": (512, 512, 256, 256, 128),
    "resnet152": (512, 512, 512, 256, 256, 128),
}


def _downsample(cin: int, cout: int, stride: int, axis_name: Optional[str]):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False), BatchNorm(cout, axis_name))


class _TVBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features, axis_name)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features, axis_name)
        self.downsample = _downsample(cin, features, stride, axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _TVBottleneck(nn.Module):
    """ResNet V1.5 bottleneck: the stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features, axis_name)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features, axis_name)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, axis_name)
        self.downsample = _downsample(cin, out, stride, axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder(nn.Module):
    """Features-only ResNet; ``encoder_reduction`` is 16 when layer4 runs at
    stride 1, else 32."""

    def __init__(self, variant: str = "resnet34", layer4_stride: int = 2,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        counts, kind = _LAYERS[variant]
        block = _TVBasicBlock if kind == "basic" else _TVBottleneck
        self.channels = 512 * block.expansion
        self.encoder_reduction = 32 if layer4_stride == 2 else 16
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, axis_name)
        cin = 64
        for i, (w, s, n) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, layer4_stride), counts)):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, w, s if j == 0 else 1, axis_name))
                cin = w * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PlainResNetBackbone(nn.Module):
    """Plain (non-AE) ResNet backbone: the encoder, bilinearly rescaled to
    the requested reduction."""

    def __init__(self, variant: str = "resnet50", reduction: int = 32,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.reduction = reduction
        self.encoder = ResNetEncoder(variant, layer4_stride=1 if reduction <= 16 else 2,
                                     axis_name=axis_name)
        self.channels = self.encoder.channels
        self.encoder_reduction = self.encoder.encoder_reduction

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(self.encoder(x), self.encoder_reduction / self.reduction)


class ResNetAutoEncoder(PlainResNetBackbone):
    """ResNet encoder, rescale, then the residual decoder of the variant."""

    def __init__(self, variant: str = "resnet34", reduction: int = 32,
                 axis_name: Optional[str] = None) -> None:
        super().__init__(variant, reduction, axis_name)
        cfg = _DECODER_CFGS[variant]
        self.decoder = ResNetStage(self.encoder.channels, cfg, _LAYERS[variant][1],
                                   axis_name=axis_name)
        self.channels = cfg[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(super().forward(x))
