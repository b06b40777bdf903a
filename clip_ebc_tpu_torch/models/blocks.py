"""Decoder building blocks: counterpart of ``clip_ebc_tpu/models/blocks.py``.

NCHW tensors, as torch's convolutions prefer; the CLIP-EBC model hands
them a channels-last view of its NHWC features, so no copy is made going
in or out. Parameters are fp32 and convolutions compute in the input's
dtype. Names follow the reference's torch decoder (``conv1``/``bn1``/
``conv2``/``bn2``/``downsample.{0,1}``), so its state dicts load as they
are.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def resize_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize of NCHW by a scale factor (half-pixel centers,
    ``align_corners=False``, as ``jax.image.resize`` upsamples)."""
    h, w = x.shape[-2:]
    nh, nw = int(h * scale), int(w * scale)
    if (nh, nw) == (h, w):
        return x
    return F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with fp32 parameters that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax's) semantics, eps 1e-5.

    Eval: the running statistics fold into a per-channel fp32 scale and
    shift, applied in the input's dtype. Train: batch mean and biased
    variance over (N, H, W) in fp32, applied in fp32 and cast back; the
    running statistics move by torch momentum 0.1 (flax 0.9) towards the
    batch mean and the BIASED batch variance, as flax updates them (torch's
    own BatchNorm would take the unbiased one)."""

    def __init__(self, channels: int) -> None:
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBNAct(nn.Sequential):
    """Conv (no bias) -> BatchNorm -> optional ReLU, as ``0``/``1``/``2``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 act: bool = True, conv_cls=None) -> None:
        layers = [
            (conv_cls or Conv2d)(in_channels, features, kernel_size,
                                 padding=(kernel_size - 1) // 2, bias=False),
            BatchNorm(features),
        ]
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BasicBlock(nn.Module):
    """Decoder residual block: 3x3 -> BN -> ReLU -> 3x3 -> BN, plus a
    1x1 + BN shortcut when the channel count changes, then ReLU.
    ``conv_cls`` replaces every convolution (``ops.quant.Int8Conv2d``)."""

    def __init__(self, in_channels: int, features: int, conv_cls=None) -> None:
        super().__init__()
        conv = conv_cls or Conv2d
        self.conv1 = conv(in_channels, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = (
            ConvBNAct(in_channels, features, 1, act=False, conv_cls=conv_cls)
            if in_channels != features else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, 2.0)


class ResNetStage(nn.Sequential):
    """Decoder stack from a token config: ints are residual blocks, ``"U"``
    a 2x bilinear upsample. Sequential indices count the ``"U"`` entries,
    as the reference's ``make_resnet_layers`` does."""

    def __init__(self, in_channels: int, cfg: Sequence[Union[int, str]],
                 block: str = "basic", conv_cls=None) -> None:
        if block != "basic":
            raise NotImplementedError(
                f"decoder block {block!r} (ResNet backbones) is not ported yet "
                "(ROADMAP Queue 1, other CLIP backbones)"
            )
        layers = []
        ch = in_channels
        for v in cfg:
            if v == "U":
                layers.append(Upsample2x())
            else:
                layers.append(BasicBlock(ch, int(v), conv_cls))
                ch = int(v)
        super().__init__(*layers)
