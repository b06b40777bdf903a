"""Shared building blocks: counterpart of ``clip_ebc_tpu/models/blocks.py``.

NCHW tensors, as torch's convolutions prefer; the models hand them a
channels-last view of their NHWC input, so no copy is made going in or
out. Parameters are fp32 and convolutions compute in the input's dtype.
Names follow the reference's torch modules: the decoder's
``conv1``/``bn1``/``conv2``/``bn2``/``downsample.{0,1}``, and the VGG
stack's torchvision ``Sequential`` indices (a convolution, its
BatchNorm, its ReLU, a pool each take one), so its state dicts load as
they are.

Initializers (:func:`init_conv_`) follow the JAX package's: a ``Conv2d``
built with ``kernel_init="kaiming_out"`` (the JAX ``kaiming_normal_out``:
normal, std sqrt(2 / fan_out)) or ``"lecun"`` (flax's default
``lecun_normal``: a normal truncated at two standard deviations, fan in),
biases zero.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum_autograd, get_world_size

KERNEL_INITS = ("kaiming_out", "lecun")


def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on NCHW: half-pixel centers,
    and a triangle filter widened by the scale (antialiasing) along an axis
    that shrinks, which is what torch's ``antialias=True`` computes (in
    fp32 here, then cast back)."""
    h, w = x.shape[-2:]
    if size[0] >= h and size[1] >= w:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    # torch's antialiased kernel takes no bf16: it runs in fp32 here
    y = F.interpolate(x.float(), size=size, mode="bilinear", align_corners=False, antialias=True)
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize of NCHW by a scale factor, as the JAX package's
    ``resize_bilinear``: antialiased when it shrinks."""
    h, w = x.shape[-2:]
    nh, nw = int(h * scale), int(w * scale)
    if (nh, nw) == (h, w):
        return x
    return _resize(x, (nh, nw))


def resize_to(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW to ``size`` (the JAX ``resize_to``)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return _resize(x, tuple(size))


def kaiming_normal_out_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The JAX ``kaiming_normal_out``: normal, std sqrt(2 / fan_out), fan
    out = out channels x kernel area."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    return weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +-2 of its own std,
    scaled so the result's std is sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with fp32 parameters that computes in its input's
    dtype. ``kernel_init`` names the JAX initializer of its kernel."""

    def __init__(self, *args, kernel_init: str = "lecun", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if kernel_init not in KERNEL_INITS:
            raise ValueError(f"kernel_init must be one of {KERNEL_INITS}, got {kernel_init!r}")
        self.kernel_init = kernel_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class SameConv2d(Conv2d):
    """``Conv2d`` with flax's ``padding="SAME"``: the output is
    ceil(in / stride) and the padding that needs, split with the smaller
    half first (asymmetric where the total is odd), as XLA pads; torch's
    symmetric padding differs on a size the stride does not divide."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, padding=0, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s, d in zip(x.shape[-2:], self.kernel_size, self.stride, self.dilation):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


@torch.no_grad()
def init_conv_(m: Conv2d, generator: torch.Generator) -> None:
    """Initialize ``m`` by its ``kernel_init``; a bias starts at zero."""
    if m.kernel_init == "kaiming_out":
        kaiming_normal_out_(m.weight, generator)
    else:
        lecun_normal_(m.weight, m.weight[0].numel(), generator)
    if m.bias is not None:
        m.bias.zero_()


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax's) semantics, eps 1e-5.

    Eval: the running statistics fold into a per-channel fp32 scale and
    shift, applied in the input's dtype. Train: batch mean and biased
    variance over (N, H, W) in fp32, applied in fp32 and cast back; the
    running statistics move by torch momentum 0.1 (flax 0.9) towards the
    batch mean and the BIASED batch variance, as flax updates them (torch's
    own BatchNorm would take the unbiased one). With ``axis_name`` (the
    data axis, ``parallel.mesh.DATA_AXIS``) and more than one rank, the
    batch is the global one, as under the JAX package's mesh: the mean,
    then the squared deviations from it, are summed over the ranks
    (differentiably: the backward sums the gradients of the sums too), so
    every rank normalizes with, and moves its running statistics by, the
    same global statistics."""

    def __init__(self, channels: int, axis_name: Optional[str] = None) -> None:
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.axis_name = axis_name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            scale = self.weight * torch.rsqrt(self.running_var + self.eps)
            shift = self.bias - self.running_mean * scale
            return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        xf = x.float()
        if self.axis_name is not None and get_world_size() > 1:
            var, mean = _global_var_mean(xf)
        else:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _global_var_mean(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The biased variance and the mean per channel of NCHW ``xf`` over
    every rank's batch: two differentiable all-reduces of per-channel sums
    (the element count rides with the first)."""
    n = xf.new_full((1,), xf.numel() // xf.shape[1])
    sums = all_reduce_sum_autograd(torch.cat([xf.sum((0, 2, 3)), n]))
    count = sums[-1]
    mean = sums[:-1] / count
    sq = all_reduce_sum_autograd((xf - mean[:, None, None]).square().sum((0, 2, 3)))
    return sq / count, mean


class ConvBNAct(nn.Sequential):
    """Conv -> optional BatchNorm -> optional ReLU, as ``0``/``1``/``2``
    (``0``/``1`` without the BatchNorm). ``use_bn`` defaults to True here
    (the decoder's shortcut); ``bias`` defaults to ``not use_bn``, as in
    the JAX ``ConvBNAct``; ``kernel_init`` to its ``kaiming_normal_out``.
    A k x k kernel pads (k - 1) // 2 x ``dilation``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 act: bool = True, conv_cls=None, stride: int = 1, dilation: int = 1,
                 use_bn: bool = True, bias: Optional[bool] = None,
                 kernel_init: str = "kaiming_out", axis_name: Optional[str] = None) -> None:
        bias = (not use_bn) if bias is None else bias
        kw = dict(stride=stride, padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
                  bias=bias)
        conv = (conv_cls(in_channels, features, kernel_size, **kw) if conv_cls is not None
                else Conv2d(in_channels, features, kernel_size, kernel_init=kernel_init, **kw))
        layers = [conv]
        if use_bn:
            layers.append(BatchNorm(features, axis_name))
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BasicBlock(nn.Module):
    """Decoder residual block: 3x3 -> BN -> ReLU -> 3x3 -> BN, plus a
    1x1 + BN shortcut when the channel count changes, then ReLU.
    ``conv_cls`` replaces every convolution (``ops.quant.Int8Conv2d``)."""

    def __init__(self, in_channels: int, features: int, conv_cls=None,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        conv = conv_cls or _kaiming_conv
        self.conv1 = conv(in_channels, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(features, axis_name)
        self.conv2 = conv(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features, axis_name)
        self.downsample = (
            ConvBNAct(in_channels, features, 1, act=False, conv_cls=conv_cls,
                      axis_name=axis_name)
            if in_channels != features else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BottleneckBlock(nn.Module):
    """Decoder bottleneck with expansion 1 (the only one the decoders
    use): 1x1 -> 3x3 -> 1x1, each with BN, ReLU after the first two, a
    1x1 + BN shortcut when the channel count changes, then ReLU."""

    def __init__(self, in_channels: int, features: int, conv_cls=None,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        conv = conv_cls or _kaiming_conv
        self.conv1 = conv(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features, axis_name)
        self.conv2 = conv(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features, axis_name)
        self.conv3 = conv(features, features, 1, bias=False)
        self.bn3 = BatchNorm(features, axis_name)
        self.downsample = (
            ConvBNAct(in_channels, features, 1, act=False, conv_cls=conv_cls,
                      axis_name=axis_name)
            if in_channels != features else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _kaiming_conv(*args, **kwargs) -> Conv2d:
    return Conv2d(*args, kernel_init="kaiming_out", **kwargs)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, 2.0)


class ResNetStage(nn.Sequential):
    """Decoder stack from a token config: ints are residual blocks
    (``block`` "basic" or "bottleneck"), ``"U"`` a 2x bilinear upsample.
    Sequential indices count the ``"U"`` entries, as the reference's
    ``make_resnet_layers`` does."""

    def __init__(self, in_channels: int, cfg: Sequence[Union[int, str]],
                 block: str = "basic", conv_cls=None, axis_name: Optional[str] = None) -> None:
        blocks = {"basic": BasicBlock, "bottleneck": BottleneckBlock}
        if block not in blocks:
            raise ValueError(f"decoder block must be one of {tuple(blocks)}, got {block!r}")
        layers = []
        ch = in_channels
        for v in cfg:
            if v == "U":
                layers.append(Upsample2x())
            else:
                layers.append(blocks[block](ch, int(v), conv_cls, axis_name))
                ch = int(v)
        super().__init__(*layers)


class VGGStage(nn.Sequential):
    """VGG feature stack from a token config, in torchvision's layout:
    an int is a 3x3 conv with bias (-> BN) -> ReLU, ``"M"`` a 2x2 max-pool
    of stride 2, ``"U"`` a 2x bilinear upsample; each layer takes one
    Sequential index. ``dilation`` dilates (and pads) every conv."""

    def __init__(self, in_channels: int, cfg: Sequence[Union[int, str]],
                 use_bn: bool = False, dilation: int = 1,
                 axis_name: Optional[str] = None) -> None:
        layers = []
        ch = in_channels
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            elif v == "U":
                layers.append(Upsample2x())
            else:
                layers.append(Conv2d(ch, int(v), 3, padding=dilation, dilation=dilation,
                                     kernel_init="kaiming_out"))
                if use_bn:
                    layers.append(BatchNorm(int(v), axis_name))
                layers.append(nn.ReLU())
                ch = int(v)
        self.out_channels = ch
        super().__init__(*layers)


# VGG configurations A/B/D/E: four "M" tokens, the fifth torchvision pool
# dropped, so the native reduction is 16.
VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512, 512, 512, 512],
}
