"""ConvNeXt-style example backbone for the custom-backbone registry:
counterpart of ``clip_ebc_tpu/models/convnext.py``.

Registered as ``convnext_nano`` through ``register_backbone``, the way a
user adds a backbone: a factory ``(input_size, reduction, dtype,
axis_name)`` returning a module with the port's backbone contract (NCHW
in, NCHW features out at stride ``reduction``; ``channels``,
``reduction``, ``encoder_reduction``).

A stride-4 stem, then stride-2 downsampling stages until the stride is
``reduction`` (8, 16 or 32). The stem and downsampling convs take flax's
``padding="SAME"`` (``SameConv2d``); LayerNorm (eps 1e-6) runs in fp32 on
the channels of an NHWC view; the GELU is the exact one. Names are the
JAX module's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, SameConv2d
from .transformer import LayerNormF32, Linear


def _nhwc(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on the NHWC view of NCHW ``x``, back to NCHW."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6) -> None:
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNormF32(dim, 1e-6)
        self.pwconv1 = Linear(dim, 4 * dim)
        self.pwconv2 = Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def init_extra_(self, generator: torch.Generator) -> None:
        self.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(h):
            h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
            return (self.gamma * h.float()).to(h.dtype)

        return x + _nhwc(mlp, self.dwconv(x))


class ConvNeXtBackbone(nn.Module):
    def __init__(self, reduction: int = 8, depths: Sequence[int] = (2, 2, 4),
                 dims: Sequence[int] = (48, 96, 192)) -> None:
        super().__init__()
        if reduction not in (8, 16, 32):
            raise ValueError(f"reduction must be 8/16/32, got {reduction}")
        self.reduction = self.encoder_reduction = reduction
        n_stages = {8: 2, 16: 3, 32: 4}[reduction]
        self.channels = dims[min(n_stages, len(dims)) - 1]
        self.stem = SameConv2d(3, dims[0], 4, stride=4)
        self.stem_norm = LayerNormF32(dims[0], 1e-6)
        self._stages = []
        ch = dims[0]
        for s in range(n_stages):
            di = min(s, len(dims) - 1)
            if s > 0:
                self.add_module(f"down_norm_{s}", LayerNormF32(ch, 1e-6))
                self.add_module(f"down_{s}", SameConv2d(ch, dims[di], 2, stride=2))
                ch = dims[di]
            names = [f"stage{s}_block{b}" for b in range(depths[min(di, len(depths) - 1)])]
            for name in names:
                self.add_module(name, _ConvNeXtBlock(ch))
            self._stages.append((s, names))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nhwc(self.stem_norm, self.stem(x))
        for s, names in self._stages:
            if s > 0:
                x = getattr(self, f"down_{s}")(_nhwc(getattr(self, f"down_norm_{s}"), x))
            for name in names:
                x = getattr(self, name)(x)
        return x


def _register() -> None:
    from . import register_backbone

    @register_backbone("convnext_nano")
    def make_convnext_nano(input_size, reduction, dtype, axis_name):
        return ConvNeXtBackbone(reduction=reduction)
