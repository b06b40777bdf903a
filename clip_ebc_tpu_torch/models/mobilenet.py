"""MobileNetV2 features-only backbone: counterpart of
``clip_ebc_tpu/models/mobilenet.py``.

The output is the 320-channel last inverted-residual stage (before the
1280-wide classifier conv). Native reduction 32; ``reduction <= 16`` puts
the 160-channel stage at stride 1 (16); a bilinear rescale covers the
rest. Names are the JAX module's (``stem``, ``stem_bn``,
``stage{s}_{b}.{expand,dw,project}[_bn]``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv2d, resize_bilinear

# (expand_ratio t, out channels c, repeats n, first stride s)
_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),  # stage index 5: stride 1 when reduction <= 16
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 (stride) -> project 1x1, ReLU6 after the
    first two, residual when stride 1 and the channels match."""

    def __init__(self, cin: int, features: int, stride: int = 1, expand_ratio: int = 6,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        hidden = cin * expand_ratio
        self.residual = stride == 1 and cin == features
        if expand_ratio != 1:
            self.expand = Conv2d(cin, hidden, 1, bias=False)
            self.expand_bn = BatchNorm(hidden, axis_name)
        else:
            self.expand = self.expand_bn = None
        self.dw = Conv2d(hidden, hidden, 3, stride=stride, padding=1, groups=hidden, bias=False)
        self.dw_bn = BatchNorm(hidden, axis_name)
        self.project = Conv2d(hidden, features, 1, bias=False)
        self.project_bn = BatchNorm(features, axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.expand is not None:
            out = F.relu6(self.expand_bn(self.expand(out)))
        out = F.relu6(self.dw_bn(self.dw(out)))
        out = self.project_bn(self.project(out))
        return out + x if self.residual else out


class MobileNetV2Backbone(nn.Module):
    def __init__(self, reduction: int = 32, width_mult: float = 1.0,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.reduction = reduction
        self.encoder_reduction = 16 if reduction <= 16 else 32

        def c(ch):  # width multiplier, rounded to multiples of 8 like torchvision
            ch = ch * width_mult
            return max(int(ch + 4) // 8 * 8, 8) if width_mult != 1.0 else int(ch)

        self.channels = max(int(320 * width_mult), 8)
        self.stem = Conv2d(3, c(32), 3, stride=2, padding=1, bias=False)
        self.stem_bn = BatchNorm(c(32), axis_name)
        cin = c(32)
        names = []
        for si, (t, ch, n, s) in enumerate(_STAGES):
            if si == 5 and reduction <= 16:
                s = 1
            for bi in range(n):
                self.add_module(f"stage{si}_{bi}",
                                InvertedResidual(cin, c(ch), s if bi == 0 else 1, t, axis_name))
                names.append(f"stage{si}_{bi}")
                cin = c(ch)
        self._blocks = names

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.stem_bn(self.stem(x)))
        for name in self._blocks:
            x = getattr(self, name)(x)
        return resize_bilinear(x, self.encoder_reduction / self.reduction)
