"""DenseNet features-only backbone: counterpart of
``clip_ebc_tpu/models/densenet.py``.

Dense layers are BN -> ReLU -> 1x1 (bottleneck) -> BN -> ReLU -> 3x3
(growth), concatenated on the channels; transitions are BN -> ReLU ->
1x1 (half) -> 2x2 average pool. The output is the post-norm feature map.
Native reduction 32; ``reduction <= 16`` drops transition 3's pool (16);
a bilinear rescale covers the rest. Names are the JAX module's (``stem``,
``stem_bn``, ``block{b}_layer{l}.{bn1,conv1,bn2,conv2}``,
``trans{b}_{bn,conv}``, ``final_bn``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv2d, resize_bilinear

# variant: (growth_rate, block_config, stem_features)
_CONFIGS = {
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
}
_BN_SIZE = 4  # bottleneck width multiplier (torch DenseNet default)


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int, axis_name: Optional[str] = None) -> None:
        super().__init__()
        self.bn1 = BatchNorm(cin, axis_name)
        self.conv1 = Conv2d(cin, _BN_SIZE * growth, 1, bias=False)
        self.bn2 = BatchNorm(_BN_SIZE * growth, axis_name)
        self.conv2 = Conv2d(_BN_SIZE * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return torch.cat([x, h], dim=1)


class DenseNetBackbone(nn.Module):
    def __init__(self, variant: str = "densenet121", reduction: int = 32,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        growth, blocks, stem = _CONFIGS[variant]
        self.reduction = reduction
        self.encoder_reduction = 16 if reduction <= 16 else 32
        self.stem = Conv2d(3, stem, 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(stem, axis_name)
        ch = stem
        self._plan = []  # (module names, average-pool after) of each block
        for bi, n in enumerate(blocks):
            names = []
            for li in range(n):
                self.add_module(f"block{bi + 1}_layer{li + 1}", _DenseLayer(ch, growth, axis_name))
                names.append(f"block{bi + 1}_layer{li + 1}")
                ch += growth
            pool = False
            if bi < len(blocks) - 1:
                self.add_module(f"trans{bi + 1}_bn", BatchNorm(ch, axis_name))
                self.add_module(f"trans{bi + 1}_conv", Conv2d(ch, ch // 2, 1, bias=False))
                names += [f"trans{bi + 1}_bn", f"trans{bi + 1}_conv"]
                ch //= 2
                pool = not (bi == 2 and reduction <= 16)
            self._plan.append((names, pool))
        self.final_bn = BatchNorm(ch, axis_name)
        self.channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for names, pool in self._plan:
            for name in names:
                m = getattr(self, name)
                x = F.relu(m(x)) if name.endswith("_bn") else m(x)
            if pool:
                x = F.avg_pool2d(x, 2, 2)
        x = F.relu(self.final_bn(x))
        return resize_bilinear(x, self.encoder_reduction / self.reduction)
