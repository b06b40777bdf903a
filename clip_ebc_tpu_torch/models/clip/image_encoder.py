"""CLIP image encoders, features only: counterpart of
``clip_ebc_tpu/models/clip/image_encoder.py`` (``ClipViT``,
``ClipBottleneck``, ``AttentionPool2d``, ``ClipModifiedResNet``).

Patchify (one matmul), CLS token, bicubic positional-embedding resize
for other grids, ``ln_pre``, the pre-LN trunk with deep VPT, ``ln_post``,
then the patch grid. VPT prompts are owned by the CLIP-EBC model
(``vpt_{i}``, the reference's names) and passed in: they sit at rows
``[1, 1 + num_vpt)`` for the whole trunk, and deep VPT overwrites those
rows before blocks 1..depth-1, which equals the reference's
strip-and-reinsert. No sequence padding: ``kv_len`` is the real length,
so a full image's trunk (L >= 1024 tokens) goes to the flash kernel with
no mask under ``attn_backend="auto"`` and every token attends to every
other, as in the reference.
In training mode, ``vpt_drop`` drops prompt entries (flax ``Dropout``
semantics: keep with 1 - rate, scale by 1 / (1 - rate)) with noise from
the caller's ``torch.Generator``; under data parallelism each rank draws
the noise of the global batch and keeps its own rows. ``quant_int8``
makes the trunk's projections W8A8 (``ops/quant.py``); the patchify
stays unquantized.

``ClipModifiedResNet`` is CLIP's ModifiedResNet: a 3-conv stem (the
first at stride 2) and a 2x2 average pool, then four stages of
anti-aliased bottlenecks (every conv at stride 1, a 2x2 average pool
after conv2 where the stage strides, the shortcut an average pool and a
1x1 conv), layer4 at stride 1 when ``reduction <= 16``. The pools floor
an odd grid, as flax's ``VALID`` pooling does. It takes the NCHW image
and returns NCHW features (``features_only``) or, with the attention
pool, the pooled ``(B, embed_dim)`` embedding. Names are the reference's
torch names (``conv1``/``bn1`` .. ``conv3``/``bn3``,
``layer{i}.{j}.conv{1-3}``/``bn{1-3}``/``downsample.{0,1}``,
``attnpool.{q,k,v,c}_proj``); the convolutions stay on cuDNN, as they
are plain XLA in the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import get_rank, get_world_size
from ..blocks import BatchNorm, Conv2d
from ..transformer import (LayerNormF32, Linear, PatchifyMatmul, Transformer,
                           interpolate_pos_embed, sdpa_attention)

VIT_CONFIGS = {
    # name: (patch, width, layers, heads, embed_dim)
    "vit_b_32": (32, 768, 12, 12, 512),
    "vit_b_16": (16, 768, 12, 12, 512),
    "vit_l_14": (14, 1024, 24, 16, 768),
    "vit_l_14_336px": (14, 1024, 24, 16, 768),
}

RESNET_CONFIGS = {
    # name: (layers, width, embed_dim, heads)
    "resnet50": ((3, 4, 6, 3), 64, 1024, 32),
    "resnet101": ((3, 4, 23, 3), 64, 512, 32),
    "resnet50x4": ((4, 6, 10, 6), 80, 640, 40),
    "resnet50x16": ((6, 8, 18, 8), 96, 768, 48),
    "resnet50x64": ((3, 15, 36, 10), 128, 1024, 64),
}


class ClipViT(nn.Module):
    def __init__(
        self,
        variant: str = "vit_b_16",
        dtype: torch.dtype = torch.float32,
        attn_backend: str = "auto",
        vpt_drop: float = 0.0,
        quant_int8: bool = False,
        quant_mode: str = "dynamic",
        quant_attn=False,
        fuse_ln_mode: str = "auto",
    ) -> None:
        super().__init__()
        if not 0.0 <= vpt_drop < 1.0:
            raise ValueError(f"vpt_drop must be in [0, 1), got {vpt_drop}")
        patch, width, layers, heads, _ = VIT_CONFIGS[variant]
        self.variant = variant
        self.vpt_drop = vpt_drop
        self.patch = patch
        self.width = width
        self.base = 336 // patch if variant.endswith("336px") else 224 // patch
        self.conv1 = PatchifyMatmul(width, patch, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(self.base * self.base + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = Transformer(
            width, layers, heads, attn_backend, quant_int8=quant_int8, quant_mode=quant_mode,
            quant_attn=quant_attn, fuse_ln_mode=fuse_ln_mode,
        )
        self.ln_post = LayerNormF32(width)

    def forward(
        self,
        x: torch.Tensor,
        vpt: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``(B, H, W, 3)`` pixels -> ``(B, H/p, W/p, width)`` features.
        ``vpt``: one ``(num_vpt, width)`` prompt per layer (deep VPT) or a
        single one (shallow), or None. ``generator`` feeds the prompt
        dropout in training mode when ``vpt_drop`` > 0."""
        p, width = self.patch, self.width
        b, h, w, _ = x.shape
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        gh, gw = h // p, w // p
        x = self.conv1(x)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, width)
        x = torch.cat([cls, x], dim=1)
        pos = interpolate_pos_embed(self.positional_embedding, (self.base, self.base), (gh, gw))
        x = self.ln_pre(x + pos[None].to(x.dtype))

        n_vpt = vpt[0].shape[0] if vpt else 0

        def prompts(i: int) -> torch.Tensor:
            pr = vpt[i].to(x.dtype).expand(b, n_vpt, width)
            if self.training and self.vpt_drop > 0:
                keep = 1.0 - self.vpt_drop
                # the noise of the global batch, this rank's rows: N ranks of
                # b windows drop what one process of N x b drops
                world, rank = get_world_size(), get_rank()
                noise = torch.rand((world * b,) + pr.shape[1:], generator=generator,
                                   device=pr.device)[rank * b:(rank + 1) * b]
                pr = torch.where(noise < keep, pr / keep, torch.zeros((), dtype=pr.dtype, device=pr.device))
            return pr

        if vpt:
            x = torch.cat([x[:, :1], prompts(0), x[:, 1:]], dim=1)
        for i, block in enumerate(self.transformer.resblocks):
            if vpt and 0 < i < len(vpt):
                x[:, 1 : 1 + n_vpt] = prompts(i)
            x = block(x)
        # ln_post is per token: slice the patch grid straight out afterwards
        x = self.ln_post(x)
        return x[:, 1 + n_vpt : 1 + n_vpt + gh * gw].reshape(b, gh, gw, width)


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``stride`` x ``stride`` average pool, flooring an odd grid (flax's
    ``VALID``), in x's dtype."""
    return F.avg_pool2d(x, stride, stride) if stride > 1 else x


class ClipBottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: 1x1 -> 3x3 -> (avg pool) -> 1x1 x4,
    each conv at stride 1 with its BatchNorm, ReLU after the first two;
    the shortcut an average pool and a 1x1 conv + BN where the stride or
    the width changes, then ReLU."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, axis_name)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, axis_name)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out, axis_name)
        self.downsample = None
        if stride > 1 or in_channels != out:
            self.downsample = nn.Sequential(OrderedDict(
                [("0", Conv2d(in_channels, out, 1, bias=False)),
                 ("1", BatchNorm(out, axis_name))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avg_pool(out, self.stride)))
        identity = x if self.downsample is None else self.downsample(_avg_pool(x, self.stride))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Global attention pool: the mean token, prepended to the grid, is
    the one query over every position (the positional embedding is
    sliced to the sequence, not resized, as in the JAX module); ``(B, C,
    H, W)`` -> ``(B, output_dim)``."""

    def __init__(self, spacial_dim: int, channels: int, num_heads: int, output_dim: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim + 1, channels))
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.c_proj = Linear(channels, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        seq = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding[None, : seq.shape[1]].to(seq.dtype)
        nh, dh = self.num_heads, c // self.num_heads

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, t.shape[1], nh, dh).transpose(1, 2)

        q = heads(self.q_proj(seq[:, :1]))
        out = sdpa_attention(q, heads(self.k_proj(seq)), heads(self.v_proj(seq)), None)
        return self.c_proj(out.transpose(1, 2).reshape(b, 1, c))[:, 0]


class ClipModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet (``RESNET_CONFIGS``); ``encoder_reduction`` is
    16 when ``reduction <= 16`` (layer4 at stride 1), else 32.
    ``features_only=False`` adds the attention pool over an
    ``input_size`` / 32 grid (the joint CLIP model's image embedding)."""

    def __init__(self, variant: str = "resnet50", reduction: int = 32,
                 features_only: bool = True, input_size: int = 224,
                 axis_name: Optional[str] = None) -> None:
        super().__init__()
        counts, width, embed_dim, heads = RESNET_CONFIGS[variant]
        self.variant = variant
        self.features_only = features_only
        self.encoder_reduction = 16 if reduction <= 16 else 32
        self.channels = width * 32 if features_only else embed_dim
        self.clip_embed_dim = embed_dim
        cin = 3
        for i, (ch, stride) in enumerate(((width // 2, 2), (width // 2, 1), (width, 1))):
            self.add_module(f"conv{i + 1}", Conv2d(cin, ch, 3, stride=stride, padding=1, bias=False))
            self.add_module(f"bn{i + 1}", BatchNorm(ch, axis_name))
            cin = ch
        strides = (1, 2, 2, 1 if reduction <= 16 else 2)
        for li, (n, s) in enumerate(zip(counts, strides)):
            planes = width * 2**li
            blocks = []
            for bi in range(n):
                blocks.append(ClipBottleneck(cin, planes, s if bi == 0 else 1, axis_name))
                cin = planes * ClipBottleneck.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.attnpool = (None if features_only else
                         AttentionPool2d((input_size // 32) ** 2, cin, heads, embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, 3, H, W)`` (a channels-last view in the compute dtype) ->
        ``(B, C, H/r, W/r)`` features, or ``(B, embed_dim)`` pooled."""
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = _avg_pool(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x if self.attnpool is None else self.attnpool(x)
