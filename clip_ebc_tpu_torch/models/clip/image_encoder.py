"""CLIP ViT image encoder, features only: counterpart of
``clip_ebc_tpu/models/clip/image_encoder.py`` ``ClipViT``.

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
the caller's ``torch.Generator``. ``quant_int8`` makes the trunk's
projections W8A8 (``ops/quant.py``); the patchify stays unquantized. The
ModifiedResNet encoders are a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..transformer import LayerNormF32, PatchifyMatmul, Transformer, interpolate_pos_embed

VIT_CONFIGS = {
    # name: (patch, width, layers, heads, embed_dim)
    "vit_b_32": (32, 768, 12, 12, 512),
    "vit_b_16": (16, 768, 12, 12, 512),
    "vit_l_14": (14, 1024, 24, 16, 768),
    "vit_l_14_336px": (14, 1024, 24, 16, 768),
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
                noise = torch.rand(pr.shape, generator=generator, device=pr.device)
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
