"""Plain (torchvision-style) ViT feature encoders: counterpart of
``clip_ebc_tpu/models/vit.py``.

Patchify with bias, a CLS token, a positional embedding for the
``input_size`` grid resized bicubically to other grids, pre-LN blocks
(LayerNorm eps 1e-6, the tanh GELU), ``ln_final``, then the patch grid,
bilinearly rescaled when ``reduction`` is not the patch size. The blocks
are the port's ``ResidualAttentionBlock``, so ``attn_backend`` routes
their attention as ``models/transformer.py`` ``attention_route`` says:
on the card, the fused LN + QKV + attention kernel on a window (L <= 320,
D <= 768), the tiled flash kernel on a whole image (L >= 1024), plain
otherwise (ViT-L and ViT-H, whose width the fused kernel does not take).
No sequence padding: ``kv_len`` is the real length.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import resize_bilinear
from .transformer import (
    LayerNormF32,
    PatchifyMatmul,
    ResidualAttentionBlock,
    interpolate_pos_embed,
)

_VIT_CONFIGS = {
    # name: (patch, layers, heads, hidden, mlp_dim)
    "vit_b_16": (16, 12, 12, 768, 3072),
    "vit_b_32": (32, 12, 12, 768, 3072),
    "vit_l_16": (16, 24, 16, 1024, 4096),
    "vit_l_32": (32, 24, 16, 1024, 4096),
    "vit_h_14": (14, 32, 16, 1280, 5120),
}


class ViTEncoder(nn.Module):
    def __init__(self, variant: str = "vit_b_16", image_size: int = 224,
                 reduction: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 attn_backend: str = "auto") -> None:
        super().__init__()
        patch, layers, heads, hidden, mlp_dim = _VIT_CONFIGS[variant]
        self.patch = patch
        self.channels = hidden
        self.encoder_reduction = patch
        self.reduction = reduction or patch
        self.base = image_size // patch  # the grid the positional embedding is for
        self.patchify = PatchifyMatmul(hidden, patch, dtype=dtype, bias=True)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos_embedding = nn.Parameter(torch.empty(self.base * self.base + 1, hidden))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(hidden, heads, mlp_dim / hidden, ln_epsilon=1e-6,
                                   attn_backend=attn_backend, act=nn.GELU(approximate="tanh"))
            for _ in range(layers)
        )
        self.ln_final = LayerNormF32(hidden, 1e-6)

    def init_extra_(self, generator: torch.Generator) -> None:
        """The JAX initializers of the CLS token (zeros) and of the
        positional embedding (normal, std 0.02)."""
        self.class_token.zero_()
        self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW pixels -> NCHW features at stride ``reduction``."""
        p = self.patch
        b, _, h, w = x.shape
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        gh, gw = h // p, w // p
        x = self.patchify(x.permute(0, 2, 3, 1))
        x = torch.cat([self.class_token.to(x.dtype).expand(b, 1, -1), x], dim=1)
        pos = interpolate_pos_embed(self.pos_embedding, (self.base, self.base), (gh, gw))
        x = x + pos[None].to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)[:, 1: 1 + gh * gw].reshape(b, gh, gw, -1).permute(0, 3, 1, 2)
        return resize_bilinear(x, p / self.reduction)
