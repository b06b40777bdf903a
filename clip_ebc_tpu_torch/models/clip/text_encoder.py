"""CLIP text encoder: counterpart of ``clip_ebc_tpu/models/clip/text_encoder.py``.

Token + positional embedding -> causal-masked pre-LN transformer
(QuickGELU) -> ``ln_final`` -> EOT-token pooling through
``text_projection``. ``attn_backend`` routes each block's attention
(``models/transformer.py`` ``attention_route``): ``"flash"`` takes the
flash kernel with ``causal=True``; every other backend, ``"auto"``
included (77 tokens are below ``FLASH_MIN_SEQ_LEN``, as the JAX
``adaptive`` keeps them), the plain attention with the additive mask.
"""

from __future__ import annotations

import torch
from torch import nn

from ..transformer import LayerNormF32, Transformer


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (upper triangle = -inf)."""
    return torch.full((length, length), -float("inf"), device=device).triu(1)


class ClipTextEncoder(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        context_length: int = 77,
        vocab_size: int = 49408,
        width: int = 512,
        heads: int = 8,
        layers: int = 12,
        dtype: torch.dtype = torch.float32,
        attn_backend: str = "auto",
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, attn_backend=attn_backend)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``(N, context_length)`` int tokens -> ``(N, embed_dim)`` features."""
        x = self.token_embedding(tokens).to(self.dtype)
        x = x + self.positional_embedding[None, : x.shape[1]].to(self.dtype)
        mask = causal_mask(x.shape[1], x.device)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, mask, causal=True)
        x = self.ln_final(x)
        # EOT pooling: the EOT token holds the largest id in each sequence
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return pooled @ self.text_projection.to(pooled.dtype)
