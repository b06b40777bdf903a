"""CLIP-EBC: counterpart of ``clip_ebc_tpu/models/clip/model.py``.

image encoder (a frozen ViT with deep VPT, or a ModifiedResNet trained
end to end) -> bilinear up-scale from the encoder's grid to the output
reduction -> residual decoder -> 1x1 projection to the CLIP embedding ->
cosine similarity against the text-prompt features x exp(logit_scale)
-> softmax over the count bins . anchors = per-block density. The two
orders of decoder and upsample (``decoder_before_upsample``) are both
kept.

In training mode (``model.train()``) ``forward`` returns ``(logits,
density)`` and always takes the plain head (the logits are needed).
:func:`build_clip_ebc` marks what does not train with
``requires_grad_(False)``: a ViT backbone trains by VPT, the trunk and
the text tower frozen (the JAX package's ``_vpt_frozen_predicate``,
which is also what routes the trunk's attention backward to its frozen
kernel); a ResNet backbone trains every parameter but the text tower's,
its BatchNorm in train mode (``_text_frozen_predicate``). Parameter
names are the reference's torch names (``image_encoder.*``,
``vpt_{i}``, ``image_decoder.*``, ``projection.*``, ``text_encoder.*``,
``logit_scale``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...ops.fused_head import fused_ebc_head
from ...ops.quant import Int8Conv2d, Int8Linear
from ..blocks import BatchNorm, Conv2d, ResNetStage, init_conv_, resize_bilinear
from ..heads import expectation_from_logits
from ..transformer import (
    ATTN_BACKENDS,
    Linear,
    MultiHeadAttention,
    PatchifyMatmul,
    check_quant_args,
)
from .image_encoder import (RESNET_CONFIGS, VIT_CONFIGS, AttentionPool2d, ClipModifiedResNet,
                            ClipViT)
from .prompts import bin_prompts
from .text_encoder import ClipTextEncoder
from .tokenizer import tokenize
from ...utils.platform import resolve_device

# Text tower shapes per backbone: (width, heads); all have 12 layers.
TEXT_CONFIGS = {
    "resnet50": (512, 8),
    "resnet101": (512, 8),
    "resnet50x4": (640, 10),
    "resnet50x16": (768, 12),
    "resnet50x64": (1024, 16),
    "vit_b_16": (512, 8),
    "vit_b_32": (512, 8),
    "vit_l_14": (768, 12),
    "vit_l_14_336px": (768, 12),
}

# Default decoder configurations.
DECODER_CFGS = {
    "resnet50": ("bottleneck", (2048,)),
    "resnet50x4": ("bottleneck", (1280,)),
    "resnet50x16": ("bottleneck", (1536,)),
    "resnet50x64": ("bottleneck", (2048,)),
    "resnet101": ("bottleneck", (2048, 1024)),
    "vit_b_16": ("basic", (768,)),
    "vit_b_32": ("basic", (768,)),
    "vit_l_14": ("basic", (1024,)),
    "vit_l_14_336px": ("basic", (1024,)),
}

FUSED_HEAD_MODES = ("auto", "on", "off")


class ClipEBC(nn.Module):
    """CLIP-EBC blockwise count classifier over a ViT or ModifiedResNet
    backbone.

    ``attn_backend`` ("auto" | "fused" | "flash" | "sdpa") picks the
    attention path of the trunk and the text tower
    (``models/transformer.py`` ``attention_route``) and ``fused_head``
    ("auto" | "on" | "off") the head's; "auto" means the CUDA kernels for
    CUDA tensors (the fused attention kernel on windows, the tiled flash
    kernel on a full image) and the plain torch versions for CPU tensors.
    ``quant_int8`` (inference only) makes the decoder's convolutions W8A8
    and, on a ViT backbone, the trunk's projections too; a ModifiedResNet
    trunk, the 1x1 projection and the text tower stay unquantized, as in
    the JAX package. ``quant_mode="static"`` needs
    calibrated scales (``ops.quant.calibrate_int8`` on the dynamic twin,
    then ``load_quant_state``). ``axis_name`` makes every BatchNorm (a
    ResNet trunk's, the decoder's) take its training statistics over the
    global batch of all ranks."""

    def __init__(
        self,
        backbone: str,
        bins: Sequence[Tuple[float, float]],
        anchor_points: Sequence[float],
        reduction: Optional[int] = None,
        prompt_type: str = "word",
        num_vpt: int = 32,
        deep_vpt: bool = True,
        decoder_block: Optional[str] = None,
        decoder_cfg: Optional[Sequence[Union[int, str]]] = None,
        dtype: torch.dtype = torch.float32,
        attn_backend: str = "auto",
        fused_head: str = "auto",
        decoder_before_upsample: bool = False,
        vpt_drop: float = 0.0,
        quant_int8: bool = False,
        quant_mode: str = "dynamic",
        quant_attn=False,
        fuse_ln_mode: str = "auto",
        axis_name: Optional[str] = None,
    ) -> None:
        super().__init__()
        if backbone not in TEXT_CONFIGS:
            raise ValueError(f"CLIP backbone must be one of {tuple(TEXT_CONFIGS)}, got {backbone!r}")
        if len(bins) != len(anchor_points):
            raise ValueError("bins and anchor_points must have equal length")
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, got {attn_backend!r}")
        if fused_head not in FUSED_HEAD_MODES:
            raise ValueError(f"fused_head must be one of {FUSED_HEAD_MODES}, got {fused_head!r}")
        check_quant_args(quant_mode, quant_attn)
        self.backbone = backbone
        self.is_vit = backbone in VIT_CONFIGS
        self.dtype = dtype
        self.quant_int8, self.quant_mode = quant_int8, quant_mode
        self.bins = tuple(tuple(b) for b in bins)
        self.fused_head = fused_head
        self.decoder_before_upsample = decoder_before_upsample
        if self.is_vit:
            patch, width, layers, _, embed_dim = VIT_CONFIGS[backbone]
            self.encoder_reduction = patch
            self.image_encoder = ClipViT(
                backbone, dtype=dtype, attn_backend=attn_backend, vpt_drop=vpt_drop,
                quant_int8=quant_int8, quant_mode=quant_mode, quant_attn=quant_attn,
                fuse_ln_mode=fuse_ln_mode,
            )
            self.vpt_depth = (layers if deep_vpt else 1) if num_vpt > 0 else 0
        else:
            self.image_encoder = ClipModifiedResNet(backbone, reduction or 32, axis_name=axis_name)
            self.encoder_reduction = self.image_encoder.encoder_reduction
            width, embed_dim = self.image_encoder.channels, RESNET_CONFIGS[backbone][2]
            self.vpt_depth = 0
        self.out_reduction = reduction or self.encoder_reduction
        for i in range(self.vpt_depth):
            self.register_parameter(f"vpt_{i}", nn.Parameter(torch.empty(num_vpt, width)))

        block, cfg = DECODER_CFGS[backbone]
        block = decoder_block or block
        cfg = tuple(decoder_cfg) if decoder_cfg is not None else cfg
        self.decoder_cfg = cfg
        conv_cls = functools.partial(Int8Conv2d, quant_mode=quant_mode) if quant_int8 else None
        self.image_decoder = ResNetStage(width, cfg, block, conv_cls, axis_name)
        dec_out = int([c for c in cfg if c != "U"][-1])
        self.projection = Conv2d(dec_out, embed_dim, 1) if dec_out != embed_dim else None

        text_width, text_heads = TEXT_CONFIGS[backbone]
        self.text_encoder = ClipTextEncoder(
            embed_dim=embed_dim, width=text_width, heads=text_heads, layers=12, dtype=dtype,
            attn_backend=attn_backend,
        )
        tokens = tokenize(list(bin_prompts(self.bins, prompt_type)))
        self.register_buffer("text_tokens", torch.as_tensor(tokens, dtype=torch.long), persistent=False)
        self.register_buffer(
            "anchor_points", torch.tensor(list(anchor_points), dtype=torch.float32), persistent=False
        )
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def vpt(self) -> list:
        return [getattr(self, f"vpt_{i}") for i in range(self.vpt_depth)]

    def _use_fused_head(self, feats: torch.Tensor) -> bool:
        if self.fused_head == "on":
            return True
        if self.fused_head == "off":
            return False
        return feats.is_cuda

    def encode_text(self) -> torch.Tensor:
        """Prompt features ``(K, D)``; constant per weight set, so the
        Evaluator computes them once and passes ``text_feats`` in."""
        return self.text_encoder(self.text_tokens)

    def forward(
        self,
        x: torch.Tensor,
        text_feats: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``(N, H, W, 3)`` windows -> ``(N, H/r, W/r)`` fp32 density, or
        in training mode ``(logits (N, H/r, W/r, K), density)``.
        ``generator`` feeds the prompt dropout."""
        if self.is_vit:
            feats = self.image_encoder(x, self.vpt(), generator)  # (N, gh, gw, C)
            # NCHW view of the NHWC features: channels-last memory, no copy
            feats = feats.permute(0, 3, 1, 2)
        else:  # the NCHW view of the NHWC pixels, in the compute dtype
            feats = self.image_encoder(x.permute(0, 3, 1, 2).to(self.dtype))
        scale = self.encoder_reduction / self.out_reduction
        if self.decoder_before_upsample:
            feats = self.image_decoder(feats)
            if self.projection is not None:
                feats = self.projection(feats)
            feats = resize_bilinear(feats, scale)
        else:
            feats = resize_bilinear(feats, scale)
            feats = self.image_decoder(feats)
            if self.projection is not None:
                feats = self.projection(feats)
        feats = feats.permute(0, 2, 3, 1)  # (N, h, w, C)

        # the text tower is frozen: its features are constants of the step
        text_feats = (self.encode_text() if text_feats is None else text_feats).detach()
        if not self.training and self._use_fused_head(feats):
            b, hh, ww, c = feats.shape
            density = fused_ebc_head(
                feats.reshape(b * hh * ww, c), text_feats, self.logit_scale.exp(),
                self.anchor_points,
            )
            return density.reshape(b, hh, ww)

        img = feats.float()
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True).clamp_min(1e-12)
        txt = text_feats.float()
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True).clamp_min(1e-12)
        logits = self.logit_scale.exp() * torch.einsum("bhwc,nc->bhwn", img, txt)
        density = expectation_from_logits(logits, self.anchor_points)
        return (logits, density) if self.training else density

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ClipEBC":
        """Random initialization from ``generator`` (a CPU generator; call
        before moving the model to another device), following the JAX
        package's initializers up to their truncation."""
        g = generator
        for m in self.modules():
            if isinstance(m, PatchifyMatmul):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in**-0.5, generator=g)
            elif isinstance(m, (Linear, Int8Linear)):
                m.weight.normal_(0.0, m.in_features**-0.5, generator=g)
                m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5, generator=g)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
            elif isinstance(m, (Conv2d, Int8Conv2d)):
                if m is self.projection:  # lecun normal, zero bias
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
                    m.bias.zero_()
                elif isinstance(m, Conv2d) and m.kernel_init == "lecun":  # the ResNet trunk
                    init_conv_(m, g)
                else:  # kaiming normal, fan out
                    fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            elif isinstance(m, AttentionPool2d):
                m.positional_embedding.normal_(0.0, m.q_proj.in_features**-0.5, generator=g)
        enc = self.image_encoder
        if self.is_vit:
            vit_patch, vit_width = enc.patch, enc.width
            enc.class_embedding.normal_(0.0, vit_width**-0.5, generator=g)
            enc.positional_embedding.normal_(0.0, vit_width**-0.5, generator=g)
            val = math.sqrt(6.0 / (3 * vit_patch + vit_width))
            for p in self.vpt():
                p.uniform_(-val, val, generator=g)
        txt = self.text_encoder
        txt.token_embedding.weight.normal_(0.0, 0.02, generator=g)
        txt.positional_embedding.normal_(0.0, 0.01, generator=g)
        txt.text_projection.normal_(0.0, txt.text_projection.shape[0] ** -0.5, generator=g)
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self


def vpt_frozen_predicate(name: str) -> bool:
    """The parameters VPT freezes: the ViT trunk (all of ``image_encoder``;
    the prompts ``vpt_{i}`` live outside it) and the text tower. The JAX
    package's ``_vpt_frozen_predicate`` on the port's names."""
    return name.startswith(("image_encoder.", "text_encoder."))


def text_frozen_predicate(name: str) -> bool:
    """The parameters a ResNet backbone's model freezes: the text tower's
    (the JAX package's ``_text_frozen_predicate``)."""
    return name.startswith("text_encoder.")


def build_clip_ebc(
    backbone: str,
    bins,
    anchor_points,
    reduction: Optional[int] = None,
    prompt_type: str = "word",
    num_vpt: int = 32,
    deep_vpt: bool = True,
    decoder_block: Optional[str] = None,
    decoder_cfg=None,
    dtype: torch.dtype = torch.float32,
    attn_backend: str = "auto",
    fused_head: str = "auto",
    decoder_before_upsample: bool = False,
    vpt_drop: float = 0.0,
    quant_int8: bool = False,
    quant_mode: str = "dynamic",
    quant_attn=False,
    fuse_ln_mode: str = "auto",
    axis_name: Optional[str] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> ClipEBC:
    """Build a CLIP-EBC model in eval mode on ``device`` (default
    ``cuda``; raises without CUDA unless ``device="cpu"``), randomly
    initialized from ``seed`` (load weights over it to use trained ones),
    with the frozen parameters set to ``requires_grad=False``: the
    VPT-frozen ones (:func:`vpt_frozen_predicate`) of a ViT backbone, the
    text tower (:func:`text_frozen_predicate`) of a ResNet one."""
    device = resolve_device(device)
    if bins is None or anchor_points is None:
        raise ValueError("CLIP-EBC requires bins and anchor_points")
    model = ClipEBC(
        backbone=backbone, bins=bins, anchor_points=anchor_points, reduction=reduction,
        prompt_type=prompt_type, num_vpt=num_vpt, deep_vpt=deep_vpt,
        decoder_block=decoder_block, decoder_cfg=decoder_cfg, dtype=dtype,
        attn_backend=attn_backend, fused_head=fused_head,
        decoder_before_upsample=decoder_before_upsample, vpt_drop=vpt_drop,
        quant_int8=quant_int8, quant_mode=quant_mode, quant_attn=quant_attn,
        fuse_ln_mode=fuse_ln_mode, axis_name=axis_name,
    )
    model.init_weights(torch.Generator().manual_seed(seed))
    frozen = vpt_frozen_predicate if model.is_vit else text_frozen_predicate
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name))
    return model.to(device).eval()
