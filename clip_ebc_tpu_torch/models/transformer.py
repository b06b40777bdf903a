"""Transformer building blocks for the CLIP towers: counterpart of
``clip_ebc_tpu/models/transformer.py``.

Batch-major ``(B, L, D)`` pre-LN blocks with QuickGELU, in torch's CLIP
parameter layout (``attn.in_proj_weight``, ``mlp.c_fc`` ...). Parameters
are fp32; linear layers compute in the dtype of their input, which the
tower's first layer sets (``PatchifyMatmul``/the token embedding), and
LayerNorm computes in fp32 and casts back.

``attn_backend`` picks the attention path of a block (the table is
:func:`attention_route`): ``"fused"`` hands ln_1, the qkv projection and
the attention to ``ops.fused_attention.fused_ln_qkv_attention`` where its
kernel applies; ``"flash"`` hands every attention to
``ops.flash_attention.flash_attention`` (the text tower's with
``causal=True``); ``"sdpa"`` runs them as plain torch ops; ``"auto"``
means, on a CUDA tensor, the fused kernel where it applies, the flash
kernel for an unmasked sequence of at least ``FLASH_MIN_SEQ_LEN`` tokens
(the full image) and the plain ops otherwise, and the plain ops on a CPU
tensor, as the JAX ``"auto"`` means Pallas on a TPU.

``quant_int8`` makes every projection of a block W8A8 (``ops/quant.py``).
On the kernel path a static block hands ln_1, the int8 projection and the
attention to ``fused_ln_qkv_attention_int8``; a dynamic block, a
calibration pass and ``fuse_ln_mode="off"`` keep ln_1 and the projection
outside and hand the qkv to ``fused_qkv_attention``. ``quant_attn`` (the
JAX package's False | True | "xla") makes a static block's attention int8
too: ``True`` on that fused LN route only (the kernel takes the calibrated
``qkv_amax`` scales), ``"xla"`` on every unmasked attention of the block
through ``ops.int8_attention.int8_qkv_attention``, after the unfused int8
projection.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import HEAD_DIM as FLASH_HEAD_DIM
from ..ops.flash_attention import flash_attention
from ..ops.fused_attention import (
    MAX_FUSED_SEQ,
    MAX_FUSED_SEQ_INT8_ATTN,
    fused_ln_qkv_attention,
    fused_ln_qkv_attention_int8,
    fused_qkv_attention,
    supports,
)
from ..ops.int8_attention import int8_qkv_attention
from ..ops.interpolate import torch_bicubic_resize
from ..ops.quant import (
    QUANT_ATTN_MODES,
    QUANT_MODES,
    Int8Linear,
    Cached,
    checked_act_scale,
    checked_attn_scales,
    int8_linear,
    quantize_weight,
    record_amax,
)

ATTN_BACKENDS = ("auto", "fused", "flash", "sdpa")
FUSE_LN_MODES = ("auto", "off")
# Shortest sequence "auto" sends to the flash kernel (JAX transformer.py:31):
# below it the plain attention's (L, L) scores are small.
FLASH_MIN_SEQ_LEN = 1024
# What a block's attention may be masked by: nothing, the causal text mask,
# keys >= kv_len, or another additive mask.
MASK_KINDS = ("none", "causal", "padding", "other")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


def attention_route(backend: str, device_type: str, seq_len: int, mask: str,
                    num_heads: int = 12, head_dim: int = 64, int8_attn: bool = False) -> str:
    """The attention path of a block: ``"fused"`` (the LN + qkv + attention
    kernel, which masks keys >= kv_len itself), ``"flash"``
    (``flash_attention``; a causal mask goes in as ``causal=True``) or
    ``"plain"`` (``sdpa_attention`` with the additive mask).

    * ``"sdpa"``: plain.
    * ``"fused"``: fused where the kernel applies (no mask tensor, the
      shapes of :func:`~..ops.fused_attention.supports`: up to
      MAX_FUSED_SEQ tokens, up to MAX_FUSED_SEQ_INT8_ATTN for a block
      whose attention is int8 on the fused LN route, ``int8_attn``), else
      plain.
    * ``"flash"``: flash for no mask and for the causal mask, plain for a
      key-padding or any other mask (the flash kernel has no ``kv_len``).
    * ``"auto"``: on ``cuda``, fused where it applies, then flash for an
      unmasked sequence of at least FLASH_MIN_SEQ_LEN tokens, else plain
      (the JAX package's einsum path below that length); plain on any
      other device.

    A key-padding mask is never read as causal."""
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, got {backend!r}")
    if mask not in MASK_KINDS:
        raise ValueError(f"mask must be one of {MASK_KINDS}, got {mask!r}")
    max_seq = MAX_FUSED_SEQ_INT8_ATTN if int8_attn else MAX_FUSED_SEQ
    fits = mask in ("none", "padding") and supports(num_heads, head_dim, seq_len, max_seq)
    if backend == "fused":
        return "fused" if fits else "plain"
    if backend == "flash":
        return "flash" if mask in ("none", "causal") and head_dim == FLASH_HEAD_DIM else "plain"
    if backend == "auto" and device_type == "cuda":
        if fits:
            return "fused"
        if mask == "none" and seq_len >= FLASH_MIN_SEQ_LEN and head_dim == FLASH_HEAD_DIM:
            return "flash"
    return "plain"


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in its input's
    dtype. The bias is added after the product is rounded to that dtype,
    as flax's ``Dense`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def make_linear_cls(quant_int8: bool, quant_mode: str = "dynamic"):
    """``Linear``, or its W8A8 drop-in for inference."""
    if not quant_int8:
        return Linear
    return functools.partial(Int8Linear, quant_mode=quant_mode)


def check_quant_args(quant_mode: str, quant_attn) -> None:
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got {quant_mode!r}")
    if not (quant_attn is False or quant_attn is True or quant_attn == "xla"):
        raise ValueError(f"quant_attn must be one of {QUANT_ATTN_MODES}, got {quant_attn!r}")


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in fp32, output cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


def sdpa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Plain attention on ``(B, H, L, dh)`` tensors: scores in fp32, the
    softmax cast to v's dtype before P.V (the JAX einsum path)."""
    scale = q.shape[-1] ** -0.5
    logits = ((q * scale) @ k.transpose(-1, -2)).float()
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return probs @ v


class MultiHeadAttention(nn.Module):
    """Joint-QKV multi-head attention in ``nn.MultiheadAttention``'s
    parameter layout (``in_proj_weight`` (3D, D), ``in_proj_bias``,
    ``out_proj``). ``kv_len`` < L masks keys at index >= kv_len.

    ``pre_ln=(weight, bias, eps)`` moves the preceding LayerNorm into the
    fused kernel together with the qkv projection (bf16 or fp32, or int8
    with ``quant_int8`` in static mode); then ``x`` is the block input, not
    its LN output. ``fused_attn`` hands the attention of an unfused
    projection to ``fused_qkv_attention``, ``flash`` to
    ``flash_attention``. ``causal`` says that ``mask`` is the causal mask:
    the flash path takes it as ``causal=True``, the plain path adds it.

    With ``quant_int8`` both projections run W8A8, and the in-projection's
    recorded ranges live here: ``in_proj_act_amax`` (its input) and
    ``qkv_amax`` (the q, k and v outputs, recorded on every calibration
    pass). A static block with ``quant_attn`` reads ``qkv_amax`` as the
    int8 attention's scales (raising while any is zero): ``True`` on the
    fused LN route, ``"xla"`` on the unfused projection of any unmasked
    attention outside a calibration pass, ahead of the kernel routes."""

    def __init__(self, dim: int, num_heads: int, quant_int8: bool = False,
                 quant_mode: str = "dynamic", quant_attn=False) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        check_quant_args(quant_mode, quant_attn)
        self.num_heads = num_heads
        self.quant_int8, self.quant_mode, self.quant_attn = quant_int8, quant_mode, quant_attn
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = make_linear_cls(quant_int8, quant_mode)(dim, dim)
        if quant_int8:
            self.calibrating = False
            self.register_buffer("in_proj_act_amax", torch.zeros(()), persistent=False)
            self.register_buffer("qkv_amax", torch.zeros(3), persistent=False)
            self._wq, self._scale, self._attn_scales = Cached(), Cached(), Cached()

    def _in_proj(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused qkv projection; a calibration pass records."""
        if not self.quant_int8:
            return F.linear(x, self.in_proj_weight.to(x.dtype)) + self.in_proj_bias.to(x.dtype)
        static = self.quant_mode == "static"
        recording = self.calibrating and not static
        if recording:
            record_amax(self.in_proj_act_amax, x)
        w_q, s_w = self._wq.get(self.in_proj_weight, quantize_weight)
        scale = self._scale.get(self.in_proj_act_amax, checked_act_scale) if static else None
        qkv = int8_linear(x, w_q, s_w, self.in_proj_bias, scale)
        if recording:
            record_amax(self.qkv_amax, qkv.reshape(-1, 3, x.shape[-1]), dims=(0, 2))
        return qkv

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None,
        pre_ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
        fused_attn: bool = False,
        flash: bool = False,
        causal: bool = False,
    ) -> torch.Tensor:
        b, l, d = x.shape
        dh = d // self.num_heads
        if pre_ln is not None:
            if mask is not None:
                raise ValueError("pre_ln (the fused path) takes no mask")
            g, bb, eps = pre_ln
            if self.quant_int8:
                if self.quant_mode != "static":
                    raise ValueError("the fused LN path of an int8 block needs quant_mode='static'")
                attn_scales = (self._attn_scales.get(self.qkv_amax, checked_attn_scales)
                               if self.quant_attn else None)
                out = fused_ln_qkv_attention_int8(
                    x, g, bb, self.in_proj_weight, self.in_proj_bias,
                    self._scale.get(self.in_proj_act_amax, checked_act_scale),
                    self.num_heads, kv_len or l, dh**-0.5, eps,
                    quantized=self._wq.get(self.in_proj_weight, quantize_weight),
                    attn_scales=attn_scales,
                )
            else:
                out = fused_ln_qkv_attention(
                    x, g, bb, self.in_proj_weight.to(x.dtype), self.in_proj_bias,
                    self.num_heads, kv_len or l, dh**-0.5, eps,
                )
            return self.out_proj(out)

        qkv = self._in_proj(x)
        if (self.quant_attn == "xla" and self.quant_int8 and self.quant_mode == "static"
                and mask is None and not self.calibrating):
            out = int8_qkv_attention(qkv, self.num_heads, kv_len or l, dh**-0.5,
                                     self._attn_scales.get(self.qkv_amax, checked_attn_scales))
            return self.out_proj(out)
        if fused_attn:
            if mask is not None:
                raise ValueError("fused_attn (the kernel path) takes no mask")
            out = fused_qkv_attention(qkv.contiguous(), self.num_heads, kv_len or l, dh**-0.5)
            return self.out_proj(out)
        q, k, v = qkv.split(d, dim=-1)

        def heads(t):
            return t.reshape(b, l, self.num_heads, dh).transpose(1, 2)

        if flash:
            if kv_len is not None and kv_len < l:
                raise ValueError("flash (the kernel path) takes no key-padding mask")
            # the kernel reads the head views through their strides, and its
            # (B, H, L, dh) output is a view of a (B, L, H, dh) tensor
            out = flash_attention(heads(q), heads(k), heads(v), dh**-0.5, causal)
            return self.out_proj(out.transpose(1, 2).reshape(b, l, d))
        attn_mask = mask
        if kv_len is not None and kv_len < l:
            keys = torch.arange(l, device=x.device)
            kmask = torch.where(keys < kv_len, 0.0, -float("inf"))[None, None, None, :]
            attn_mask = kmask if mask is None else mask + kmask
        out = sdpa_attention(heads(q), heads(k), heads(v), attn_mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + MHA(ln_1(x)); x + MLP(ln_2(x)).

    The path is :func:`attention_route`'s (:meth:`route`). On the fused
    kernel path (no mask, head dim 64, D <= MAX_FUSED_DIM, L <=
    MAX_FUSED_SEQ, or L <= MAX_FUSED_SEQ_INT8_ATTN for a static block whose
    attention is int8 on the fused LN route), ln_1 and the projection fold into
    the kernel (:meth:`fuse_ln`) unless ``fuse_ln_mode="off"``, a
    calibration pass is recording, the block is dynamic int8, which has
    no precalibrated scale the kernel could take, or ``quant_attn="xla"``,
    whose attention reads the projection's qkv; those keep ln_1 and the
    projection outside and hand the qkv to ``fused_qkv_attention`` (or, for
    ``"xla"``, to ``int8_qkv_attention``). The
    same checks as transformer.py:356-377 of the JAX package, made here, up
    front, so a kernel wrapper never has to fall back. bf16 and fp32
    activations both take the kernels; any other dtype makes the wrapper
    raise. ``act`` is the MLP's activation module (CLIP's QuickGELU by
    default; a plain ViT takes flax's default GELU,
    ``nn.GELU(approximate="tanh")``)."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
        ln_epsilon: float = 1e-5, attn_backend: str = "auto",
        quant_int8: bool = False, quant_mode: str = "dynamic", quant_attn=False,
        fuse_ln_mode: str = "auto", act: Optional[nn.Module] = None,
    ) -> None:
        super().__init__()
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}, got {attn_backend!r}")
        if fuse_ln_mode not in FUSE_LN_MODES:
            raise ValueError(f"fuse_ln_mode must be one of {FUSE_LN_MODES}, got {fuse_ln_mode!r}")
        self.attn_backend = attn_backend
        self.fuse_ln_mode = fuse_ln_mode
        self.quant_int8, self.quant_mode = quant_int8, quant_mode
        self.calibrating = False
        linear = make_linear_cls(quant_int8, quant_mode)
        self.ln_1 = LayerNormF32(dim, ln_epsilon)
        self.attn = MultiHeadAttention(dim, num_heads, quant_int8, quant_mode, quant_attn)
        self.ln_2 = LayerNormF32(dim, ln_epsilon)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=linear(dim, hidden), gelu=act if act is not None else QuickGELU(),
            c_proj=linear(hidden, dim),
        ))

    def route(self, x: torch.Tensor, mask: Optional[torch.Tensor], kv_len: Optional[int],
              causal: bool) -> str:
        _, l, d = x.shape
        heads = self.attn.num_heads
        if causal:
            kind = "causal"
        elif mask is not None:
            kind = "other"
        else:
            kind = "padding" if kv_len is not None and kv_len < l else "none"
        # a static calibrated block with quant_attn=True on the fused LN route
        # runs its attention in int8, which the kernel takes to 512 tokens
        # (JAX transformer.py:356-377)
        int8_attn = (self.quant_int8 and self.quant_mode == "static"
                     and self.attn.quant_attn is True and self.fuse_ln())
        return attention_route(self.attn_backend, x.device.type, l, kind, heads, d // heads,
                               int8_attn)

    def fuse_ln(self) -> bool:
        """Whether a block on the kernel path folds ln_1 and the projection
        into the kernel."""
        return (
            self.fuse_ln_mode != "off"
            and not self.calibrating
            and not (self.quant_int8 and self.quant_mode == "dynamic")
            and self.attn.quant_attn != "xla"
        )

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None, causal: bool = False,
    ) -> torch.Tensor:
        """``causal`` says that ``mask`` is the causal mask (the text
        tower); the flash path then takes ``causal=True`` instead of it."""
        route = self.route(x, mask, kv_len, causal)
        if route == "fused" and self.fuse_ln():
            x = x + self.attn(x, kv_len=kv_len, pre_ln=(self.ln_1.weight, self.ln_1.bias, self.ln_1.eps))
        else:
            x = x + self.attn(self.ln_1(x), mask, kv_len, fused_attn=route == "fused",
                              flash=route == "flash", causal=causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """``resblocks`` stack (torch CLIP's ``transformer.resblocks.{i}``);
    ``block_kw`` (the quantization and ``fuse_ln_mode``) goes to each block."""

    def __init__(self, width: int, layers: int, heads: int, attn_backend: str = "auto",
                 **block_kw) -> None:
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, attn_backend=attn_backend, **block_kw)
            for _ in range(layers)
        )


class PatchifyMatmul(nn.Module):
    """ViT patch embedding as reshape + one matmul. ``weight`` is a torch
    ``Conv2d`` weight ``(F, C, p, p)`` (state-dict key ``conv1.weight``);
    the patch is flattened in ``(py, px, c)`` order, as the JAX module
    flattens its ``(p, p, c, F)`` kernel. ``(B, H, W, C)`` pixels ->
    ``(B, gh*gw, F)`` in ``dtype``. ``bias`` adds a ``(F,)`` bias, as the
    JAX module's ``use_bias`` (CLIP's conv has none)."""

    def __init__(self, features: int, patch: int, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, bias: bool = False) -> None:
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, patch, patch))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        feats = self.weight.shape[0]
        x = (
            x.to(self.dtype)
            .reshape(b, gh, p, gw, p, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, gh * gw, p * p * c)
        )
        kernel = self.weight.permute(2, 3, 1, 0).reshape(p * p * c, feats)
        out = x @ kernel.to(self.dtype)
        return out if self.bias is None else out + self.bias.to(self.dtype)


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_hw: Tuple[int, int], new_hw: Tuple[int, int]
) -> torch.Tensor:
    """Resize the patch part of a ``(1 + H*W, D)`` positional embedding to
    a new grid (bicubic, torch semantics), keeping the CLS slot."""
    (h, w), (nh, nw) = grid_hw, new_hw
    if (h, w) == (nh, nw):
        return pos_embed
    cls_tok, patch = pos_embed[:1], pos_embed[1:]
    d = patch.shape[-1]
    patch = torch_bicubic_resize(patch.reshape(h, w, d), (nh, nw))
    return torch.cat([cls_tok, patch.reshape(nh * nw, d)], dim=0)
