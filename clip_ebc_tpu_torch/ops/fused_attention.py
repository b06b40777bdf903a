"""LayerNorm + joint QKV projection + masked attention, one call per ViT
block, and its backward: counterpart of ``clip_ebc_tpu/ops/fused_attention.py``
``fused_ln_qkv_attention`` (forward and ``_lqa_bwd``),
``fused_ln_qkv_attention_int8`` (W8A8, static scales; with ``attn_scales``
or ``quant_attn`` its attention runs in int8 too), ``fused_qkv_attention``
(the attention alone, from a precomputed qkv), ``_attention_bwd``,
``_ln_qkv_bwd_frozen`` and ``fused_ln_mlp_int8`` (the W8A8 MLP half of a
block).

On a CUDA tensor each wrapper launches the hand-written kernels in
``csrc/fused_attention.cu`` (forward: LN + projection, then attention),
``csrc/fused_attention_int8.cu`` (LN + quantize + int8 projection, the
int8 attention and its dynamic scale pass), ``csrc/fused_mlp_int8.cu``
(the W8A8 MLP) and ``csrc/fused_attention_bwd.cu`` (backward); on a CPU
tensor it runs the plain version beside it. It never falls back from one to the other:
whether the kernel applies (head dim 64, no mask, width, sequence length)
is decided up front by the model (models/transformer.py), and the wrapper
raises on anything else. bf16 activations take the tensor-core kernels,
fp32 activations their fp32 variants in the same sources.

:func:`fused_ln_qkv_attention` is differentiable. Its backward routes by
``ctx.needs_input_grad``, PyTorch's own record of which inputs train:
with the LN and projection parameters frozen (the VPT trunk) a bf16
block takes :func:`ln_qkv_bwd_frozen`, which returns dx only; any LN or
projection parameter that trains, and every fp32 block (as the JAX
package does on a chip, whose fused fp32 backward does not fit), takes
the split path: the autograd of the plain LN + projection around
:func:`attention_bwd`.

Weights come in torch ``nn.Linear`` layout: ``w`` is ``(3D, D)``, the
transpose of the JAX kernel's ``(D, 3D)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .int8_attention import int_bmm
from .quant import int_mm, quantize_weight

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64
# Longest sequence the float kernels take (csrc/fused_attention.cu
# kMaxKeys, csrc/fused_attention_bwd.cu kMaxL): the backward keeps a score
# row in registers; the forward attention bodies (csrc/attention_short.cuh)
# would take 512 keys.
MAX_FUSED_SEQ = 320
# Longest sequence of the int8 attention (``attn_scales`` or ``quant_attn``
# of fused_ln_qkv_attention_int8): past 256 keys it sweeps the keys twice in
# 128-key chunks (csrc/fused_attention_int8.cu, kI8MaxKeys); the JAX
# package's padded limit.
MAX_FUSED_SEQ_INT8_ATTN = 512
# Widest model the float forward kernels take (ViT-L): a warpgroup's 64
# LayerNormed rows stay resident, 384 columns in registers and the rest in
# shared memory beside the weight ring, whose stages hold one W box instead
# of two past D = 768 (csrc/fused_attention.cu, kMaxDim, ProjCfg); the fp32
# variant's LayerNorm statistics pass holds a row of up to this D in
# registers.
MAX_FUSED_DIM = 1024
# Widest model of the int8 kernels (csrc/int8_proj.cuh kQMaxDim: the
# quantized rows held in registers, past D = 768 partly in shared memory)
# and of the frozen backward's dx launch (csrc/fused_attention_bwd.cu
# kXMaxDim: a row tile's cluster of D / 128 blocks past D = 768): ViT-L.
MAX_INT8_DIM = 1024
MAX_BWD_DX_DIM = 1024


def supports(num_heads: int, head_dim: int, seq_len: int, max_seq: int = MAX_FUSED_SEQ) -> bool:
    """Shapes the kernel handles: 64-wide heads, D <= MAX_FUSED_DIM,
    L <= ``max_seq`` (MAX_FUSED_SEQ, or MAX_FUSED_SEQ_INT8_ATTN for the int8
    attention)."""
    return (
        head_dim == HEAD_DIM
        and 1 <= num_heads * head_dim <= MAX_FUSED_DIM
        and 1 <= seq_len <= max_seq
    )


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh)


def _layer_norm_parts(x: torch.Tensor, eps: float):
    """fp32 ``(xhat, rstd)`` of x over its last axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def ln_qkv_attention_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain version, rounding where the kernel rounds: fp32 LN; the
    LN output and W in x's dtype with fp32 accumulation; + fp32 bias, then
    qkv in x's dtype; fp32 scores x sm_scale with keys >= kv_len at
    NEG_INF; unnormalized probabilities in x's dtype; P.V in fp32 divided
    by the fp32 row sum; output in x's dtype. Products of values already
    rounded to x's dtype are taken in fp32, which is what a bf16 matrix
    unit with fp32 accumulation computes."""
    dt = x.dtype
    xhat, _ = _layer_norm_parts(x, eps)
    y = xhat * ln_weight.float() + ln_bias.float()
    qkv = (y.to(dt).float() @ w.to(dt).float().T + bias.float()).to(dt)
    return qkv_attention_plain(qkv, num_heads, kv_len, sm_scale)


def qkv_attention_plain(
    qkv: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float
) -> torch.Tensor:
    """The masked attention from a precomputed qkv ``(B, L, 3D)``, rounding
    where ``_pair_attention_body`` rounds: fp32 scores x sm_scale with keys
    >= kv_len at NEG_INF; unnormalized probabilities in qkv's dtype; P.V
    in fp32 divided by the fp32 row sum; output ``(B, L, D)`` in qkv's
    dtype."""
    dt = qkv.dtype
    l, d = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (_heads(t, num_heads) for t in qkv.float().split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) * sm_scale
    keys = torch.arange(l, device=qkv.device)
    s = s.masked_fill(keys >= kv_len, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(-1, keepdim=True)
    return _merge_heads(o.to(dt))


def ln_qkv_attention_int8_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w_q: torch.Tensor,
    s_col: torch.Tensor,
    bias: torch.Tensor,
    act_scale: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain W8A8 version, rounding where ``_ln_qkv_kernel`` rounds:
    fp32 LN, not rounded to x's dtype; ``yq = clip(round(y * (1 /
    act_scale)))`` (the reciprocal, as the kernel multiplies); an exact
    int8 x int8 -> int32 product; ``acc * (s_col * act_scale) + bias`` in
    fp32, qkv rounded to x's dtype; then :func:`qkv_attention_plain`."""
    qkv = ln_proj_int8_plain(x, ln_weight, ln_bias, w_q, s_col * act_scale, bias, act_scale,
                             "float", eps=eps)
    return qkv_attention_plain(qkv, num_heads, kv_len, sm_scale)


def _int8_ln_project(x, ln_weight, ln_bias, w_q, act_scale, eps) -> torch.Tensor:
    """fp32 LN of x; ``yq = clip(round(y * (1 / act_scale)))``; the exact
    int32 product with ``w_q`` (N, D), as fp32 ``(B, L, N)``."""
    b, l, d = x.shape
    xhat, _ = _layer_norm_parts(x, eps)
    y = xhat * ln_weight.float() + ln_bias.float()
    yq = torch.clamp(torch.round(y * (1.0 / act_scale)), -127, 127).to(torch.int8)
    return int_mm(yq.reshape(b * l, d), w_q).reshape(b, l, -1).float()


def ln_proj_int8_plain(x, ln_weight, ln_bias, w_q, sw, bias, act_scale, epilogue: str,
                       act_out=None, quick_gelu: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """The plain LN + int8 projection of ``x`` (B, L, D) with one of its
    epilogues, rounding where the int8 branches of ``_ln_qkv_kernel`` and
    ``_ln_mlp_kernel`` round: the exact int32 accumulators of
    :func:`_int8_ln_project`, ``v = acc * sw + bias`` in fp32 (multiply and
    add apart), then ``"float"``: v in x's dtype; ``"int8"``:
    ``clip(round(v))``; ``"gelu_int8"``: ``clip(round(gelu(v) * (1 /
    act_out)))`` (:func:`_gelu`). Returns (B, L, N)."""
    if epilogue not in ("float", "int8", "gelu_int8"):
        raise ValueError(f"epilogue must be float, int8 or gelu_int8, got {epilogue!r}")
    v = _int8_ln_project(x, ln_weight, ln_bias, w_q, act_scale, eps) * sw + bias.float()
    if epilogue == "float":
        return v.to(x.dtype)
    if epilogue == "gelu_int8":
        v = _gelu(v, quick_gelu) * (1.0 / act_out)
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def fold_attn_scales(s_col, bias, act_scale, attn_scales, d: int) -> tuple:
    """``(sw, bias)`` of the projection that writes q, k and v already in
    the int8 domain (JAX ``fused_ln_qkv_attention_int8`` :919-930):
    ``sw = s_col * act_scale``, then ``sw * repeat(1 / aq, D)`` and
    ``bias * repeat(1 / aq, D)``."""
    inv_lane = (1.0 / attn_scales).repeat_interleave(d)
    return s_col * act_scale * inv_lane, bias.float() * inv_lane


def int8_attention_static_plain(
    qkv_q: torch.Tensor, attn_scales: torch.Tensor, num_heads: int, kv_len: int,
    sm_scale: float, out_dtype: torch.dtype,
) -> torch.Tensor:
    """The masked attention of an int8 qkv ``(B, L, 3D)`` with calibrated
    per-tensor scales ``aq = (s_q, s_k, s_v)``, rounding where
    ``_pair_attention_body_static`` rounds: scores ``int32 * (aq0 aq1
    sm_scale)`` with keys >= kv_len at NEG_INF; unnormalized ``p = exp(s -
    m)``, ``r = sum(p)`` in fp32, ``p8 = round(p * 127)``; the output
    ``(PV_int32 / r) * (aq2 * (1 / 127))`` in ``out_dtype``."""
    l, d = qkv_q.shape[1], qkv_q.shape[2] // 3
    q, k, v = (_heads(t, num_heads) for t in qkv_q.split(d, dim=-1))
    s = int_bmm(q, k.transpose(-1, -2)).float() * (attn_scales[0] * attn_scales[1] * sm_scale)
    s = s.masked_fill(torch.arange(l, device=qkv_q.device) >= kv_len, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    r = p.sum(-1, keepdim=True)
    p8 = torch.round(p * 127.0).to(torch.int8)
    o = (int_bmm(p8, v).float() / r) * (attn_scales[2] * (1.0 / 127.0))
    return _merge_heads(o.to(out_dtype))


def ln_qkv_attention_int8_static_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w_q: torch.Tensor,
    s_col: torch.Tensor,
    bias: torch.Tensor,
    act_scale: torch.Tensor,
    attn_scales: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain version of the fully int8 block attention (``attn_scales``
    given), rounding where ``_ln_qkv_kernel`` with ``quant_attn="static"``
    rounds: the W8A8 projection's int32 accumulators, ``qkv_q =
    clip(round(acc * sw + bias))`` with the folded ``sw`` and ``bias`` of
    :func:`fold_attn_scales` (multiply and add apart), then
    :func:`int8_attention_static_plain`."""
    sw, bias_f = fold_attn_scales(s_col, bias, act_scale, attn_scales, x.shape[-1])
    qkv_q = ln_proj_int8_plain(x, ln_weight, ln_bias, w_q, sw, bias_f, act_scale, "int8", eps=eps)
    return int8_attention_static_plain(qkv_q, attn_scales, num_heads, kv_len, sm_scale, x.dtype)


def dynamic_attn_scales(qkv: torch.Tensor, num_heads: int, block_b: int) -> torch.Tensor:
    """The per-tile max-abs scales of the dynamic int8 attention
    (``_pair_attention_body`` with ``quant_attn=True``), ``(B, H, 3)`` fp32
    (s_q, s_k, s_v of each window and head): a tile is ``block_b``
    consecutive windows and all their rows; q and v take one scale per head,
    k one per head pair (the JAX kernel quantizes the pair's 128 lanes of k
    together). ``s = max(max|t|, 1e-8) / 127``."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    amax = qkv.float().abs().reshape(b, l, 3, num_heads, d // num_heads).amax((1, 4))
    tiles = -(-b // block_b)
    amax = torch.nn.functional.pad(amax, (0, 0, 0, 0, 0, tiles * block_b - b))
    amax = amax.reshape(tiles, block_b, 3, num_heads).amax(1).repeat_interleave(block_b, 0)[:b]
    amax[:, 1] = amax[:, 1].reshape(b, num_heads // 2, 2).amax(-1).repeat_interleave(2, -1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one ulp off the IEEE quotient the JAX q8 takes
    return (amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)).transpose(1, 2).contiguous()


def qkv_quant_dynamic_plain(qkv: torch.Tensor, num_heads: int, block_b: int) -> tuple:
    """The dynamic scale pass of ``quant_attn=True`` (the JAX ``q8`` of
    ``_pair_attention_body``): the scales of :func:`dynamic_attn_scales`
    ``(B, H, 3)``, and ``qkv_q = clip(round(t / s), -127, 127)`` (a
    division) of each head's q, k and v columns with its own scale, int8
    ``(B, L, 3D)``. Returns ``(qkv_q, scales)``."""
    b, l, d3 = qkv.shape
    sc = dynamic_attn_scales(qkv, num_heads, block_b)
    t = qkv.float().reshape(b, l, 3, num_heads, d3 // 3 // num_heads)
    q = torch.clamp(torch.round(t / sc.transpose(1, 2)[:, None, :, :, None]), -127, 127)
    return q.to(torch.int8).reshape(b, l, d3), sc


def int8_attention_dynamic_q_plain(
    qkv_q: torch.Tensor, scales: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The masked attention of an int8 qkv ``(B, L, 3D)`` on dynamic
    per-window scales ``(B, H, 3)`` (:func:`qkv_quant_dynamic_plain`),
    rounding where ``_pair_attention_body`` with ``quant_attn=True``
    rounds: scores ``(int32 * (s_q s_k)) * sm_scale``, keys >= kv_len at
    NEG_INF; unnormalized ``p``, ``r = sum(p)`` in fp32, ``p8 = round(p *
    127)``; the output ``(PV_int32 * (s_v / 127)) / r`` in ``out_dtype``."""
    l, d = qkv_q.shape[1], qkv_q.shape[2] // 3
    sc = scales[..., None, None]  # (B, H, 3, 1, 1)
    sq, sk, sv = sc[:, :, 0], sc[:, :, 1], sc[:, :, 2]
    q, k, v = (_heads(t, num_heads) for t in qkv_q.split(d, dim=-1))
    s = int_bmm(q, k.transpose(-1, -2)).float() * (sq * sk)
    s = torch.where(torch.arange(l, device=qkv_q.device) < kv_len, s * sm_scale, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    r = p.sum(-1, keepdim=True)
    p8 = torch.round(p * 127.0).to(torch.int8)
    o = int_bmm(p8, v).float() * (sv / 127.0) / r
    return _merge_heads(o.to(out_dtype))


def int8_attention_dynamic_plain(
    qkv: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float, block_b: int
) -> torch.Tensor:
    """The masked attention of ``qkv`` ``(B, L, 3D)`` with int8 QK^T and PV
    on dynamic per-tile scales: :func:`qkv_quant_dynamic_plain`, then
    :func:`int8_attention_dynamic_q_plain`, output in qkv's dtype."""
    qkv_q, scales = qkv_quant_dynamic_plain(qkv, num_heads, block_b)
    return int8_attention_dynamic_q_plain(qkv_q, scales, num_heads, kv_len, sm_scale, qkv.dtype)


def ln_qkv_attention_int8_dynamic_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w_q: torch.Tensor,
    s_col: torch.Tensor,
    bias: torch.Tensor,
    act_scale: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
    block_b: int = 2,
) -> torch.Tensor:
    """The plain version of ``quant_attn=True`` without ``attn_scales``:
    the W8A8 projection as :func:`ln_qkv_attention_int8_plain` (qkv in
    x's dtype), then :func:`int8_attention_dynamic_plain`."""
    qkv = ln_proj_int8_plain(x, ln_weight, ln_bias, w_q, s_col * act_scale, bias, act_scale,
                             "float", eps=eps)
    return int8_attention_dynamic_plain(qkv, num_heads, kv_len, sm_scale, block_b)


def _gelu(h: torch.Tensor, quick: bool) -> torch.Tensor:
    """QuickGELU ``h * sigmoid(1.702 h)`` or the tanh GELU with the
    constants of ``_ln_mlp_kernel``, in fp32."""
    if quick:
        return h * torch.sigmoid(1.702 * h)
    c = 0.7978845608028654  # sqrt(2 / pi)
    return 0.5 * h * (1.0 + torch.tanh(c * (h + 0.044715 * h * h * h)))


def ln_mlp_int8_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    wfc_q: torch.Tensor,
    s_fc: torch.Tensor,
    b_fc: torch.Tensor,
    act1: torch.Tensor,
    wpj_q: torch.Tensor,
    s_pj: torch.Tensor,
    b_proj: torch.Tensor,
    act2: torch.Tensor,
    quick_gelu: bool = True,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain W8A8 MLP half of a block, rounding where ``_ln_mlp_kernel``
    rounds: fp32 LN, ``yq = clip(round(y * (1 / act1)))``; ``h = acc *
    (s_fc act1) + b_fc`` in fp32; the GELU (:func:`_gelu`); ``hq =
    clip(round(h * (1 / act2)))``; ``out = acc2 * (s_pj act2) + b_proj``;
    ``(x_f32 + out)`` in x's dtype. ``wfc_q`` (4D, D) and ``wpj_q`` (D, 4D)
    int8 in torch's (out, in) layout, ``s_fc`` and ``s_pj`` their
    per-output-column scales."""
    hq = ln_proj_int8_plain(x, ln_weight, ln_bias, wfc_q, s_fc * act1, b_fc, act1, "gelu_int8",
                            act2, quick_gelu, eps)
    return int8_gemm_residual_plain(hq, wpj_q, s_pj * act2, b_proj, x)


def int8_gemm_residual_plain(
    hq: torch.Tensor, wpj_q: torch.Tensor, sw2: torch.Tensor, b_proj: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """The second product of the W8A8 MLP and its residual, rounding where
    ``_ln_mlp_kernel`` rounds: ``acc2 = hq . wpj_q^T`` in exact int32, ``out
    = acc2 * sw2 + b_proj`` in fp32 (multiply and add apart), ``(x_f32 +
    out)`` in x's dtype. ``hq (..., 4D)`` and ``wpj_q (D, 4D)`` int8, ``sw2
    = s_pj * act2`` and ``b_proj (D,)`` fp32, ``x (..., D)``."""
    d = x.shape[-1]
    acc2 = int_mm(hq.reshape(-1, hq.shape[-1]), wpj_q).reshape(x.shape[:-1] + (d,)).float()
    return (x.float() + (acc2 * sw2 + b_proj.float())).to(x.dtype)


def attention_bwd_plain(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float
) -> torch.Tensor:
    """d_qkv ``(B, L, 3D)`` of the masked attention from qkv ``(B, L, 3D)``
    and the output cotangent g ``(B, L, D)``, rounding where
    ``_pair_attention_bwd_body`` rounds: fp32 scores x sm_scale, keys >=
    kv_len at NEG_INF, P normalized in fp32 and then rounded to the
    activation dtype for dV; dS = P (dP - rowsum(dP P)) sm_scale rounded;
    dQ = dS K, dK = dS^T Q, dV = P^T g accumulated in fp32 and stored in
    the activation dtype. Masked keys get P = 0, hence zero dK and dV."""
    dt = qkv.dtype
    l, d = qkv.shape[1], g.shape[2]
    q, k, v = (_heads(t, num_heads).float() for t in qkv.split(d, dim=-1))
    gh = _heads(g, num_heads).float()
    s = (q @ k.transpose(-1, -2)) * sm_scale
    keys = torch.arange(l, device=qkv.device)
    s = s.masked_fill(keys >= kv_len, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = gh @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * sm_scale).to(dt).float()
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dv = p.to(dt).float().transpose(-1, -2) @ gh
    return torch.cat([_merge_heads(t.to(dt)) for t in (dq, dk, dv)], dim=-1)


def ln_qkv_bwd_frozen_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """dx of ``attention(qkv_proj(LN(x)))`` with the LN and projection
    frozen, rounding where ``_ln_qkv_bwd_frozen_kernel`` rounds: qkv
    recomputed as the forward does (x's dtype), d_qkv by
    :func:`attention_bwd_plain` (x's dtype), dy = d_qkv W in fp32, the
    LayerNorm backward in fp32, dx in x's dtype."""
    dt = x.dtype
    xhat, rstd = _layer_norm_parts(x, eps)
    gamma = ln_weight.float()
    y = xhat * gamma + ln_bias.float()
    wd = w.to(dt).float()
    qkv = (y.to(dt).float() @ wd.T + bias.float()).to(dt)
    d_qkv = attention_bwd_plain(qkv, g, num_heads, kv_len, sm_scale)
    return ln_bwd_dx_plain(x, d_qkv, ln_weight, w, eps)


def ln_bwd_dx_plain(
    x: torch.Tensor,
    d_qkv: torch.Tensor,
    ln_weight: torch.Tensor,
    w: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The tail of ``_ln_qkv_bwd_frozen_kernel``: dy = d_qkv W in fp32,
    then the LayerNorm backward for dx alone (LN parameters frozen) in
    fp32, dx in x's dtype. ``x (..., D)``, ``d_qkv (..., 3D)``, ``w (3D,
    D)`` in nn.Linear (out, in) layout."""
    dt = x.dtype
    xhat, rstd = _layer_norm_parts(x, eps)
    dyh = (d_qkv.float() @ w.to(dt).float()) * ln_weight.float()
    m1 = dyh.mean(-1, keepdim=True)
    m2 = (dyh * xhat).mean(-1, keepdim=True)
    return (rstd * (dyh - m1 - xhat * m2)).to(dt)


def ln_qkv_proj_plain(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The split backward's differentiable recompute of qkv, as the JAX
    package's ``ln_proj`` (``_lqa_bwd``): fp32 LN, the product in x's
    dtype, + fp32 bias, qkv in x's dtype."""
    dt = x.dtype
    xhat, _ = _layer_norm_parts(x, eps)
    y = xhat * ln_weight + ln_bias
    return ((y.to(dt) @ w.to(dt).T).float() + bias.float()).to(dt)


# C entries of each activation dtype (csrc/fused_attention.cu, csrc/fused_attention_bwd.cu).
_FWD_ENTRIES = {torch.bfloat16: "ebc_ln_qkv_attention", torch.float32: "ebc_ln_qkv_attention_f32"}
_BWD_ENTRIES = {torch.bfloat16: "ebc_attention_bwd", torch.float32: "ebc_attention_bwd_f32"}
_ATTN_ENTRIES = {torch.bfloat16: "ebc_qkv_attention", torch.float32: "ebc_qkv_attention_f32"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ebc_ln_qkv_attention": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "ebc_ln_qkv_attention_f32": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "ebc_ln_qkv_proj": [_P] * 6 + [_I, _I, _F, _P],
    "ebc_ln_qkv_proj_f32": [_P] * 6 + [_I, _I, _F, _P],
    "ebc_attention_bwd": [_P] * 4 + [_I] * 5 + [_F, _P],
    "ebc_attention_bwd_f32": [_P] * 4 + [_I] * 5 + [_F, _P],
    "ebc_ln_bwd_dx": [_P] * 5 + [_I, _I, _F, _P],
    "ebc_qkv_attention": [_P, _P] + [_I] * 5 + [_F, _P],
    "ebc_qkv_attention_f32": [_P, _P] + [_I] * 5 + [_F, _P],
    "ebc_ln_qkv_proj_int8": [_P] * 8 + [_I] * 3 + [_F, _P],
    "ebc_ln_qkv_proj_int8_q": [_P] * 8 + [_I] * 3 + [_F, _P],
    "ebc_qkv_quant_dynamic": [_P] * 3 + [_I] * 6 + [_P],
    "ebc_int8_attention": [_P] * 3 + [_I] * 7 + [_F, _P],
    "ebc_ln_mlp_int8": [_P] * 13 + [_I] * 5 + [_F, _P],
    "ebc_ln_proj_gelu_int8": [_P] * 9 + [_I] * 5 + [_F, _P],
    "ebc_int8_gemm_residual": [_P] * 6 + [_I] * 4 + [_P],
}


def _entry(source: str, name: str):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _run(who: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{who}: CUDA launch failed with error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(who: str, t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {dtype} {shape} "
            f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be 16-byte aligned")


def _check_attention(who: str, t: torch.Tensor, num_heads: int, kv_len: int,
                     max_seq: int = MAX_FUSED_SEQ, sm_scale: float = None) -> tuple:
    """Scale, device, dtype and shape checks shared by the wrappers: ``t`` is
    the ``(B, L, D)`` activation, L at most ``max_seq``; where the float
    attention runs, ``sm_scale`` > 0 (its wgmma body takes the row max of
    the raw scores). Returns ``(b, l, d)``."""
    if sm_scale is not None and not sm_scale > 0:
        raise ValueError(f"{who}: the attention kernels take sm_scale > 0, got {sm_scale}")
    if t.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {t.device}")
    if t.dim() != 3:
        raise ValueError(f"{who}: expected a (B, L, D) activation, got {tuple(t.shape)}")
    b, l, d = t.shape
    if d % num_heads or not supports(num_heads, d // num_heads, l, max_seq):
        raise ValueError(
            f"{who}: needs head dim {HEAD_DIM}, D <= {MAX_FUSED_DIM} and "
            f"1 <= L <= {max_seq}; got D={d}, heads={num_heads}, L={l}"
        )
    if not 1 <= kv_len <= l:
        raise ValueError(f"{who}: kv_len={kv_len} outside 1..{l}")
    if t.dtype not in _FWD_ENTRIES:
        raise ValueError(f"{who}: activations must be torch.bfloat16 or torch.float32, got {t.dtype}")
    return b, l, d


def _forward(x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps) -> torch.Tensor:
    if x.device.type == "cpu":
        return ln_qkv_attention_plain(
            x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
        )
    who = "fused_ln_qkv_attention"
    b, l, d = _check_attention(who, x, num_heads, kv_len, sm_scale=sm_scale)
    dev, dt = x.device, x.dtype
    _check(who, x, "x", (b, l, d), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(who, w, "w", (3 * d, d), dt, dev)
    _check(who, bias, "bias", (3 * d,), torch.float32, dev)
    launch = _entry("fused_attention", _FWD_ENTRIES[dt])
    qkv = torch.empty(b, l, 3 * d, dtype=dt, device=dev)
    out = torch.empty(b, l, d, dtype=dt, device=dev)
    _run(who, launch(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
        bias.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, l, d, num_heads,
        kv_len, float(sm_scale), float(eps), _stream(dev),
    ))
    fused_ln_qkv_attention.launches += 1
    if dt == torch.bfloat16:  # the bf16 entry's first launch is the LN + QKV projection kernel
        fused_ln_qkv_attention.launches_proj += 1
    return out


def _launch_attention_bwd(qkv, g, num_heads, kv_len, sm_scale) -> torch.Tensor:
    """The attention-backward launch on checked CUDA tensors (counted in
    ``attention_bwd.launches``)."""
    b, l, three_d = qkv.shape
    dqkv = torch.empty_like(qkv)
    # the fp32 kernel's row statistics pass between its two launches; the
    # bf16 kernel is one launch and takes none
    stats = (torch.empty(b, num_heads, 3, l, dtype=torch.float32, device=qkv.device)
             if qkv.dtype == torch.float32 else None)
    _run("attention_bwd", _entry("fused_attention_bwd", _BWD_ENTRIES[qkv.dtype])(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        stats.data_ptr() if stats is not None else None, b, l, three_d // 3, num_heads, kv_len,
        float(sm_scale), _stream(qkv.device),
    ))
    attention_bwd.launches += 1
    return dqkv


def attention_bwd(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float
) -> torch.Tensor:
    """d_qkv ``(B, L, 3D)`` of the masked attention (keys >= ``kv_len``
    masked) from qkv ``(B, L, 3D)`` and the output cotangent g ``(B, L,
    D)``, both bf16 or both fp32. CPU tensors take
    :func:`attention_bwd_plain`; CUDA tensors launch the kernel of that
    dtype (counted in ``attention_bwd.launches``) or raise."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, g, num_heads, kv_len, sm_scale)
    who = "attention_bwd"
    b, l, d = _check_attention(who, g, num_heads, kv_len)
    _check(who, g, "g", (b, l, d), g.dtype, qkv.device)
    _check(who, qkv, "qkv", (b, l, 3 * d), g.dtype, g.device)
    return _launch_attention_bwd(qkv, g, num_heads, kv_len, sm_scale)


def ln_qkv_bwd_frozen(
    x: torch.Tensor,
    g: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """dx ``(B, L, D)`` of ``attention(qkv_proj(LN(x)))`` with the LN and
    projection parameters frozen; g is the cotangent of the attention
    output. CPU tensors take :func:`ln_qkv_bwd_frozen_plain`. CUDA tensors
    need bf16 x, g and w, fp32 LN parameters and bias, D a multiple of 128
    and at most MAX_BWD_DX_DIM, and launch the LN + projection recompute, the attention backward and
    the dy = d_qkv W + LayerNorm-backward kernel (one call counted in
    ``ln_qkv_bwd_frozen.launches``, the recompute also in
    ``fused_ln_qkv_attention.launches_proj``, the last launch in
    ``ln_bwd_dx.launches``) or raise."""
    if x.device.type == "cpu":
        return ln_qkv_bwd_frozen_plain(
            x, g, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
        )
    who = "ln_qkv_bwd_frozen"
    b, l, d = _check_attention(who, x, num_heads, kv_len)
    dev, dt = x.device, torch.bfloat16
    if x.dtype != dt or d % 128 or d > MAX_BWD_DX_DIM:
        raise ValueError(
            f"{who}: needs bf16 activations, D % 128 == 0 and D <= {MAX_BWD_DX_DIM} (fp32 "
            f"takes the split path: attention_bwd); got {x.dtype}, D={d}"
        )
    _check(who, x, "x", (b, l, d), dt, dev)
    _check(who, g, "g", (b, l, d), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(who, w, "w", (3 * d, d), dt, dev)
    _check(who, bias, "bias", (3 * d,), torch.float32, dev)
    qkv = torch.empty(b, l, 3 * d, dtype=dt, device=dev)
    _run(who, _entry("fused_attention", "ebc_ln_qkv_proj")(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
        bias.data_ptr(), qkv.data_ptr(), b * l, d, float(eps), _stream(dev),
    ))
    fused_ln_qkv_attention.launches_proj += 1
    dqkv = _launch_attention_bwd(qkv, g, num_heads, kv_len, sm_scale)
    dx = ln_bwd_dx(x, dqkv, ln_weight, w, eps)
    ln_qkv_bwd_frozen.launches += 1
    return dx


def ln_bwd_dx(
    x: torch.Tensor,
    d_qkv: torch.Tensor,
    ln_weight: torch.Tensor,
    w: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """dx ``(..., D)`` of the frozen LayerNorm + QKV projection from d_qkv
    ``(..., 3D)``: the third launch of :func:`ln_qkv_bwd_frozen`. CPU
    tensors take :func:`ln_bwd_dx_plain`. CUDA tensors need bf16 x, d_qkv
    and w ``(3D, D)``, fp32 ln_weight, ``128 <= D <= MAX_BWD_DX_DIM`` a
    multiple of 128, and launch ``ebc_ln_bwd_dx`` (counted in ``ln_bwd_dx.launches``)
    or raise."""
    if x.device.type == "cpu":
        return ln_bwd_dx_plain(x, d_qkv, ln_weight, w, eps)
    who = "ln_bwd_dx"
    d = x.shape[-1]
    m = x.numel() // d if d else 0
    if d % 128 or not 128 <= d <= MAX_BWD_DX_DIM or m < 1:
        raise ValueError(f"{who}: needs 128 <= D <= {MAX_BWD_DX_DIM}, D % 128 == 0 and at least "
                         f"one row; got x {tuple(x.shape)}")
    dev, dt = x.device, torch.bfloat16
    _check(who, x, "x", tuple(x.shape), dt, dev)
    _check(who, d_qkv, "d_qkv", tuple(x.shape[:-1]) + (3 * d,), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, w, "w", (3 * d, d), dt, dev)
    dx = torch.empty_like(x)
    _run(who, _entry("fused_attention_bwd", "ebc_ln_bwd_dx")(
        x.data_ptr(), d_qkv.data_ptr(), ln_weight.data_ptr(), w.data_ptr(), dx.data_ptr(),
        m, d, float(eps), _stream(dev),
    ))
    ln_bwd_dx.launches += 1
    return dx


def _launch_qkv_attention(who: str, qkv: torch.Tensor, num_heads: int, kv_len: int,
                          sm_scale: float) -> torch.Tensor:
    """The attention launch on a checked CUDA qkv ``(B, L, 3D)`` (not
    counted here: each public wrapper counts its own call)."""
    b, l, three_d = qkv.shape
    out = torch.empty(b, l, three_d // 3, dtype=qkv.dtype, device=qkv.device)
    _run(who, _entry("fused_attention", _ATTN_ENTRIES[qkv.dtype])(
        qkv.data_ptr(), out.data_ptr(), b, l, three_d // 3, num_heads, kv_len,
        float(sm_scale), _stream(qkv.device),
    ))
    return out


class _FusedQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, kv_len, sm_scale):
        ctx.save_for_backward(qkv)
        ctx.cfg = (num_heads, kv_len, sm_scale)
        if qkv.device.type == "cpu":
            return qkv_attention_plain(qkv, num_heads, kv_len, sm_scale)
        who = "fused_qkv_attention"
        if qkv.dim() != 3 or qkv.shape[-1] % 3:
            raise ValueError(f"{who}: expected a (B, L, 3D) qkv, got {tuple(qkv.shape)}")
        b, l, d = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
        _check_attention(who, qkv[..., :d], num_heads, kv_len, sm_scale=sm_scale)
        _check(who, qkv, "qkv", (b, l, 3 * d), qkv.dtype, qkv.device)
        out = _launch_qkv_attention(who, qkv, num_heads, kv_len, sm_scale)
        fused_qkv_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return attention_bwd(qkv, g.contiguous(), *ctx.cfg), None, None, None


def fused_qkv_attention(
    qkv: torch.Tensor, num_heads: int, kv_len: int, sm_scale: float
) -> torch.Tensor:
    """``(B, L, 3D)`` joint qkv -> ``(B, L, D)`` head-concatenated masked
    attention output. Keys at index >= ``kv_len`` are masked; outputs of
    rows >= ``kv_len`` are not specified.

    CPU tensors take :func:`qkv_attention_plain`. CUDA tensors need a
    contiguous bf16 or fp32 qkv and launch the attention kernel of that
    dtype (counted in ``fused_qkv_attention.launches``) or raise.
    Differentiable: the backward is :func:`attention_bwd`."""
    return _FusedQkvAttention.apply(qkv, num_heads, kv_len, sm_scale)


def fused_ln_qkv_attention_int8(
    x: torch.Tensor,  # (B, L, D)
    ln_weight: torch.Tensor,  # (D,)
    ln_bias: torch.Tensor,  # (D,)
    w: torch.Tensor,  # (3D, D) fp32 master weight, nn.Linear layout
    bias: torch.Tensor,  # (3D,)
    act_scale: torch.Tensor,  # scalar: calibrated per-tensor scale of the LN output
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
    quantized: tuple = None,
    quant_attn: bool = False,
    attn_scales: torch.Tensor = None,
    block_b: int = 2,
) -> torch.Tensor:
    """W8A8 variant of :func:`fused_ln_qkv_attention` (inference only, not
    differentiable): LayerNorm in fp32, the LN output quantized with the
    calibrated per-tensor ``act_scale``, an int8 x int8 -> int32 projection
    against ``w`` quantized per output column, then the masked attention.
    ``quantized`` hands in ``ops.quant.quantize_weight(w)`` made earlier (a
    module keeps it per weight set); without it ``w`` is quantized here.

    The attention, as in the JAX function of the same signature:

    * ``attn_scales`` (3,): the calibrated per-tensor scales of q, k and v
      (max-abs / 127). The projection writes q, k and v as int8 (the scales
      folded into its dequantize multiply and bias) and QK^T and PV run in
      int8 (the JAX ``quant_attn="static"``).
    * else ``quant_attn``: qkv is dequantized to x's dtype, then quantized
      again with dynamic max-abs scales per tile of ``block_b`` windows (1
      for fp32 activations, as in the JAX package) and head (head pair for
      k), and QK^T and PV run in int8.
    * else the attention runs in x's dtype.

    CPU tensors take the plain version of the branch
    (:func:`ln_qkv_attention_int8_static_plain`,
    :func:`ln_qkv_attention_int8_dynamic_plain`,
    :func:`ln_qkv_attention_int8_plain`). CUDA tensors need bf16 or fp32 x,
    fp32 LN parameters, bias and scales, D a multiple of 128, L at most
    MAX_FUSED_SEQ_INT8_ATTN with an int8 attention (MAX_FUSED_SEQ with the
    float one), and launch
    the branch's kernels, one call counted in
    ``fused_ln_qkv_attention_int8.launches_static``, ``.launches_dynamic``
    or ``.launches`` (the float attention), its LN + int8 projection
    launch in ``.launches_proj``, an int8 attention launch in
    ``.launches_attn`` and the dynamic scale pass in
    ``qkv_quant_dynamic.launches``, or raise."""
    who = "fused_ln_qkv_attention_int8"
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, ln_weight, ln_bias, w, bias)
    ):
        raise RuntimeError(f"{who} has no backward: run it under torch.no_grad()")
    if block_b < 1:
        raise ValueError(f"{who}: block_b must be >= 1, got {block_b}")
    if x.dtype == torch.float32:
        block_b = 1
    w_q, s_col = quantized if quantized is not None else quantize_weight(w)
    act_scale = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(())
    if attn_scales is not None:
        attn_scales = torch.as_tensor(attn_scales, dtype=torch.float32, device=x.device).reshape(3).contiguous()
    if x.device.type == "cpu":
        if attn_scales is not None:
            return ln_qkv_attention_int8_static_plain(
                x, ln_weight, ln_bias, w_q, s_col, bias, act_scale, attn_scales, num_heads,
                kv_len, sm_scale, eps)
        if quant_attn:
            return ln_qkv_attention_int8_dynamic_plain(
                x, ln_weight, ln_bias, w_q, s_col, bias, act_scale, num_heads, kv_len, sm_scale,
                eps, block_b)
        return ln_qkv_attention_int8_plain(
            x, ln_weight, ln_bias, w_q, s_col, bias, act_scale, num_heads, kv_len, sm_scale, eps
        )
    int8_attn = attn_scales is not None or quant_attn
    b, l, d = _check_attention(who, x, num_heads, kv_len,
                               MAX_FUSED_SEQ_INT8_ATTN if int8_attn else MAX_FUSED_SEQ,
                               None if int8_attn else sm_scale)
    if d % 128 or d > MAX_INT8_DIM:
        raise ValueError(f"{who}: needs D % 128 == 0 and D <= {MAX_INT8_DIM}, got D={d}")
    dev, dt = x.device, x.dtype
    _check(who, x, "x", (b, l, d), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(who, w_q, "w_q", (3 * d, d), torch.int8, dev)
    _check(who, s_col, "s_col", (3 * d,), torch.float32, dev)
    _check(who, bias, "bias", (3 * d,), torch.float32, dev)
    inv_act = (1.0 / act_scale).reshape(1)
    is_f32 = int(dt == torch.float32)
    out = torch.empty(b, l, d, dtype=dt, device=dev)
    if attn_scales is not None:
        sw, bias_f = fold_attn_scales(s_col, bias, act_scale, attn_scales, d)
        qkv_q = torch.empty(b, l, 3 * d, dtype=torch.int8, device=dev)
        _run(who, _entry("fused_attention_int8", "ebc_ln_qkv_proj_int8_q")(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
            bias_f.data_ptr(), inv_act.data_ptr(), qkv_q.data_ptr(), b * l, d, is_f32,
            float(eps), _stream(dev),
        ))
        fused_ln_qkv_attention_int8.launches_proj += 1
        _launch_int8_attention(who, qkv_q, attn_scales, out, num_heads, kv_len, sm_scale, False)
        fused_ln_qkv_attention_int8.launches_static += 1
        return out
    sw = s_col * act_scale  # (3D,) dequant of the int32 accumulator
    qkv = torch.empty(b, l, 3 * d, dtype=dt, device=dev)
    _run(who, _entry("fused_attention_int8", "ebc_ln_qkv_proj_int8")(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
        bias.data_ptr(), inv_act.data_ptr(), qkv.data_ptr(), b * l, d, is_f32,
        float(eps), _stream(dev),
    ))
    fused_ln_qkv_attention_int8.launches_proj += 1
    if quant_attn:
        qkv_q, scales = _launch_qkv_quant_dynamic(who, qkv, num_heads, block_b)
        _launch_int8_attention(who, qkv_q, scales, out, num_heads, kv_len, sm_scale, True)
        fused_ln_qkv_attention_int8.launches_dynamic += 1
        return out
    out = _launch_qkv_attention(who, qkv, num_heads, kv_len, sm_scale)
    fused_ln_qkv_attention_int8.launches += 1
    return out


def _launch_int8_attention(who, qkv_q, scales, out, num_heads, kv_len, sm_scale, dynamic) -> None:
    """The int8 attention launch (counted in
    ``fused_ln_qkv_attention_int8.launches_attn``): ``scales`` is (3,)
    (static) or (B, H, 3) (dynamic); ``out`` (B, L, D) in the activation
    dtype."""
    b, l, d = out.shape
    _run(who, _entry("fused_attention_int8", "ebc_int8_attention")(
        qkv_q.data_ptr(), scales.data_ptr(), out.data_ptr(), b, l, d, num_heads, kv_len,
        int(dynamic), int(out.dtype == torch.float32), float(sm_scale), _stream(out.device),
    ))
    fused_ln_qkv_attention_int8.launches_attn += 1


def _launch_qkv_quant_dynamic(who, qkv, num_heads, block_b) -> tuple:
    """The scale pass on a checked CUDA qkv ``(B, L, 3D)`` (counted in
    ``qkv_quant_dynamic.launches``): ``(qkv_q, scales)``."""
    b, l, three_d = qkv.shape
    qkv_q = torch.empty(b, l, three_d, dtype=torch.int8, device=qkv.device)
    scales = torch.empty(b, num_heads, 3, dtype=torch.float32, device=qkv.device)
    _run(who, _entry("fused_attention_int8", "ebc_qkv_quant_dynamic")(
        qkv.data_ptr(), qkv_q.data_ptr(), scales.data_ptr(), b, l, three_d // 3, num_heads, block_b,
        int(qkv.dtype == torch.float32), _stream(qkv.device),
    ))
    qkv_quant_dynamic.launches += 1
    return qkv_q, scales


def qkv_quant_dynamic(qkv: torch.Tensor, num_heads: int, block_b: int) -> tuple:
    """The dynamic scale pass of ``fused_ln_qkv_attention_int8(quant_attn=True)``
    alone: ``(qkv_q, scales)`` of a qkv ``(B, L, 3D)``, as
    :func:`qkv_quant_dynamic_plain`. CPU tensors take that plain version.
    CUDA tensors need a contiguous bf16 or fp32 qkv, 64-wide heads in an
    even number, D a multiple of 128 and at most MAX_INT8_DIM, L at most
    MAX_FUSED_SEQ_INT8_ATTN, and launch ``ebc_qkv_quant_dynamic`` (counted
    in ``qkv_quant_dynamic.launches``, as is the launch inside
    ``fused_ln_qkv_attention_int8``) or raise."""
    if qkv.device.type == "cpu":
        return qkv_quant_dynamic_plain(qkv, num_heads, block_b)
    who = "qkv_quant_dynamic"
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{who}: expected a (B, L, 3D) qkv, got {tuple(qkv.shape)}")
    if block_b < 1:
        raise ValueError(f"{who}: block_b must be >= 1, got {block_b}")
    b, l, d = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    _check_attention(who, qkv[..., :d], num_heads, l, MAX_FUSED_SEQ_INT8_ATTN)
    if d % 128 or d > MAX_INT8_DIM:
        raise ValueError(f"{who}: needs D % 128 == 0 (head pairs) and D <= {MAX_INT8_DIM}, "
                         f"got D={d}")
    _check(who, qkv, "qkv", (b, l, 3 * d), qkv.dtype, qkv.device)
    return _launch_qkv_quant_dynamic(who, qkv, num_heads, block_b)


def _check_mlp_widths(who: str, d: int, hidden: int) -> None:
    if d % 128 or d > MAX_INT8_DIM or hidden % 128 or hidden < 128:
        raise ValueError(f"{who}: needs D % 128 == 0, D <= {MAX_INT8_DIM} and a hidden width "
                         f"that is a multiple of 128; got D={d}, hidden={hidden}")


def int8_gemm_residual(
    hq: torch.Tensor, wpj_q: torch.Tensor, sw2: torch.Tensor, b_proj: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """The second launch of :func:`fused_ln_mlp_int8` alone: ``x + (hq .
    wpj_q^T * sw2 + b_proj)`` as :func:`int8_gemm_residual_plain`. CPU
    tensors take that plain version. CUDA tensors need contiguous int8
    ``hq (..., 4D)`` and ``wpj_q (D, 4D)``, fp32 ``sw2`` and ``b_proj``
    ``(D,)``, a bf16 or fp32 ``x (..., D)``, D a multiple of 128 and at most
    MAX_INT8_DIM, 4D a multiple of 128, and launch ``ebc_int8_gemm_residual``
    (counted in ``int8_gemm_residual.launches``, as is the second launch
    of ``fused_ln_mlp_int8``) or raise."""
    if x.device.type == "cpu":
        return int8_gemm_residual_plain(hq, wpj_q, sw2, b_proj, x)
    who = "int8_gemm_residual"
    d, hidden = x.shape[-1], hq.shape[-1]
    m = x.numel() // d if d else 0
    _check_mlp_widths(who, d, hidden)
    if m < 1 or x.dtype not in _FWD_ENTRIES:
        raise ValueError(f"{who}: needs at least one bf16 or fp32 row, got x {tuple(x.shape)} {x.dtype}")
    dev = x.device
    _check(who, x, "x", tuple(x.shape), x.dtype, dev)
    _check(who, hq, "hq", tuple(x.shape[:-1]) + (hidden,), torch.int8, dev)
    _check(who, wpj_q, "wpj_q", (d, hidden), torch.int8, dev)
    _check(who, sw2, "sw2", (d,), torch.float32, dev)
    _check(who, b_proj, "b_proj", (d,), torch.float32, dev)
    out = torch.empty_like(x)
    _run(who, _entry("fused_mlp_int8", "ebc_int8_gemm_residual")(
        hq.data_ptr(), wpj_q.data_ptr(), sw2.data_ptr(), b_proj.data_ptr(), x.data_ptr(),
        out.data_ptr(), m, d, hidden, int(x.dtype == torch.float32), _stream(dev),
    ))
    int8_gemm_residual.launches += 1
    return out


def fused_ln_mlp_int8(
    x: torch.Tensor,  # (B, L, D)
    ln_weight: torch.Tensor,  # (D,)
    ln_bias: torch.Tensor,  # (D,)
    w_fc: torch.Tensor,  # (4D, D) fp32 master weight, nn.Linear layout
    b_fc: torch.Tensor,  # (4D,)
    act1: torch.Tensor,  # scalar: calibrated scale of the LN output
    w_proj: torch.Tensor,  # (D, 4D) fp32 master weight
    b_proj: torch.Tensor,  # (D,)
    act2: torch.Tensor,  # scalar: calibrated scale of the GELU output
    quick_gelu: bool = True,
    eps: float = 1e-5,
    quantized: tuple = None,
) -> torch.Tensor:
    """``x + proj(gelu(fc(LN(x))))`` with both products W8A8 (inference
    only): counterpart of the JAX ``fused_ln_mlp_int8``. ``w_fc`` and
    ``w_proj`` are the fp32 master weights, quantized per output column
    here unless ``quantized = (*quantize_weight(w_fc),
    *quantize_weight(w_proj))`` hands them in; ``act1`` and ``act2`` the
    calibrated per-tensor scales of the LN output and of the GELU output;
    ``quick_gelu`` picks QuickGELU (CLIP) over the tanh GELU. Rows are
    independent (no padding enters a real row).

    CPU tensors take :func:`ln_mlp_int8_plain`. CUDA tensors need bf16 or
    fp32 x, fp32 LN parameters, biases and scales, D a multiple of 128 and
    at most MAX_INT8_DIM, the hidden width a multiple of 128, and launch
    ``csrc/fused_mlp_int8.cu`` (one call counted in
    ``fused_ln_mlp_int8.launches``, its second launch also in
    ``int8_gemm_residual.launches``) or raise."""
    who = "fused_ln_mlp_int8"
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, ln_weight, ln_bias, w_fc, b_fc, w_proj, b_proj)
    ):
        raise RuntimeError(f"{who} has no backward: run it under torch.no_grad()")
    wfc_q, s_fc, wpj_q, s_pj = (quantized if quantized is not None
                                else (*quantize_weight(w_fc), *quantize_weight(w_proj)))
    act1, act2 = (torch.as_tensor(a, dtype=torch.float32, device=x.device).reshape(())
                  for a in (act1, act2))
    if x.device.type == "cpu":
        return ln_mlp_int8_plain(x, ln_weight, ln_bias, wfc_q, s_fc, b_fc, act1, wpj_q, s_pj,
                                 b_proj, act2, quick_gelu, eps)
    if x.device.type != "cuda" or x.dim() != 3:
        raise ValueError(f"{who}: expected a (B, L, D) CUDA or CPU activation, got "
                         f"{tuple(x.shape)} on {x.device}")
    b, l, d = x.shape
    hidden = wfc_q.shape[0]
    _check_mlp_widths(who, d, hidden)
    if x.dtype not in _FWD_ENTRIES:
        raise ValueError(f"{who}: activations must be torch.bfloat16 or torch.float32, got {x.dtype}")
    dev, dt = x.device, x.dtype
    _check(who, x, "x", (b, l, d), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(who, wfc_q, "wfc_q", (hidden, d), torch.int8, dev)
    _check(who, s_fc, "s_fc", (hidden,), torch.float32, dev)
    _check(who, b_fc, "b_fc", (hidden,), torch.float32, dev)
    _check(who, wpj_q, "wpj_q", (d, hidden), torch.int8, dev)
    _check(who, s_pj, "s_pj", (d,), torch.float32, dev)
    _check(who, b_proj, "b_proj", (d,), torch.float32, dev)
    sw1, sw2 = s_fc * act1, s_pj * act2
    inv = torch.stack([1.0 / act1, 1.0 / act2])
    hq = torch.empty(b * l, hidden, dtype=torch.int8, device=dev)
    out = torch.empty_like(x)
    _run(who, _entry("fused_mlp_int8", "ebc_ln_mlp_int8")(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wfc_q.data_ptr(), sw1.data_ptr(),
        b_fc.data_ptr(), inv[0:1].data_ptr(), inv[1:2].data_ptr(), hq.data_ptr(), wpj_q.data_ptr(),
        sw2.data_ptr(), b_proj.data_ptr(), out.data_ptr(), b * l, d, hidden, int(quick_gelu),
        int(dt == torch.float32), float(eps), _stream(dev),
    ))
    fused_ln_mlp_int8.launches += 1
    int8_gemm_residual.launches += 1  # the entry's second launch
    return out


class _FusedLnQkvAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps):
        ctx.save_for_backward(x, ln_weight, ln_bias, w, bias)
        ctx.cfg = (num_heads, kv_len, sm_scale, eps)
        return _forward(x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_weight, ln_bias, w, bias = ctx.saved_tensors
        num_heads, kv_len, sm_scale, eps = ctx.cfg
        needs = ctx.needs_input_grad[:5]
        g = g.contiguous()
        none4 = (None,) * 4
        if not any(needs[1:]) and x.dtype == torch.bfloat16:
            dx = ln_qkv_bwd_frozen(
                x, g, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
            )
            return (dx,) + (None,) * 4 + none4
        # split path: the plain LN + projection's autograd around the
        # attention-backward kernel (fp32, or parameters that train)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in
                      zip((x, ln_weight, ln_bias, w, bias), needs)]
            qkv = ln_qkv_proj_plain(*inputs, eps)
        d_qkv = attention_bwd(qkv.detach(), g, num_heads, kv_len, sm_scale)
        grads = iter(torch.autograd.grad(qkv, [t for t, n in zip(inputs, needs) if n], d_qkv))
        return tuple(next(grads) if n else None for n in needs) + none4


def fused_ln_qkv_attention(
    x: torch.Tensor,  # (B, L, D)
    ln_weight: torch.Tensor,  # (D,)
    ln_bias: torch.Tensor,  # (D,)
    w: torch.Tensor,  # (3D, D), nn.Linear layout
    bias: torch.Tensor,  # (3D,)
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm -> joint qkv projection -> masked multi-head attention
    -> ``(B, L, D)`` head-concatenated output (before the out-projection).
    Keys at index >= ``kv_len`` are masked; outputs of rows >= ``kv_len``
    are not specified.

    CPU tensors take :func:`ln_qkv_attention_plain`. CUDA tensors need x
    and w both in bf16 or both in fp32 and LN params / bias in fp32, and
    launch the kernel of that dtype (counted in
    ``fused_ln_qkv_attention.launches``; the bf16 entry's LN + QKV
    projection launch also in ``.launches_proj``, as is the recompute of
    :func:`ln_qkv_bwd_frozen`) or raise. Differentiable: the
    backward is routed as the module docstring says."""
    return _FusedLnQkvAttention.apply(
        x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
    )


fused_ln_qkv_attention.launches = 0
fused_ln_qkv_attention.launches_proj = 0
fused_ln_qkv_attention_int8.launches = 0
fused_ln_qkv_attention_int8.launches_static = 0
fused_ln_qkv_attention_int8.launches_dynamic = 0
fused_ln_qkv_attention_int8.launches_proj = 0
fused_ln_qkv_attention_int8.launches_attn = 0
fused_ln_mlp_int8.launches = 0
int8_gemm_residual.launches = 0
qkv_quant_dynamic.launches = 0
fused_qkv_attention.launches = 0
attention_bwd.launches = 0
ln_qkv_bwd_frozen.launches = 0
ln_bwd_dx.launches = 0
