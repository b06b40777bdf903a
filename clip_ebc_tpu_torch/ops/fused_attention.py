"""LayerNorm + joint QKV projection + masked attention, one call per ViT
block, and its backward: counterpart of ``clip_ebc_tpu/ops/fused_attention.py``
``fused_ln_qkv_attention`` (forward and ``_lqa_bwd``),
``fused_ln_qkv_attention_int8`` (W8A8, static scales), ``fused_qkv_attention``
(the attention alone, from a precomputed qkv), ``_attention_bwd`` and
``_ln_qkv_bwd_frozen``.

On a CUDA tensor each wrapper launches the hand-written kernels in
``csrc/fused_attention.cu`` (forward: LN + projection, then attention),
``csrc/fused_attention_int8.cu`` (LN + quantize + int8 projection) and
``csrc/fused_attention_bwd.cu`` (backward); on a CPU tensor it runs
the plain version beside it. It never falls back from one to the other:
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
from .quant import int_mm, quantize_weight

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64
# Longest sequence the kernels take: a warp keeps its 16 query rows'
# scores over every key in registers (csrc/fused_attention.cu, kMaxKeys).
MAX_FUSED_SEQ = 320
# Widest model the kernel takes: 64 LayerNormed rows of D bf16 values stay
# in shared memory beside the weight tiles (csrc/fused_attention.cu, kPM,
# kMaxDim, proj_smem_bytes); the fp32 variant's LayerNorm statistics pass
# holds a row in registers sized for the same D (kFLnVecs).
MAX_FUSED_DIM = 768


def supports(num_heads: int, head_dim: int, seq_len: int) -> bool:
    """Shapes the kernel handles: 64-wide heads, D <= MAX_FUSED_DIM,
    L <= MAX_FUSED_SEQ."""
    return (
        head_dim == HEAD_DIM
        and 1 <= num_heads * head_dim <= MAX_FUSED_DIM
        and 1 <= seq_len <= MAX_FUSED_SEQ
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
    b, l, d = x.shape
    xhat, _ = _layer_norm_parts(x, eps)
    y = xhat * ln_weight.float() + ln_bias.float()
    yq = torch.clamp(torch.round(y * (1.0 / act_scale)), -127, 127).to(torch.int8)
    acc = int_mm(yq.reshape(b * l, d), w_q).reshape(b, l, 3 * d).float()
    qkv = (acc * (s_col * act_scale) + bias.float()).to(x.dtype)
    return qkv_attention_plain(qkv, num_heads, kv_len, sm_scale)


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
    dyh = (d_qkv.float() @ wd) * gamma
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
    "ebc_attention_bwd": [_P] * 4 + [_I] * 5 + [_F, _P],
    "ebc_attention_bwd_f32": [_P] * 4 + [_I] * 5 + [_F, _P],
    "ebc_ln_bwd_dx": [_P] * 5 + [_I, _I, _F, _P],
    "ebc_qkv_attention": [_P, _P] + [_I] * 5 + [_F, _P],
    "ebc_qkv_attention_f32": [_P, _P] + [_I] * 5 + [_F, _P],
    "ebc_ln_qkv_proj_int8": [_P] * 8 + [_I] * 3 + [_F, _P],
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


def _check_attention(who: str, t: torch.Tensor, num_heads: int, kv_len: int) -> tuple:
    """Device, dtype and shape checks shared by the wrappers: ``t`` is the
    ``(B, L, D)`` activation; returns ``(b, l, d)``."""
    if t.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {t.device}")
    if t.dim() != 3:
        raise ValueError(f"{who}: expected a (B, L, D) activation, got {tuple(t.shape)}")
    b, l, d = t.shape
    if d % num_heads or not supports(num_heads, d // num_heads, l):
        raise ValueError(
            f"{who}: needs head dim {HEAD_DIM}, D <= {MAX_FUSED_DIM} and "
            f"1 <= L <= {MAX_FUSED_SEQ}; got D={d}, heads={num_heads}, L={l}"
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
    b, l, d = _check_attention(who, x, num_heads, kv_len)
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
    return out


def _launch_attention_bwd(qkv, g, num_heads, kv_len, sm_scale) -> torch.Tensor:
    """The attention-backward launch on checked CUDA tensors (counted in
    ``attention_bwd.launches``)."""
    b, l, three_d = qkv.shape
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(b, num_heads, 3, l, dtype=torch.float32, device=qkv.device)
    _run("attention_bwd", _entry("fused_attention_bwd", _BWD_ENTRIES[qkv.dtype])(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, l,
        three_d // 3, num_heads, kv_len, float(sm_scale), _stream(qkv.device),
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
    need bf16 x, g and w, fp32 LN parameters and bias, D a multiple of 128,
    and launch the LN + projection recompute, the attention backward and
    the dy = d_qkv W + LayerNorm-backward kernel (one call counted in
    ``ln_qkv_bwd_frozen.launches``) or raise."""
    if x.device.type == "cpu":
        return ln_qkv_bwd_frozen_plain(
            x, g, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
        )
    who = "ln_qkv_bwd_frozen"
    b, l, d = _check_attention(who, x, num_heads, kv_len)
    dev, dt = x.device, torch.bfloat16
    if x.dtype != dt or d % 128:
        raise ValueError(
            f"{who}: needs bf16 activations and D % 128 == 0 (fp32 takes the split "
            f"path: attention_bwd); got {x.dtype}, D={d}"
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
    dqkv = _launch_attention_bwd(qkv, g, num_heads, kv_len, sm_scale)
    dx = torch.empty_like(x)
    _run(who, _entry("fused_attention_bwd", "ebc_ln_bwd_dx")(
        x.data_ptr(), dqkv.data_ptr(), ln_weight.data_ptr(), w.data_ptr(), dx.data_ptr(),
        b * l, d, float(eps), _stream(dev),
    ))
    ln_qkv_bwd_frozen.launches += 1
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
        _check_attention(who, qkv[..., :d], num_heads, kv_len)
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
) -> torch.Tensor:
    """W8A8 variant of :func:`fused_ln_qkv_attention` (inference only, not
    differentiable): LayerNorm in fp32, the LN output quantized with the
    calibrated per-tensor ``act_scale``, an int8 x int8 -> int32 projection
    against ``w`` quantized per output column, dequantized to x's dtype,
    then the masked attention. ``quantized`` hands in
    ``ops.quant.quantize_weight(w)`` made earlier (a module keeps it
    per weight set); without it ``w`` is quantized here.

    CPU tensors take :func:`ln_qkv_attention_int8_plain`. CUDA tensors need
    bf16 or fp32 x, fp32 LN parameters, bias and scales, D a multiple of
    128, and launch the int8 projection kernel and the attention kernel of
    x's dtype (one call counted in ``fused_ln_qkv_attention_int8.launches``)
    or raise."""
    who = "fused_ln_qkv_attention_int8"
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, ln_weight, ln_bias, w, bias)
    ):
        raise RuntimeError(f"{who} has no backward: run it under torch.no_grad()")
    w_q, s_col = quantized if quantized is not None else quantize_weight(w)
    act_scale = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device).reshape(())
    if x.device.type == "cpu":
        return ln_qkv_attention_int8_plain(
            x, ln_weight, ln_bias, w_q, s_col, bias, act_scale, num_heads, kv_len, sm_scale, eps
        )
    b, l, d = _check_attention(who, x, num_heads, kv_len)
    if d % 128:
        raise ValueError(f"{who}: needs D % 128 == 0, got D={d}")
    dev, dt = x.device, x.dtype
    _check(who, x, "x", (b, l, d), dt, dev)
    _check(who, ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(who, ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(who, w_q, "w_q", (3 * d, d), torch.int8, dev)
    _check(who, s_col, "s_col", (3 * d,), torch.float32, dev)
    _check(who, bias, "bias", (3 * d,), torch.float32, dev)
    sw = s_col * act_scale  # (3D,) dequant of the int32 accumulator
    inv_act = (1.0 / act_scale).reshape(1)
    qkv = torch.empty(b, l, 3 * d, dtype=dt, device=dev)
    _run(who, _entry("fused_attention_int8", "ebc_ln_qkv_proj_int8")(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
        bias.data_ptr(), inv_act.data_ptr(), qkv.data_ptr(), b * l, d,
        int(dt == torch.float32), float(eps), _stream(dev),
    ))
    out = _launch_qkv_attention(who, qkv, num_heads, kv_len, sm_scale)
    fused_ln_qkv_attention_int8.launches += 1
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
    ``fused_ln_qkv_attention.launches``) or raise. Differentiable: the
    backward is routed as the module docstring says."""
    return _FusedLnQkvAttention.apply(
        x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
    )


fused_ln_qkv_attention.launches = 0
fused_ln_qkv_attention_int8.launches = 0
fused_qkv_attention.launches = 0
attention_bwd.launches = 0
ln_qkv_bwd_frozen.launches = 0
