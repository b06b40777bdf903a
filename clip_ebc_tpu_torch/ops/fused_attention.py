"""LayerNorm + joint QKV projection + masked attention, one call per ViT
block: counterpart of ``clip_ebc_tpu/ops/fused_attention.py``
``fused_ln_qkv_attention`` (forward).

On a CUDA tensor the wrapper launches the hand-written kernels in
``csrc/fused_attention.cu`` (LN + projection, then attention); on a CPU
tensor it runs :func:`ln_qkv_attention_plain`. It never falls back from
one to the other: whether the kernel applies (head dim 64, no mask,
width, sequence length) is decided up front by the model
(models/transformer.py), and the wrapper raises on anything else. bf16
activations take the tensor-core kernels, fp32 activations their fp32
variant in the same source.

Weights come in torch ``nn.Linear`` layout: ``w`` is ``(3D, D)``, the
transpose of the JAX kernel's ``(D, 3D)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64
# Longest sequence the kernel takes: a warp keeps its 16 query rows'
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
    b, l, d = x.shape
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * ln_weight.float() + ln_bias.float()
    qkv = (y.to(dt).float() @ w.to(dt).float().T + bias.float()).to(dt).float()
    q, k, v = qkv.split(d, dim=-1)

    def heads(t):
        return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)

    s = (heads(q) @ heads(k).transpose(-1, -2)) * sm_scale
    keys = torch.arange(l, device=x.device)
    s = s.masked_fill(keys >= kv_len, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ heads(v)) / p.sum(-1, keepdim=True)
    return o.to(dt).transpose(1, 2).reshape(b, l, d)


# The C entry of each activation dtype (csrc/fused_attention.cu).
_ENTRIES = {torch.bfloat16: "ebc_ln_qkv_attention", torch.float32: "ebc_ln_qkv_attention_f32"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("fused_attention"), _ENTRIES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"fused_ln_qkv_attention: {name} must be a contiguous {dtype} {shape} "
            f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"fused_ln_qkv_attention: {name} must be 16-byte aligned")


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
    Keys at index >= ``kv_len`` are masked.

    CPU tensors take :func:`ln_qkv_attention_plain`. CUDA tensors need x
    and w both in bf16 or both in fp32 and LN params / bias in fp32, and
    launch the kernel of that dtype (counted in
    ``fused_ln_qkv_attention.launches``) or raise."""
    if x.device.type == "cpu":
        return ln_qkv_attention_plain(
            x, ln_weight, ln_bias, w, bias, num_heads, kv_len, sm_scale, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_qkv_attention: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_ln_qkv_attention: x must be (B, L, D), got {tuple(x.shape)}")
    b, l, d = x.shape
    if d % num_heads or not supports(num_heads, d // num_heads, l):
        raise ValueError(
            f"fused_ln_qkv_attention: needs head dim {HEAD_DIM}, D <= {MAX_FUSED_DIM} and "
            f"1 <= L <= {MAX_FUSED_SEQ}; got D={d}, heads={num_heads}, L={l}"
        )
    if not 1 <= kv_len <= l:
        raise ValueError(f"fused_ln_qkv_attention: kv_len={kv_len} outside 1..{l}")
    dev, dt = x.device, x.dtype
    if dt not in _ENTRIES:
        raise ValueError(
            f"fused_ln_qkv_attention: x must be torch.bfloat16 or torch.float32, got {dt}"
        )
    _check(x, "x", (b, l, d), dt, dev)
    _check(ln_weight, "ln_weight", (d,), torch.float32, dev)
    _check(ln_bias, "ln_bias", (d,), torch.float32, dev)
    _check(w, "w", (3 * d, d), dt, dev)
    _check(bias, "bias", (3 * d,), torch.float32, dev)
    launch = _entry(dt)
    qkv = torch.empty(b, l, 3 * d, dtype=dt, device=dev)
    out = torch.empty(b, l, d, dtype=dt, device=dev)
    rc = launch(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w.data_ptr(),
        bias.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, l, d, num_heads,
        kv_len, float(sm_scale), float(eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_ln_qkv_attention: CUDA launch failed with error {rc}")
    fused_ln_qkv_attention.launches += 1
    return out


fused_ln_qkv_attention.launches = 0
