"""Static-int8 attention as plain integer matrix products: counterpart of
``clip_ebc_tpu/ops/int8_attention.py`` ``xla_int8_qkv_attention``, the
attention of a block run with ``quant_attn="xla"``.

The JAX package hands QK^T and PV to XLA as integer einsums, outside any
Pallas kernel, so there is no kernel to port: this function is the path
on both devices. It rounds where the JAX function rounds: q, k and v are
quantized with the calibrated per-tensor scales (``x * (1 / scale)``,
half-to-even, clipped to +-127); the scores are ``int32 -> fp32 * (s_q
s_k sm_scale)`` with keys >= ``kv_len`` at ``-inf``; the softmax is
normalized before ``p8 = round(p * 127)``; the output is ``int32 -> fp32
* (s_v / 127)`` in qkv's dtype.

The integer products must be exact. An fp32 product of int8 values is:
every partial sum is an integer below 2^24 while 127^2 K < 2^24, which
holds for QK^T (K = the head dim, 64) and for PV over up to 1040 keys;
longer key ranges are summed in chunks of 1024 keys in int32. A
reduced fp32 matrix precision (TF32, or bf16 inputs) changes nothing: the
operands, integers of at most 7 bits, are exact in either, and the sums
stay in fp32.
"""

from __future__ import annotations

import torch

# Longest key range one fp32 product sums exactly: 127^2 x 1024 < 2^24.
EXACT_KEYS = 1024


def int_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 tensors ``(..., M, K)`` and ``(..., K,
    N)``: fp32 products over chunks of at most EXACT_KEYS along K, summed
    in int32."""
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, EXACT_KEYS):
        part = (a[..., k0:k0 + EXACT_KEYS].float() @ b[..., k0:k0 + EXACT_KEYS, :].float()).int()
        out = part if out is None else out.add_(part)
    return out


def quantize_static(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(t * (1 / scale)), -127, 127)`` as int8 (the JAX ``_q8``)."""
    return torch.clamp(torch.round(t.float() * (1.0 / scale)), -127, 127).to(torch.int8)


def int8_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    kv_len: int,
    sm_scale: float,
    attn_scales: torch.Tensor,
) -> torch.Tensor:
    """``(B, L, 3D)`` joint qkv -> ``(B, L, D)`` attention output with int8
    QK^T and PV. ``attn_scales`` (3,) fp32: the calibrated per-tensor
    scales (max-abs / 127) of the q, k and v projection outputs. Keys at
    index >= ``kv_len`` are masked; outputs of those rows are not
    specified."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    scales = attn_scales.to(device=qkv.device, dtype=torch.float32).reshape(3)
    sq, sk, sv = scales[0], scales[1], scales[2]

    def heads(t):
        return t.reshape(b, l, num_heads, dh).transpose(1, 2)

    q8 = heads(quantize_static(qkv[..., :d], sq))
    k8 = heads(quantize_static(qkv[..., d:2 * d], sk))
    v8 = heads(quantize_static(qkv[..., 2 * d:], sv))
    s = int_bmm(q8, k8.transpose(-1, -2)).float() * (sq * sk * sm_scale)
    if kv_len < l:
        s = s.masked_fill(torch.arange(l, device=qkv.device) >= kv_len, -float("inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    p8 = torch.round(p * 127.0).to(torch.int8)
    o = int_bmm(p8, v8).float() * (sv / 127.0)
    return o.transpose(1, 2).reshape(b, l, d).to(qkv.dtype)
