"""Flash attention on ``(B, H, L, 64)`` q, k, v: counterpart of
``clip_ebc_tpu/ops/flash_attention.py`` ``flash_attention``.

Two routes, as in the JAX package: sequences of at most
``SHORT_SEQ_MAX`` = 512 tokens take the short kernel (the whole-row
softmax, normalized before P.V; JAX ``_flash_forward_short``), longer ones
the tiled kernel (online softmax over 128-key tiles, normalized after P.V;
JAX ``_flash_forward``). Each route's wrapper, :func:`flash_short` and
:func:`flash_tiled`, launches its hand-written kernel in
``csrc/flash_attention.cu`` on a CUDA tensor (counted in its own
``launches``) or raises, and runs its plain version on a CPU tensor.

The kernels take (batch, head, row) strides, so the head views of a
joint qkv ``(B, L, 3D)`` go in without a copy; the output is allocated
``(B, L, H, 64)`` and returned as its ``(B, H, L, 64)`` view, which merges
back into ``(B, L, D)`` for free.

:func:`flash_attention` is differentiable: its backward is autograd
through the plain einsum reference (:func:`attention_reference`), as the
JAX ``_bwd`` differentiates ``_reference``; the TPU has no backward kernel
to port. ``causal`` is an explicit argument: nothing here reads a mask
tensor, so a key-padding mask can never be taken for the causal one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIM = 64
SHORT_SEQ_MAX = 512  # longest sequence of the short route (JAX :101)
KEY_TILE = 128  # keys per online-softmax step of the tiled route (JAX block_k)


def _scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float, causal: bool,
            col0: int = 0) -> torch.Tensor:
    """fp32 scores of q against keys ``[col0, col0 + k.shape[2])``, x
    sm_scale unless it is 1.0, with future keys at NEG_INF when causal."""
    s = q.float() @ k.float().transpose(-1, -2)
    if sm_scale != 1.0:
        s = s * sm_scale
    if causal:
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(col0, col0 + k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def flash_short_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, causal: bool) -> torch.Tensor:
    """The short route's plain version, rounding where ``_short_kernel``
    rounds: fp32 scores (x sm_scale unless 1.0, future keys at NEG_INF when
    causal), ``p = exp(s - max)`` normalized by its fp32 sum, then cast to
    v's dtype; P.V accumulated in fp32; the output in q's dtype."""
    s = _scores(q, k, sm_scale, causal)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def flash_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, causal: bool) -> torch.Tensor:
    """The tiled route's plain version, rounding where ``_kernel`` rounds,
    one 128-key tile at a time (it never holds an (L, L) tensor): per row
    the running max m (from -inf), sum l and fp32 accumulator; per tile
    ``alpha = exp(m - m_next)``, ``p = exp(s - m_next)`` cast to v's dtype
    unnormalized, ``acc = acc * alpha + p V``; at the end ``acc * (1 / l)``
    (1 where l == 0) in q's dtype. A tile wholly above the diagonal, which
    the kernel skips, contributes exactly nothing here: its p are 0 and its
    alpha 1, since every row's first tile holds a valid key."""
    lq, lk = q.shape[2], k.shape[2]
    m = torch.full(q.shape[:3] + (1,), -float("inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:3] + (v.shape[3],), device=q.device)
    for c0 in range(0, lk, KEY_TILE):
        if causal and c0 > lq - 1:
            break
        kt, vt = k[:, :, c0:c0 + KEY_TILE], v[:, :, c0:c0 + KEY_TILE]
        s = _scores(q, kt, sm_scale, causal, c0)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt.float()
        m = m_next
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float, causal: bool) -> torch.Tensor:
    """The einsum reference (JAX ``_reference``) whose autograd is the
    backward: fp32 scores x sm_scale, the causal mask, softmax cast to v's
    dtype, P.V."""
    s = (q @ k.transpose(-1, -2)).float() * sm_scale
    if causal:
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


_ENTRIES = {
    ("short", torch.bfloat16): "ebc_flash_short",
    ("short", torch.float32): "ebc_flash_short_f32",
    ("tiled", torch.bfloat16): "ebc_flash_tiled",
    ("tiled", torch.float32): "ebc_flash_tiled_f32",
}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _entry(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(who: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> None:
    """What the kernels take, checked before any launch: one dtype (bf16 or
    fp32), (B, H, L, 64) with k and v of one shape and q of the same batch
    and heads, contiguous rows with 16-byte aligned starts and (batch,
    head, row) strides (the TMA copies of the tiled bf16 kernel need both),
    a positive ``sm_scale`` (the wgmma kernels take the row max of the raw
    scores), then CUDA tensors on one device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(
                f"{who}: {name} must be a (B, H, L, {HEAD_DIM}) {q.dtype} tensor, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        align = 16 // t.element_size()
        if (t.shape[3] != HEAD_DIM or t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % align for s in t.stride()[:3])):
            raise ValueError(
                f"{who}: {name} needs head dim {HEAD_DIM}, contiguous rows and 16-byte "
                f"aligned rows; got shape {tuple(t.shape)}, strides {t.stride()}"
            )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{who}: needs torch.bfloat16 or torch.float32, got {q.dtype}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or min(q.shape[2], k.shape[2]) < 1:
        raise ValueError(f"{who}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not sm_scale > 0:
        raise ValueError(f"{who}: the kernels take sm_scale > 0, got {sm_scale}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{who}: unsupported device: needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")


def _launch(route: str, q, k, v, sm_scale: float, causal: bool) -> torch.Tensor:
    who = f"flash_{route}"
    _check(who, q, k, v, sm_scale)
    b, h, lq, dh = q.shape
    out = torch.empty(b, lq, h, dh, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = _entry(_ENTRIES[route, q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, lq, k.shape[2],
        *strides, float(sm_scale), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{who}: CUDA launch failed with error {rc}")
    return out


def flash_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                causal: bool = False) -> torch.Tensor:
    """The short route: CPU tensors take :func:`flash_short_plain`; CUDA
    tensors launch the short kernel of their dtype (counted in
    ``flash_short.launches``) or raise. Returns ``(B, H, Lq, 64)``."""
    if q.device.type == "cpu":
        return flash_short_plain(q, k, v, sm_scale, causal)
    if max(q.shape[2], k.shape[2]) > SHORT_SEQ_MAX:
        raise ValueError(f"flash_short: sequences above {SHORT_SEQ_MAX} take flash_tiled")
    out = _launch("short", q, k, v, sm_scale, causal)
    flash_short.launches += 1
    return out


def flash_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                causal: bool = False) -> torch.Tensor:
    """The tiled route: CPU tensors take :func:`flash_tiled_plain`; CUDA
    tensors launch the tiled kernel of their dtype (counted in
    ``flash_tiled.launches``) or raise. Returns ``(B, H, Lq, 64)``."""
    if q.device.type == "cpu":
        return flash_tiled_plain(q, k, v, sm_scale, causal)
    out = _launch("tiled", q, k, v, sm_scale, causal)
    flash_tiled.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (sm_scale, causal)
        route = flash_short if max(q.shape[2], k.shape[2]) <= SHORT_SEQ_MAX else flash_tiled
        return route(q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_reference(*inputs, *ctx.cfg)
        return torch.autograd.grad(out, inputs, g) + (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """``softmax(q k^T * sm_scale) v`` on ``(B, H, L, 64)`` tensors (the JAX
    signature without its block sizes); ``sm_scale`` defaults to
    ``1/sqrt(64)``; ``causal`` masks keys after the query's own index.
    ``max(Lq, Lk) <= SHORT_SEQ_MAX`` takes :func:`flash_short`, longer
    sequences :func:`flash_tiled`."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return _FlashAttention.apply(q, k, v, scale, causal)


flash_short.launches = 0
flash_tiled.launches = 0
