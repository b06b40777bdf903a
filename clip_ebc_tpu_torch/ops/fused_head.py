"""Fused EBC head (inference only): counterpart of ``clip_ebc_tpu/ops/fused_head.py``.

Per feature row: L2-normalize, cosine against the normalized text
embeddings, scale by ``exp(logit_scale)``, softmax over the bins, dot with
the anchor points; one fp32 density per row. On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/fused_head.cu``; on a CPU tensor
it runs :func:`ebc_head_plain`. It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Feature widths the kernel takes: a multiple of CHANNEL_STEP (one 16-byte
# read across the lanes of a row), at most MAX_CHANNELS (16 such reads a lane).
CHANNEL_STEP = 64
MAX_CHANNELS = 1024


def ebc_head_plain(
    features: torch.Tensor,  # (N, C) image features (unnormalized)
    text_features: torch.Tensor,  # (K, C) text features (unnormalized)
    logit_scale: torch.Tensor,  # scalar, already exp()'d
    anchor_points: torch.Tensor,  # (K,)
) -> torch.Tensor:
    """The plain version: ``ebc_head_reference``'s math in fp32 torch ops."""
    f = features.float()
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-12)
    t = text_features.float()
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    logits = torch.as_tensor(logit_scale, dtype=torch.float32, device=f.device) * (f @ t.T)
    p = torch.softmax(logits, dim=-1)
    return (p * anchor_points.float()).sum(-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_head")
    fn = lib.ebc_fused_head
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.ebc_fused_head_max_bins.argtypes = []
        lib.ebc_fused_head_max_bins.restype = ctypes.c_int
    return lib


def fused_ebc_head(
    features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    anchor_points: torch.Tensor,
) -> torch.Tensor:
    """``(N, C)`` features -> ``(N,)`` fp32 per-block expected counts.

    CPU tensors take :func:`ebc_head_plain`; CUDA tensors launch the
    kernel (and count the launch in ``fused_ebc_head.launches``) or raise.
    Inference only, as in the JAX package: with grad enabled and an input
    that requires grad it raises rather than return a result with no
    gradient (a training forward needs the logits and takes the plain head).
    """
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in (features, text_features, logit_scale, anchor_points)
    ):
        raise RuntimeError(
            "fused_ebc_head has no backward: call it under torch.no_grad() or "
            "torch.inference_mode(), or take the plain head"
        )
    if features.device.type == "cpu":
        return ebc_head_plain(features, text_features, logit_scale, anchor_points)
    if features.device.type != "cuda":
        raise ValueError(f"fused_ebc_head: unsupported device {features.device}")
    if features.dim() != 2 or not features.is_contiguous():
        raise ValueError("fused_ebc_head: features must be a contiguous (N, C) tensor")
    if features.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_ebc_head: features must be bf16 or fp32, got {features.dtype}")
    n, c = features.shape
    k = text_features.shape[0]
    if c % CHANNEL_STEP or not CHANNEL_STEP <= c <= MAX_CHANNELS:
        raise ValueError(
            f"fused_ebc_head: C={c} must be a multiple of {CHANNEL_STEP} and <= {MAX_CHANNELS}"
        )
    if text_features.shape != (k, c) or anchor_points.shape != (k,):
        raise ValueError("fused_ebc_head: text (K, C) and anchors (K,) must match features")
    if features.data_ptr() % 16:
        raise ValueError("fused_ebc_head: features must be 16-byte aligned")
    lib = _lib()
    if not 1 <= k <= lib.ebc_fused_head_max_bins():
        raise ValueError(f"fused_ebc_head: K={k} bins outside 1..{lib.ebc_fused_head_max_bins()}")
    dev = features.device
    # the kernel normalizes the text rows (fp32) itself
    t = text_features.to(dev, torch.float32).contiguous()
    anchors = anchor_points.to(dev, torch.float32).contiguous()
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=dev).reshape(1).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.ebc_fused_head(
        features.data_ptr(), int(features.dtype == torch.bfloat16), t.data_ptr(),
        anchors.data_ptr(), scale.data_ptr(), out.data_ptr(), n, c, k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_ebc_head: CUDA launch failed with error {rc}")
    fused_ebc_head.launches += 1
    return out


fused_ebc_head.launches = 0
