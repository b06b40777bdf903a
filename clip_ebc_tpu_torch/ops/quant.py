"""W8A8 int8 inference: counterpart of ``clip_ebc_tpu/ops/quant.py``.

- Weights: symmetric per-output-channel scales (max-abs / 127), quantized
  from the fp32 master parameters, so checkpoints and parameter names are
  unchanged. The int8 copy is kept per weight set and remade when the
  parameter changes (its ``data_ptr`` or version), never served stale.
- Activations, two modes: ``dynamic`` takes per-row scales (per-tensor for
  a convolution) from the input itself; ``static`` uses one per-tensor
  scale per layer, recorded beforehand by :func:`calibrate_int8` as the
  running max-abs over representative batches.
- The products are int8 x int8 -> int32, exact on every device. They lie
  outside any hand-written kernel (the JAX package leaves them to XLA), so
  the matrix product is ``torch._int_mm`` and the convolution is an im2col
  around it on a CUDA tensor, an int32 ``conv2d`` on a CPU tensor.

The JAX package's ``quant`` variable collection lives here in buffers
registered ``persistent=False`` (``state_dict()`` keeps the reference's
keys): ``act_amax`` on each :class:`Int8Linear` / :class:`Int8Conv2d`,
``in_proj_act_amax`` and ``qkv_amax`` on a quantized ``MultiHeadAttention``.
:func:`quant_state` and :func:`load_quant_state` read and write them, and
:func:`calibrating` is the switch that stands in for flax's
``mutable=["quant"]``: while it is set on a model, dynamic layers record
and the trunk's blocks take their unfused path. A static layer only reads
its scale, and raises when it is run with a scale of zero.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8
QUANT_MODES = ("dynamic", "static")
# quant_attn of a model (the JAX package's values): float attention, the
# int8 attention kernel, or int8 attention as plain integer products
QUANT_ATTN_MODES = (False, True, "xla")
QUANT_BUFFERS = ("act_amax", "qkv_amax")  # suffixes of the quant buffers' names


def _round_clip(x: torch.Tensor) -> torch.Tensor:
    """Half-to-even round, clipped to the symmetric int8 range."""
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along the last axis: ``(..., K)`` ->
    (int8 values, fp32 scales ``(..., 1)``)."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(_EPS)
    return _round_clip(xf / scale), scale


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization of a ``(K, N)`` kernel
    (the JAX package's layout): (int8 ``(K, N)``, fp32 scales ``(1, N)``)."""
    wf = w.float()
    scale = (wf.abs().amax(0, keepdim=True) / 127.0).clamp_min(_EPS)
    return _round_clip(wf / scale), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of a torch-layout weight ``(N, ...)``
    (``nn.Linear`` (out, in), ``nn.Conv2d`` OIHW), one scale over all the
    other axes: (int8, same shape; fp32 scales ``(N,)``)."""
    wf = w.detach().float()
    scale = (wf.flatten(1).abs().amax(1) / 127.0).clamp_min(_EPS)
    return _round_clip(wf / scale.reshape(-1, *[1] * (w.dim() - 1))), scale


def int_mm(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 ``(M, K)`` x int8 ``(N, K)``^T -> int32 ``(M, N)``, b in
    torch's (out, in) layout: ``torch._int_mm`` on either device. On the
    card that call needs more than 16 rows (fewer are padded with zeros)
    and K and N in multiples of 8 (else this raises)."""
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8 or a_q.dim() != 2 or b_q.dim() != 2:
        raise ValueError("int_mm takes two 2-D int8 tensors")
    m, k = a_q.shape
    if a_q.is_cuda:
        if k % 8 or b_q.shape[0] % 8:
            raise ValueError(f"int_mm on CUDA needs K and N in multiples of 8, got K={k}, N={b_q.shape[0]}")
        if m <= 16:
            a_q = F.pad(a_q, (0, 0, 0, 17 - m))
    return torch._int_mm(a_q.contiguous(), b_q.t())[:m]


def _dequant(acc: torch.Tensor, scale: torch.Tensor, bias, out_dtype) -> torch.Tensor:
    out = acc.float() * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def int8_linear(
    x: torch.Tensor, w_q: torch.Tensor, s_w: torch.Tensor, bias: Optional[torch.Tensor],
    act_scale: Optional[torch.Tensor] = None, out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``(..., K)`` x quantized weight ``w_q`` (N, K) with scales ``s_w``
    (N,): per-row dynamic activation scales, or the static per-tensor
    ``act_scale`` when given; ``acc * (s_x * s_w) + bias`` in fp32, rounded
    to ``out_dtype`` (default x's)."""
    if act_scale is None:
        x_q, s_x = quantize_rowwise(x)
    else:
        x_q, s_x = _round_clip(x.float() / act_scale), act_scale
    acc = int_mm(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
    return _dequant(acc, s_x * s_w, bias, out_dtype or x.dtype)


def int8_matmul(x, kernel, bias=None, out_dtype=None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` with W8A8 dynamic quantization (the JAX
    package's signature and kernel layout)."""
    w_q, s_w = quantize_weight(kernel.t())
    return int8_linear(x, w_q, s_w, bias, None, out_dtype)


def int8_matmul_static(x, kernel, act_scale, bias=None, out_dtype=None) -> torch.Tensor:
    """``(..., K) @ (K, N)`` with a precalibrated per-tensor activation scale."""
    w_q, s_w = quantize_weight(kernel.t())
    return int8_linear(x, w_q, s_w, bias, torch.as_tensor(act_scale, dtype=torch.float32), out_dtype)


def _tensor_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t._version, t.device)


class Cached:
    """One value derived from a tensor, remade when the tensor changes."""

    def __init__(self) -> None:
        self.key = None
        self.value = None

    def get(self, t: torch.Tensor, make: Callable):
        key = _tensor_key(t)
        if key != self.key:
            self.value, self.key = make(t), key
        return self.value


def checked_act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The static per-tensor activation scale of a recorded max-abs;
    raises while nothing was recorded (one host read per change of the
    buffer, through :class:`Cached`)."""
    if not float(amax) > 0:
        raise RuntimeError(
            "static int8 layer run with an uncalibrated activation scale (act_amax == 0): "
            "calibrate the dynamic-mode twin on representative data first "
            "(calibrate_int8, load_quant_state)"
        )
    return amax.clamp_min(_EPS * 127.0) / 127.0


def checked_attn_scales(qkv_amax: torch.Tensor) -> torch.Tensor:
    """The int8 attention's static scales of q, k and v from the recorded
    ``qkv_amax`` (3,); raises while any of them is zero."""
    if not bool((qkv_amax > 0).all()):
        raise RuntimeError(
            "quant_attn run with an uncalibrated attention scale (qkv_amax has a zero): "
            "calibrate the dynamic-mode twin on representative data first "
            "(calibrate_int8, load_quant_state)"
        )
    return qkv_amax.clamp_min(_EPS * 127.0) / 127.0


class _QuantLayer:
    """What the quantized layers share: the mode, the ``act_amax`` buffer,
    the cached int8 weight and the cached, checked static scale."""

    def _init_quant(self, quant_mode: str) -> None:
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be one of {QUANT_MODES}, got {quant_mode!r}")
        self.quant_mode = quant_mode
        self.calibrating = False
        self.register_buffer("act_amax", torch.zeros(()), persistent=False)
        self._wq, self._scale = Cached(), Cached()

    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._wq.get(self.weight, quantize_weight)

    def static_scale(self) -> Optional[torch.Tensor]:
        """The static activation scale (raises while it is zero), or None
        in dynamic mode, where a calibration pass also records."""
        if self.quant_mode == "static":
            return self._scale.get(self.act_amax, checked_act_scale)
        return None

    def record(self, x: torch.Tensor) -> None:
        if self.calibrating and self.quant_mode == "dynamic":
            record_amax(self.act_amax, x)


def record_amax(buf: torch.Tensor, x: torch.Tensor, dims=None) -> None:
    """Running max of ``|x|`` (over ``dims``, default all) into ``buf``."""
    a = x.detach().float().abs()
    with torch.no_grad():
        buf.copy_(torch.maximum(buf, a.amax() if dims is None else a.amax(dims)))


class Int8Linear(nn.Linear, _QuantLayer):
    """Drop-in for the port's ``Linear`` (same parameter names and shapes,
    so every checkpoint loads unchanged) whose product runs in int8."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant_mode: str = "dynamic") -> None:
        super().__init__(in_features, out_features, bias)
        self._init_quant(quant_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.record(x)
        w_q, s_w = self.quantized_weight()
        return int8_linear(x, w_q, s_w, self.bias, self.static_scale())


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding, dilation) -> torch.Tensor:
    """The plain int32 convolution of int8 NCHW ``x_q`` with int8 OIHW
    ``w_q`` (CPU tensors: the card has no integer convolution, and the CPU
    none with a dilation)."""
    return F.conv2d(x_q.int(), w_q.int(), None, stride, padding, dilation)


def int8_conv2d_im2col(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding, dilation) -> torch.Tensor:
    """The same accumulators as one integer matrix product: the taps of
    each output position gathered channels-last into ``(B Ho Wo, kh kw C)``
    rows, against the weight as ``(O, kh kw C)``."""
    b, c, h, w = x_q.shape
    o, _, kh, kw = w_q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))  # NHWC, zero = exact
    taps = [xp[:, i * dh: i * dh + (ho - 1) * sh + 1: sh, j * dw: j * dw + (wo - 1) * sw + 1: sw]
            for i in range(kh) for j in range(kw)]
    cols = torch.cat(taps, dim=-1).reshape(b * ho * wo, kh * kw * c)
    acc = int_mm(cols, w_q.permute(0, 2, 3, 1).reshape(o, kh * kw * c))
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv2d_shifted(x_q: torch.Tensor, w_q: torch.Tensor, stride, padding, dilation) -> torch.Tensor:
    """The same accumulators as ``kh kw`` shifted matrix products summed in
    int32 (no ``kh kw``-fold copy of the input). Slower than the im2col on
    an H100 at the decoder's shape (PERF.md), so no layer takes it; kept as
    the measured alternative and a second check of the accumulators."""
    b, c, h, w = x_q.shape
    o, _, kh, kw = w_q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i * dh: i * dh + (ho - 1) * sh + 1: sh, j * dw: j * dw + (wo - 1) * sw + 1: sw]
            part = int_mm(tap.reshape(b * ho * wo, c), w_q[:, :, i, j].contiguous())
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


class Int8Conv2d(nn.Conv2d, _QuantLayer):
    """Drop-in for the port's ``Conv2d`` whose convolution runs in int8:
    per-output-channel weight scales over ``(cin, kh, kw)``, a per-tensor
    activation scale (static, or the input's own max-abs). Symmetric
    quantization maps 0 to 0, so zero padding is exact."""

    def __init__(self, *args, quant_mode: str = "dynamic", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.padding_mode != "zeros" or isinstance(self.padding, str):
            raise NotImplementedError("Int8Conv2d takes groups=1 and explicit zero padding")
        self._init_quant(quant_mode)

    def accumulate(self, x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
        """int32 NCHW accumulators of int8 NCHW ``x_q``."""
        conv = int8_conv2d_im2col if x_q.is_cuda else int8_conv2d_plain
        return conv(x_q, w_q, self.stride, self.padding, self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.record(x)
        w_q, s_w = self.quantized_weight()
        xf = x.float()
        s_x = self.static_scale()
        if s_x is None:
            s_x = (xf.abs().amax() / 127.0).clamp_min(_EPS)
        acc = self.accumulate(_round_clip(xf / s_x), w_q)
        bias = None if self.bias is None else self.bias[:, None, None]
        return _dequant(acc, (s_x * s_w)[:, None, None], bias, x.dtype)


# ---- the quant collection ------------------------------------------------------


def _quant_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b for n, b in model.named_buffers() if n.endswith(QUANT_BUFFERS)}


def quant_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's recorded max-abs buffers, ``{dotted name: CPU tensor}``."""
    return {n: b.detach().cpu().clone() for n, b in _quant_buffers(model).items()}


def load_quant_state(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Write ``state`` (of :func:`quant_state`, from this model or its
    dynamic twin) into the model's buffers; the names must match exactly."""
    bufs = _quant_buffers(model)
    if sorted(bufs) != sorted(state):
        raise KeyError(f"quant state names differ: {sorted(set(bufs) ^ set(state))[:8]}")
    with torch.no_grad():
        for n, b in bufs.items():
            b.copy_(torch.as_tensor(state[n], dtype=b.dtype).reshape(b.shape))


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """While set, the model's dynamic layers record their inputs' max-abs
    and its trunk blocks take the unfused path."""
    mods = [m for m in model.modules() if hasattr(m, "calibrating")]
    for m in mods:
        m.calibrating = True
    try:
        yield model
    finally:
        for m in mods:
            m.calibrating = False


def calibrate_int8(model: nn.Module, batches: Iterable, forward: Optional[Callable] = None):
    """Record per-layer activation max-abs over representative ``batches``
    (a running max) on a *dynamic*-mode quantized ``model``; each batch
    goes through ``forward(batch)`` (default ``model(batch)``). Returns the
    :func:`quant_state`, ready for :func:`load_quant_state` on the static
    twin."""
    if not _quant_buffers(model):
        raise ValueError(
            "calibration recorded nothing: the model has no quantized layers; "
            "build it with quant_int8=True / a clip_* backbone"
        )
    forward = forward or model
    with calibrating(model), torch.no_grad():
        for batch in batches:
            forward(batch)
    state = quant_state(model)
    validate_quant_scales(
        state, quant_attn=any(getattr(m, "quant_attn", False) for m in model.modules()))
    return state


def validate_quant_scales(state: Mapping[str, torch.Tensor], strict: bool = False,
                          quant_attn=False) -> None:
    """Check recorded scales after calibration. A zero max-abs means the
    layer was never exercised. All zero: the calibration recorded nothing
    (a static-mode model calibrated in place of its dynamic twin), always
    an error. Single zero leaves are a branch the calibration forward never
    took; static inference reads only the scales of layers it runs, so
    those are a warning naming each leaf, an error with ``strict``, and an
    error for a ``qkv_amax`` when ``quant_attn`` is set (the int8
    attention of every block reads it)."""
    if not state:
        raise ValueError("no quant state: run calibrate_int8 first")
    bad = [n for n, v in state.items() if not bool((torch.as_tensor(v) > 0).all())]
    if not bad:
        return
    if quant_attn:
        strict = strict or any(n.endswith("qkv_amax") for n in bad)
    msg = (
        "uncalibrated int8 activation scales (act_amax == 0) at: "
        + ", ".join(bad[:8]) + (" ..." if len(bad) > 8 else "")
        + "; calibrate the dynamic-mode twin on representative data before "
        "running quant_mode='static'"
    )
    if len(bad) == len(state) or strict:
        raise ValueError(msg)
    logging.getLogger("clip_ebc_tpu_torch").warning(
        "%s (layers not exercised by the calibration forward; static "
        "inference is unaffected unless it executes them)", msg
    )
