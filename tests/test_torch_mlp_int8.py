"""The port's ``fused_ln_mlp_int8`` (``x + proj(gelu(fc(LN(x))))``, both
products W8A8) against the JAX package's, whose Pallas kernel runs
interpreted on the CPU by itself. The port's tensors are CPU tensors, so
the wrapper runs its plain version.

Sizes: D = 256, hidden 1024, L = 128 and 100 (the JAX kernel pads the
rows to 128), B = 2; weights at the scale of a trained CLIP MLP.

Tolerances. Int8 rounding turns a last-place difference upstream (a
LayerNorm sum taken in another order, a ``sigmoid`` or ``tanh`` one ulp
apart) into a rare one-step flip of the hidden, so the output is held to a
maximum (2e-2 of the largest magnitude, the JAX package's bf16 kernel
tolerance) and a median (1e-3 of it in fp32, 4e-3 in bf16: a wrong scale
or fold moves every entry). The residual dominates the output, so the MLP
branch alone, output minus x, is held to the same limits against its own
largest magnitude. Rows are independent: changing some rows leaves the
others bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.ops.fused_attention import fused_ln_mlp_int8 as jax_mlp
from clip_ebc_tpu_torch.ops import quant as tq
from clip_ebc_tpu_torch.ops.fused_attention import fused_ln_mlp_int8, ln_mlp_int8_plain

torch.set_num_threads(2)
B, D, HID = 2, 256, 1024


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def assert_close_max_median(got, want, max_tol=2e-2, med_tol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= max_tol * top, (diff.max(), top)
    assert np.median(diff) <= med_tol * top, (np.median(diff), top)


def _inputs(l, quick, seed=9):
    """x, LN parameters, JAX-layout (in, out) kernels and biases, and the
    scales a calibration would record (max-abs / 127 of the LN output and
    of the GELU output)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, l, D)).astype(np.float32)
    g = rng.uniform(0.8, 1.2, D).astype(np.float32)
    be = (rng.normal(size=D) * 0.1).astype(np.float32)
    wfc = (rng.normal(size=(D, HID)) * 0.06).astype(np.float32)
    bfc = (rng.normal(size=HID) * 0.02).astype(np.float32)
    wpj = (rng.normal(size=(HID, D)) * 0.03).astype(np.float32)
    bpj = (rng.normal(size=D) * 0.02).astype(np.float32)
    mu = x.mean(-1, keepdims=True)
    y = (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * g + be
    h = y @ wfc + bfc
    if quick:
        hg = h / (1.0 + np.exp(-1.702 * h))
    else:
        hg = 0.5 * h * (1.0 + np.tanh(0.7978845608028654 * (h + 0.044715 * h**3)))
    act1 = np.float32(np.abs(y).max() / 127.0)
    act2 = np.float32(np.abs(hg).max() / 127.0)
    return x, g, be, wfc, bfc, act1, wpj, bpj, act2


@pytest.mark.parametrize("l,quick,dtype", [
    (128, True, "float32"),
    (128, True, "bfloat16"),
    (100, True, "float32"),  # rows the JAX kernel pads
    (128, False, "float32"),  # the tanh GELU
])
def test_ln_mlp_int8_matches_jax_kernel(l, quick, dtype):
    x, g, be, wfc, bfc, act1, wpj, bpj, act2 = _inputs(l, quick)
    want = np.asarray(jax_mlp(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(wfc),
        jnp.asarray(bfc), jnp.asarray(act1), jnp.asarray(wpj), jnp.asarray(bpj), jnp.asarray(act2),
        quick_gelu=quick), np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(wfc.T), _t(bfc), torch.tensor(act1), _t(wpj.T),
            _t(bpj), torch.tensor(act2))
    before = fused_ln_mlp_int8.launches
    got = fused_ln_mlp_int8(*args, quick_gelu=quick)
    assert fused_ln_mlp_int8.launches == before  # a CPU tensor: the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    med = {"float32": 1e-3, "bfloat16": 4e-3}[dtype]
    assert_close_max_median(got.float().numpy(), want, med_tol=med)
    xr = np.asarray(_t(x, dtype).float())  # the residual in x's dtype
    assert_close_max_median(got.float().numpy() - xr, want - xr, med_tol=med)
    quantized = (*tq.quantize_weight(args[3]), *tq.quantize_weight(args[6]))
    plain = ln_mlp_int8_plain(args[0], args[1], args[2], *quantized[:2], args[4], args[5],
                              *quantized[2:], args[7], args[8], quick)
    assert torch.equal(got, plain)
    assert torch.equal(fused_ln_mlp_int8(*args, quick_gelu=quick, quantized=quantized), got)


def test_ln_mlp_int8_rows_are_independent():
    """Changing rows 100.. leaves rows ..99 bit-equal (the JAX package's
    padding passthrough), and raises without no_grad on a weight that trains."""
    x, g, be, wfc, bfc, act1, wpj, bpj, act2 = _inputs(128, True, seed=10)
    x2 = x.copy()
    x2[:, 100:] = 7.7
    rest = (_t(g), _t(be), _t(wfc.T), _t(bfc), torch.tensor(act1), _t(wpj.T), _t(bpj),
            torch.tensor(act2))
    o1 = fused_ln_mlp_int8(_t(x), *rest)
    o2 = fused_ln_mlp_int8(_t(x2), *rest)
    assert torch.equal(o1[:, :100], o2[:, :100]) and not torch.equal(o1[:, 100:], o2[:, 100:])
    w = rest[2].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_ln_mlp_int8(_t(x), *rest[:2], w, *rest[3:])
