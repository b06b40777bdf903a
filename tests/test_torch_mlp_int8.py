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
others bit-equal. The plain LN + int8 projection alone
(``ln_proj_int8_plain``, the first launch of the int8 kernels) is held to
numpy on inputs whose
LN outputs lie away from rounding ties: bit-equal with the float and int8
epilogues, within one int8 step (median 0) with the GELU.
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


def _untied_proj_inputs(b, l, d, n, seed=5):
    """Inputs of the LN + int8 projection whose quantized LN outputs lie at
    least 0.02 of a step from a rounding tie: each row is mu +- s (half the
    columns each way, so its mean and variance are exact in any order) and
    a column's beta is drawn again until every (row kind, sign) clears the
    ties. Returns numpy arrays and the exact yq."""
    rng = np.random.default_rng(seed)
    kinds = [(mu, s) for mu in (-1.0, 0.0, 0.5, 1.5) for s in (0.5, 1.0, 2.0)]
    kind = rng.integers(0, len(kinds), b * l)
    mu = np.array([kinds[k][0] for k in kind])[:, None]
    s = np.array([kinds[k][1] for k in kind])[:, None]
    x = mu + np.stack([rng.permutation(np.repeat([1.0, -1.0], d // 2)) for _ in range(b * l)]) * s
    gam = 1.0 + 0.1 * rng.normal(size=d)
    be = 0.1 * rng.normal(size=d)
    xhat = (x - mu) / np.sqrt(s * s + 1e-5)
    act = float(np.abs(xhat * gam + be).max()) / 120.0
    for c in range(d):
        while True:
            t = (xhat[:, c] * gam[c] + be[c]) / act
            if np.all(np.abs(t - np.floor(t) - 0.5) > 0.02):
                break
            be[c] = 0.1 * rng.normal()
    yq = np.clip(np.round((xhat * gam + be) / act), -127, 127)
    w_q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    acc = yq @ w_q.T.astype(np.float64)
    sw = (rng.uniform(0.5, 1.5, size=n) * 30.0 / acc.std(0)).astype(np.float32)
    bias = (0.5 * rng.normal(size=n)).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(x.reshape(b, l, d)), f32(gam), f32(be), w_q, sw, bias, np.float32(act),
            acc.reshape(b, l, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["float", "int8", "gelu_int8"])
def test_ln_proj_int8_plain_matches_numpy(epilogue, dtype):
    """The plain LN + int8 projection (``ln_proj_int8_plain``, the first
    launch of the int8 block attention and MLP) against numpy on inputs
    away from rounding ties: the
    int32 accumulators are exact, and the dequantize multiply and bias add
    are the same fp32 operations, so the float and int8 epilogues agree bit
    for bit; the GELU epilogue (``sigmoid`` one ulp apart) to one int8 step,
    with a median of 0."""
    from clip_ebc_tpu_torch.ops.fused_attention import ln_proj_int8_plain

    x, gam, be, w_q, sw, bias, act, acc = _untied_proj_inputs(2, 37, D, 3 * D)
    v = acc.astype(np.float32) * sw + bias  # fp32 multiply, then fp32 add
    args = (_t(x, dtype), _t(gam), _t(be), torch.from_numpy(w_q), _t(sw), _t(bias), _t(act))
    act_out = None
    if epilogue == "gelu_int8":
        h = v.astype(np.float64)
        act_out = np.float32(np.abs(h / (1.0 + np.exp(-1.702 * h))).max() / 127.0)
    got = ln_proj_int8_plain(*args, epilogue, None if act_out is None else _t(act_out))
    if epilogue == "float":
        assert got.dtype == getattr(torch, dtype)
        assert torch.equal(got, _t(v, dtype))
    elif epilogue == "int8":
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.clip(np.rint(v), -127, 127))
    else:
        want = np.clip(np.rint((h / (1.0 + np.exp(-1.702 * h))).astype(np.float32) * (1 / act_out)),
                       -127, 127)
        diff = np.abs(got.numpy().astype(np.int32) - want)
        assert diff.max() <= 1 and np.median(diff) == 0
    with pytest.raises(ValueError, match="epilogue must be"):
        ln_proj_int8_plain(*args, "fp8")
