"""The backward of the port's fused LN + QKV + attention against the JAX
package: the plain versions beside the CUDA kernels
(``attention_bwd_plain``, ``ln_qkv_bwd_frozen_plain``) against the Pallas
kernels ``_attention_bwd`` and ``_ln_qkv_bwd_frozen`` in interpret mode,
and the autograd routing of ``fused_ln_qkv_attention`` (frozen kernel or
split path, chosen by which inputs need a gradient) against the JAX
``custom_vjp``. The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda_kernels.py.

Shapes: D = 128, 2 heads, L = 40, B = 2, with kv_len = L and kv_len < L;
the attention backward also at the bf16 kernel's tile and chunk
boundaries (37 to 320 tokens, one valid key, 65 keys).
Every row < L is compared: the JAX kernels compute the gradient of query
rows >= kv_len too, and zero dK, dV there.

Tolerances: fp32 1e-4 (the same math, fp32 sums in another order); bf16
2e-2 of the largest magnitude (the JAX package's bf16 kernel tolerance:
both round P, dS and the outputs to bf16 at the same points, but a sum
taken in another order can land a rounding on the other side). On rows
of mean 50 +- 0.1 fp32 is held within 1e-4 of the largest magnitude
instead: x - mu loses ~9 bits of fp32 on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.ops.fused_attention import _attention_bwd, _ln_qkv_bwd_frozen
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention as jax_fused
from clip_ebc_tpu_torch.ops.fused_attention import (
    attention_bwd,
    attention_bwd_plain,
    fused_ln_qkv_attention,
    ln_bwd_dx,
    ln_bwd_dx_plain,
    ln_qkv_bwd_frozen,
    ln_qkv_bwd_frozen_plain,
)

torch.set_num_threads(2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, L, D, H = 2, 40, 128, 2
SM = (D // H) ** -0.5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * D)).astype(np.float32)
    return x, g, ln_w, ln_b, w, bias


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = TOL[dtype]
    scale = 1.0 if dtype == "float32" else max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _close_scaled(got, want, dtype):
    """``_close`` with the absolute tolerance a fraction of the largest
    magnitude in fp32 too: rows of mean 50 +- 0.1 lose ~9 bits of fp32 in
    x - mu on either side, and their dx is ~10x a unit row's."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


# (B, L, kv_len): besides L = 40 with and without masked keys, the
# boundaries of the bf16 kernel's 64-row tiles and 64-key chunks: a ragged
# length, one valid key, one key past a chunk, every chunk full, and the
# longest length the kernels take
BWD_SHAPES = [(B, L, L), (B, L, 31), (B, 37, 37), (B, L, 1), (1, 96, 65), (1, 256, 256),
              (1, 320, 300)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,kv_len", BWD_SHAPES)
def test_attention_bwd_plain_matches_jax_kernel(dtype, b, l, kv_len):
    rng = np.random.default_rng(l + kv_len)
    qkv = (0.5 * rng.normal(size=(b, l, 3 * D))).astype(np.float32)
    g = rng.normal(size=(b, l, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = _attention_bwd(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), H, kv_len, SM, 1, True)
    got = attention_bwd_plain(_t(qkv, dtype), _t(g, dtype), H, kv_len, SM)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, l, 3 * D)
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    # masked keys get exactly no gradient
    assert not got[:, kv_len:, D:].float().abs().sum()
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = attention_bwd.launches
    assert torch.equal(attention_bwd(_t(qkv, dtype), _t(g, dtype), H, kv_len, SM), got)
    assert attention_bwd.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [L, 31])
def test_ln_qkv_bwd_frozen_plain_matches_jax_kernel(dtype, kv_len):
    x, g, ln_w, ln_b, w, bias = _inputs(seed=kv_len + 1)
    jdt = getattr(jnp, dtype)
    want = _ln_qkv_bwd_frozen(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(w, jdt), jnp.asarray(bias), H, kv_len, SM, 1e-5, 1, True,
    )
    args = (_t(x, dtype), _t(g, dtype), _t(ln_w), _t(ln_b), _t(w.T, dtype), _t(bias))
    got = ln_qkv_bwd_frozen_plain(*args, H, kv_len, SM)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    before = ln_qkv_bwd_frozen.launches
    assert torch.equal(ln_qkv_bwd_frozen(*args, H, kv_len, SM), got)
    assert ln_qkv_bwd_frozen.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_bwd_frozen_plain_matches_jax_kernel_on_large_mean_rows(dtype):
    """x of row mean 50 +- 0.1, where a one-pass variance (E[x^2] - mu^2)
    would cancel: the plain version (two passes, as the JAX body and the CUDA
    kernel take them) against the JAX frozen kernel, interpreting."""
    x, g, ln_w, ln_b, w, bias = _inputs(seed=7)
    x = (50.0 + 0.1 * x).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = _ln_qkv_bwd_frozen(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(w, jdt), jnp.asarray(bias), H, L, SM, 1e-5, 1, True,
    )
    args = (_t(x, dtype), _t(g, dtype), _t(ln_w), _t(ln_b), _t(w.T, dtype), _t(bias))
    got = ln_qkv_bwd_frozen_plain(*args, H, L, SM)
    _close_scaled(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_bwd_dx_plain_is_the_frozen_backward_tail(dtype):
    """``ln_bwd_dx_plain`` (the plain version of the CUDA ``ebc_ln_bwd_dx``)
    against float64 numpy: dy = d_qkv W, then the LayerNorm backward with
    frozen parameters; the wrapper takes it for CPU tensors, uncounted."""
    rng = np.random.default_rng(3)
    x = (50.0 + 0.1 * rng.normal(size=(B, L, D))).astype(np.float32)
    dqkv = rng.normal(size=(B, L, 3 * D)).astype(np.float32)
    gam = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(3 * D, D)) * D**-0.5).astype(np.float32)  # nn.Linear (out, in)
    xt, dt_ = _t(x, dtype), _t(dqkv, dtype)
    wt = _t(w, dtype)
    got = ln_bwd_dx_plain(xt, dt_, _t(gam), wt)
    x64 = xt.double().numpy()
    mu = x64.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    xhat = (x64 - mu) * rstd
    dyh = (dt_.double().numpy() @ wt.double().numpy()) * gam
    want = rstd * (dyh - dyh.mean(-1, keepdims=True) - xhat * (dyh * xhat).mean(-1, keepdims=True))
    assert got.dtype == getattr(torch, dtype)
    _close_scaled(got.float().numpy(), want, dtype)
    before = ln_bwd_dx.launches
    assert torch.equal(ln_bwd_dx(xt, dt_, _t(gam), wt), got)
    assert ln_bwd_dx.launches == before


def _port_grads(x, g, ln_w, ln_b, w, bias, dtype, kv_len, train_params):
    xs = _t(x, dtype).requires_grad_(True)
    params = [_t(ln_w).requires_grad_(train_params), _t(ln_b).requires_grad_(train_params)]
    w_t = _t(w.T).requires_grad_(train_params)  # fp32 master, nn.Linear layout
    b_t = _t(bias).requires_grad_(train_params)
    out = fused_ln_qkv_attention(xs, *params, w_t.to(xs.dtype), b_t, H, kv_len, SM)
    out.backward(_t(g, dtype))
    return xs, params, w_t, b_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [L, 31])
def test_frozen_params_route_to_frozen_backward(dtype, kv_len):
    """Frozen LN and projection: bf16 takes the frozen kernel (here its
    plain version: x.grad is bit-equal to it), fp32 the split path; both
    agree with the JAX ``frozen=True`` backward (the Pallas frozen kernel,
    interpreting) and leave the parameters without a gradient."""
    x, g, ln_w, ln_b, w, bias = _inputs(seed=kv_len + 2)
    xs, params, w_t, b_t = _port_grads(x, g, ln_w, ln_b, w, bias, dtype, kv_len, False)
    assert all(p.grad is None for p in (*params, w_t, b_t))
    if dtype == "bfloat16":
        want_plain = ln_qkv_bwd_frozen_plain(
            xs.detach(), _t(g, dtype), *params, w_t.to(xs.dtype), b_t, H, kv_len, SM
        )
        assert torch.equal(xs.grad, want_plain)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(
        lambda xx: jax_fused(xx, jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w, jdt),
                             jnp.asarray(bias), H, kv_len, SM, 1e-5, 1, True, True),
        jnp.asarray(x, jdt),
    )
    (want,) = vjp(jnp.asarray(g, jdt))
    _close(xs.grad.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainable_params_take_split_path(dtype):
    """Trainable LN and projection: the split path gives x, LN, W and bias
    gradients that agree with the JAX split backward (``_lqa_bwd`` with
    ``frozen=False``: the ln_proj VJP around the Pallas attention
    backward)."""
    kv_len = 33
    x, g, ln_w, ln_b, w, bias = _inputs(seed=5)
    xs, params, w_t, b_t = _port_grads(x, g, ln_w, ln_b, w, bias, dtype, kv_len, True)
    jdt = getattr(jnp, dtype)
    _, vjp = jax.vjp(
        lambda xx, gs, gb, ww, bb: jax_fused(xx, gs, gb, ww.astype(jdt), bb, H, kv_len, SM,
                                             1e-5, 1, True, False),
        jnp.asarray(x, jdt), jnp.asarray(ln_w), jnp.asarray(ln_b), jnp.asarray(w),
        jnp.asarray(bias),
    )
    want = vjp(jnp.asarray(g, jdt))
    got = (xs.grad, params[0].grad, params[1].grad, w_t.grad.T, b_t.grad)
    for a, b in zip(got, want):
        _close(a.float().numpy(), np.asarray(b, np.float32), dtype)
