"""The port's LN + QKV + attention against the JAX package's
``fused_ln_qkv_attention`` (Pallas, interpreting on the CPU by itself)
and its ``_ln_qkv_reference`` (the CUDA kernel is held against the plain
version in tests/test_torch_cuda_kernels.py). Only query rows < kv_len are
compared: the JAX kernels leave the others unspecified.

Tolerances: fp32 1e-4 (same math, fp32 summation order only); bf16 2e-2,
the JAX package's own kernel tolerance (bf16 roundings of qkv and P land
on different sides when sums are taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.ops.fused_attention import _ln_qkv_reference
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention as jax_fused
from clip_ebc_tpu_torch.ops.fused_attention import (
    fused_ln_qkv_attention,
    ln_qkv_attention_plain,
)

torch.set_num_threads(2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(b, l, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    be = (0.1 * rng.normal(size=d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) * d**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * d)).astype(np.float32)
    return x, g, be, w, bias


def _port(x, g, be, w, bias, dtype, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(x).to(getattr(torch, dtype)), t(g), t(be),
            t(np.ascontiguousarray(w.T)).to(getattr(torch, dtype)), t(bias))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [37, 33])
def test_plain_matches_jax_kernel_and_reference(kv_len, dtype):
    b, l, d, h = 3, 37, 128, 2
    x, g, be, w, bias = _inputs(b, l, d, seed=kv_len)
    sm = (d // h) ** -0.5
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_kernel = np.asarray(
        jax_fused(jx, jnp.asarray(g), jnp.asarray(be), jnp.asarray(w), jnp.asarray(bias),
                  h, kv_len, sm), np.float32)
    want_ref = np.asarray(_ln_qkv_reference(
        jx[:, :kv_len], jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.ones((3 * d,), jnp.float32), jnp.asarray(bias), h, kv_len, sm, 1e-5,
    ), np.float32)
    got = ln_qkv_attention_plain(*_port(x, g, be, w, bias, dtype), h, kv_len, sm).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got[:, :kv_len], want_kernel[:, :kv_len], rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:, :kv_len], want_ref, rtol=tol, atol=tol)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, g, be, w, bias = _inputs(2, 20, 128, seed=0)
    args = _port(x, g, be, w, bias, "float32")
    before = fused_ln_qkv_attention.launches
    got = fused_ln_qkv_attention(*args, 2, 17, 0.125)
    assert torch.equal(got, ln_qkv_attention_plain(*args, 2, 17, 0.125))
    assert fused_ln_qkv_attention.launches == before



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l", [(3, 43), (1, 65)])
def test_plain_matches_jax_kernel_at_ragged_rows(b, l, dtype):
    """Row counts just past the CUDA projection's 128-row and 64-row items
    (3 x 43 = 129 rows, 65 rows): the plain version the kernel is held to
    against the JAX kernel, the keys masked past l - 2."""
    d, h, kv_len = 128, 2, l - 2
    x, g, be, w, bias = _inputs(b, l, d, seed=b * l)
    sm = (d // h) ** -0.5
    want = np.asarray(jax_fused(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be),
                                jnp.asarray(w), jnp.asarray(bias), h, kv_len, sm), np.float32)
    got = ln_qkv_attention_plain(*_port(x, g, be, w, bias, dtype), h, kv_len, sm).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got[:, :kv_len], want[:, :kv_len], rtol=tol, atol=tol)
