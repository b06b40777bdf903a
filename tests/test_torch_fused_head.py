"""The port's fused EBC head against the JAX package's Pallas kernel
(interpret mode on the CPU, as tests/test_fused_head.py runs it) and its
``ebc_head_reference`` (the CUDA kernel is held against the plain version
in tests/test_torch_cuda_kernels.py).

Tolerance rtol 1e-4: both sides take the same inputs (bf16 features are
rounded once, identically, before either side sees them) and do all the
math in fp32, so they differ only by fp32 summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.config import get_bins_and_anchors
from clip_ebc_tpu.ops.fused_head import ebc_head_reference, fused_ebc_head as jax_fused_ebc_head
from clip_ebc_tpu_torch.ops.fused_head import ebc_head_plain, fused_ebc_head

torch.set_num_threads(2)


def _inputs(n, c, truncation, seed):
    rng = np.random.default_rng(seed)
    _, anchors = get_bins_and_anchors(8, truncation, "qnrf")
    k = len(anchors)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    text = rng.normal(size=(k, c)).astype(np.float32)
    return feats, text, np.float32(1 / 0.07), np.asarray(anchors, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("truncation", [4, 11])  # K = 5 and K = 12 bins
def test_plain_head_matches_jax(truncation, dtype):
    feats, text, scale, anchors = _inputs(700, 512, truncation, seed=truncation)
    jf = jnp.asarray(feats, getattr(jnp, dtype))
    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    want_kernel = np.asarray(jax_fused_ebc_head(
        jf, jnp.asarray(text), jnp.asarray(scale), jnp.asarray(anchors),
        block_n=256, interpret=True,
    ))
    want_ref = np.asarray(ebc_head_reference(
        jf.astype(jnp.float32), jnp.asarray(text), jnp.asarray(scale), jnp.asarray(anchors)
    ))
    got = ebc_head_plain(tf, torch.from_numpy(text), torch.tensor(scale),
                         torch.from_numpy(anchors)).numpy()
    assert got.shape == (700,)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, want_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,zero_row", [(1, False), (5, True), (1, True)])
def test_plain_head_matches_jax_one_bin_and_zero_row(k, zero_row, dtype):
    """One bin (every row's density is that bin's anchor) and an all-zero
    feature row (the norm's 1e-12 clamp: every cosine 0, a uniform
    softmax), the edges the CUDA kernel's redesign is also held at."""
    rng = np.random.default_rng(k + 10 * zero_row)
    feats = rng.normal(size=(300, 256)).astype(np.float32)
    if zero_row:
        feats[::7] = 0.0
    text = rng.normal(size=(k, 256)).astype(np.float32)
    anchors = np.sort(rng.uniform(0, 4, size=k)).astype(np.float32)
    scale = np.float32(1 / 0.07)
    jf = jnp.asarray(feats, getattr(jnp, dtype))
    want = np.asarray(jax_fused_ebc_head(
        jf, jnp.asarray(text), jnp.asarray(scale), jnp.asarray(anchors), block_n=128,
        interpret=True,
    ))
    got = ebc_head_plain(torch.from_numpy(feats).to(getattr(torch, dtype)), torch.from_numpy(text),
                         torch.tensor(scale), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if k == 1:
        np.testing.assert_allclose(got, anchors[0], rtol=1e-6)
    if zero_row:
        np.testing.assert_allclose(got[::7], anchors.mean(), rtol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    feats, text, scale, anchors = _inputs(64, 512, 4, seed=0)
    args = (torch.from_numpy(feats), torch.from_numpy(text), torch.tensor(scale),
            torch.from_numpy(anchors))
    before = fused_ebc_head.launches
    assert torch.equal(fused_ebc_head(*args), ebc_head_plain(*args))
    assert fused_ebc_head.launches == before  # no kernel launched

