"""The masked attention of a packed qkv (``qkv_attention_plain``, the plain
version of ``fused_qkv_attention``) against the JAX package's
``fused_qkv_attention`` (Pallas, interpreting on the CPU by itself) at the
flagship window length, and the two facts the port's CUDA attention body
(``csrc/attention_short.cuh``) builds on: keys past ``kv_len`` may be
dropped instead of masked, and a scale it cannot take is refused before
any launch.

Only query rows < kv_len are compared: the JAX kernel leaves the others
unspecified. Tolerances: fp32 2e-4, as ``tests/test_torch_quant.py``
holds the same function at other shapes (same math, fp32 summation order
only); bf16 2e-2, the JAX package's own kernel tolerance (the unnormalized
P is rounded to bf16 on both sides, and a rounding can land on the other
side when sums are taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.ops.fused_attention import fused_qkv_attention as jax_qkv_attention
from clip_ebc_tpu_torch.ops import fused_attention as fa

torch.set_num_threads(2)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(b, l, d, seed):
    return np.random.default_rng(seed).normal(size=(b, l, 3 * d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [229, 200])
def test_plain_matches_jax_kernel_at_the_window_length(kv_len, dtype):
    """2 windows of the flagship's 229 tokens (1 CLS + 32 prompts + 196
    patches), 2 heads; all keys valid, and the last 29 masked."""
    b, l, d, h = 2, 229, 128, 2
    qkv = _qkv(b, l, d, seed=kv_len)
    sm = (d // h) ** -0.5
    want = np.asarray(jax_qkv_attention(jnp.asarray(qkv, getattr(jnp, dtype)), h, kv_len, sm),
                      np.float32)
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    before = fa.fused_qkv_attention.launches
    got = fa.fused_qkv_attention(t, h, kv_len, sm)
    assert fa.fused_qkv_attention.launches == before  # a CPU tensor: the plain version
    assert got.dtype == t.dtype and got.shape == (b, l, d)
    assert torch.equal(got, fa.qkv_attention_plain(t, h, kv_len, sm))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy()[:, :kv_len], want[:, :kv_len], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropping_keys_past_kv_len_equals_masking_them(dtype):
    """The CUDA body loads only keys < kv_len (those past it land as zeros and
    are masked): a masked key's p is exactly 0, so the attention over the
    first kv_len keys is the masked attention over all of them."""
    b, l, d, h, kv_len = 2, 229, 128, 2, 200
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_qkv(b, l, d, seed=3)).to(dt)
    sm = (d // h) ** -0.5
    want = fa.qkv_attention_plain(qkv, h, kv_len, sm).float()
    q, k, v = (fa._heads(x, h).float() for x in qkv.split(d, dim=-1))
    s = (q @ k[:, :, :kv_len].transpose(-1, -2)) * sm
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v[:, :, :kv_len]) / p.sum(-1, keepdim=True)
    got = fa._merge_heads(o.to(dt)).float()
    tol = {"float32": 1e-6, "bfloat16": 8e-3}[dtype]  # one bf16 step of an output near 1
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", [-0.125, 0.0, float("nan")])
def test_scale_is_checked_before_any_launch(scale):
    """The float attention's wgmma body takes the row max of the raw scores,
    so the entries that launch it (``fused_qkv_attention``,
    ``fused_ln_qkv_attention`` and the float branch of
    ``fused_ln_qkv_attention_int8``) refuse sm_scale <= 0 in their shared
    checks, before the device check and any launch. A CPU tensor with a
    positive scale, or none (the int8 attention's branch), is refused only
    as a device."""
    x = torch.zeros(2, 37, 128, dtype=torch.bfloat16)
    launches = fa.fused_qkv_attention.launches, fa.fused_ln_qkv_attention.launches
    with pytest.raises(ValueError, match="sm_scale > 0"):
        fa._check_attention("fused_qkv_attention", x, 2, 37, sm_scale=scale)
    for ok in (0.125, None):
        with pytest.raises(ValueError, match="unsupported device"):
            fa._check_attention("fused_qkv_attention", x, 2, 37, sm_scale=ok)
    assert (fa.fused_qkv_attention.launches, fa.fused_ln_qkv_attention.launches) == launches
