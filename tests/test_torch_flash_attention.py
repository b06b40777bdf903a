"""The port's flash attention (``clip_ebc_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the port's routes take their plain versions, which round
where the TPU kernels round: the short route normalizes P before P.V, the
tiled route walks 128-key tiles with an online softmax. Inputs come from
numpy seeds. Tolerances are those of ``tests/test_flash_attention.py``:
2e-5 in fp32 and 3e-2 in bf16 (the two frameworks sum in another order,
and a bf16 rounding of P can land on the other side); gradients 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.ops.flash_attention import flash_attention as jax_flash
from clip_ebc_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, b, h, l, dh=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, l, dh)).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, causal, dtype):
    args = [jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (q, k, v)]
    return np.asarray(jax_flash(*args, None, causal, 128, 128, True), np.float32)


def _torch(arrays, dtype):
    return [torch.from_numpy(t).to(getattr(torch, dtype)) for t in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route,l,causal", [
    ("short", 197, False),  # a ViT-B/16 window without prompts: padded to 256 on the TPU
    ("short", 77, True),  # the text tower
    ("tiled", 650, False),  # ragged: 5 full key tiles and one of 10 keys
    ("tiled", 650, True),
])
def test_plain_versions_match_jax_kernels(route, l, causal, dtype):
    q, k, v = _qkv(l + causal, 2, 2, l)
    want = _jax(q, k, v, causal, dtype)
    plain = fa.flash_short_plain if route == "short" else fa.flash_tiled_plain
    got = plain(*_torch((q, k, v), dtype), 64**-0.5, causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, l, 64)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("l,route", [(512, "short"), (513, "tiled")])
def test_flash_attention_routes_by_length(l, route):
    """``max(Lq, Lk) <= SHORT_SEQ_MAX`` takes the short route, as JAX :248;
    on CPU tensors each route is its plain version, bit for bit."""
    q, k, v = _torch(_qkv(3, 1, 1, l), "float32")
    plain = fa.flash_short_plain if route == "short" else fa.flash_tiled_plain
    assert torch.equal(fa.flash_attention(q, k, v), plain(q, k, v, 64**-0.5, False))


@pytest.mark.parametrize("l", [130, 600])
def test_gradient_matches_jax_grad(l):
    q, k, v = _qkv(l, 1, 2, l)
    gout = np.random.default_rng(l + 1).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return (jax_flash(q_, k_, v_, None, False, 128, 128, True) * gout).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    inputs = [t.requires_grad_(True) for t in _torch((q, k, v), "float32")]
    (fa.flash_attention(*inputs) * torch.from_numpy(gout)).sum().backward()
    for t, w in zip(inputs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=3e-5)


def test_head_views_of_a_joint_qkv_need_no_copy():
    """The model hands in strided head views of (B, L, 3D); the result is
    the same as on contiguous tensors, and the output is a view of a
    (B, L, H, 64) tensor, so merging the heads is free."""
    b, l, h = 2, 600, 3
    qkv = torch.from_numpy(np.random.default_rng(4).normal(size=(b, l, 3 * h * 64)).astype(np.float32))
    q, k, v = (t.reshape(b, l, h, 64).transpose(1, 2) for t in qkv.split(h * 64, dim=-1))
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_tiled_plain(q.contiguous(), k.contiguous(), v.contiguous(), 64**-0.5, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_tiled_plain_skips_no_mass_above_the_diagonal():
    """The kernel skips causal tiles wholly above the diagonal; the plain
    version masks them instead, and both equal the einsum reference."""
    q, k, v = _torch(_qkv(5, 1, 2, 300), "float32")
    want = fa.attention_reference(q, k, v, 0.125, True)
    torch.testing.assert_close(fa.flash_tiled_plain(q, k, v, 0.125, True), want,
                               rtol=2e-5, atol=2e-5)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel launch, whose checks raise here (a meta tensor) instead of
    computing anything."""
    q, k, v = (torch.empty(1, 1, 600, 64, device="meta") for _ in range(3))
    for route in (fa.flash_short, fa.flash_tiled):
        with pytest.raises(ValueError, match="unsupported device"):
            route(q[:, :, :300], k[:, :, :300], v[:, :, :300], 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, k, v)
    assert fa.flash_short.launches == 0 and fa.flash_tiled.launches == 0


def _joint_heads(b, l, h, extra=0, start=0):
    """bf16 q, k, v as the model hands them in: head views of a joint qkv
    (B, L, 3 H 64), its rows ``extra`` elements longer than the three
    heads' and the views ``start`` elements into them."""
    qkv = torch.zeros(b, l, 3 * h * 64 + extra, dtype=torch.bfloat16)
    return [qkv[..., start + i * h * 64:start + (i + 1) * h * 64].reshape(b, l, h, 64).transpose(1, 2)
            for i in range(3)]


@pytest.mark.parametrize("case,match", [
    ("row_stride", "16-byte aligned"),  # rows of 385 elements: no TMA copy
    ("base", "16-byte aligned"),  # views 2 bytes into their rows
    ("scale", "sm_scale > 0"),
    ("dtype", "bfloat16 or torch.float32"),
    ("good", "unsupported device"),  # every layout check passes; the CPU is refused last
])
@pytest.mark.parametrize("route", ["short", "tiled"])
def test_launch_checks_refuse_before_any_launch(route, case, match):
    """What the kernels take is checked before any launch, on any device:
    16-byte aligned rows and (batch, head, row) strides (the tiled bf16
    kernel's TMA copies need both), a positive scale (the wgmma kernels take
    the row max of the raw scores), bf16 or fp32; a CPU tensor that passes
    them all is refused only as a device."""
    q, k, v = _joint_heads(1, 300, 2, extra={"row_stride": 1, "base": 8}.get(case, 0),
                           start=1 if case == "base" else 0)
    if case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    scale = -0.125 if case == "scale" else 0.125
    with pytest.raises(ValueError, match=match):
        fa._launch(route, q, k, v, scale, False)
    assert fa.flash_short.launches == 0 and fa.flash_tiled.launches == 0
