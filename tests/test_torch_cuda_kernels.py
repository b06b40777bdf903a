"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one (the ``cuda`` fixture decides, at run time). The file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: attention 2e-2 in bf16 (the kernel and the plain version
round qkv and P to bf16 at the same points, but sum in another order, so
a rounding can land on the other side), 1e-4 in fp32 (no rounding but the
order of fp32 sums); the backward kernels the same, as a fraction of the
largest magnitude of each of dQ, dK, dV and dx on its own, at inputs of
the trunk's scale (unit-variance qkv, a peaked softmax), the frozen
backward's dx launch alone likewise; head rtol 1e-4
(both sides do all the math in fp32 on the same inputs). Model gradients
against the plain path (``attn_backend="sdpa"``) in the same dtype:
relative L2 error 5e-2 in bf16, 1e-3 in fp32. The W8A8 kernel: max 2e-2
and median 1e-3 of the largest output in bf16, 2e-3 and 1e-4 in fp32 (the
kernel and the plain version take the LayerNorm sums in another order, so
an int8 step of the LN output flips here and there, about 5e-5 of qkv
each; a wrong scale or fold would move the median); its int32
accumulators are exact on both sides. Flash attention: 2e-2 of the
largest output in bf16 (P rounded at the same points), 1e-4 in fp32; the
whole-image model against the plain path 1e-2 (bf16) and 1e-3 (fp32) of
the count. The int8 attention (static and dynamic scales): max 2e-2 and
median 1e-3 of the largest output in both dtypes (a flipped int8 step of
q, k, v or of p moves an output by up to 1/127 of its range). The W8A8
MLP: max 2e-2 / median 1e-3 in bf16, 2e-3 / 1e-4 in fp32 of the output,
and in fp32 the MLP branch (output - x) alone 2e-2 / 1e-3 of its own
largest magnitude. The ``--quant_attn`` model: the kernel and xla modes
within 2e-2 of each other's count (the JAX package's tolerance between
the two), each within 8e-2 of the float-attention plain path's. The LN +
int8 projection alone: max 2e-2 and median 1e-3 of the largest output in
bf16 and for its int8 outputs, 2e-3 and 1e-4 for fp32 outputs; its int8
epilogue equal to the plain version's bits on inputs whose LN outputs lie
away from rounding ties. The MLP's second launch alone (``int8_gemm_residual``)
and the dynamic scale pass alone (``qkv_quant_dynamic``): bit-equal to
their plain versions (exact int32 products, then the same IEEE operations
in the same order on both sides).
"""

import threading

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.ops.fused_attention import (
    attention_bwd,
    attention_bwd_plain,
    fused_ln_mlp_int8,
    fused_ln_qkv_attention,
    fused_ln_qkv_attention_int8,
    fused_qkv_attention,
    ln_bwd_dx,
    ln_bwd_dx_plain,
    ln_mlp_int8_plain,
    ln_proj_int8_plain,
    ln_qkv_attention_int8_dynamic_plain,
    ln_qkv_attention_int8_plain,
    ln_qkv_attention_int8_static_plain,
    ln_qkv_attention_plain,
    ln_qkv_bwd_frozen,
    ln_qkv_bwd_frozen_plain,
    qkv_attention_plain,
)
from clip_ebc_tpu_torch.ops import flash_attention as fa
from clip_ebc_tpu_torch.ops import fused_attention as fatt
from clip_ebc_tpu_torch.ops import quant
from clip_ebc_tpu_torch.ops.fused_head import ebc_head_plain, fused_ebc_head
from clip_ebc_tpu_torch.training.evaluate import Evaluator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 products
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(b, l, d, seed, dev, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.normal(size=(b, l, d))).to(dtype)
    g = t(1.0 + 0.1 * rng.normal(size=d))
    be = t(0.1 * rng.normal(size=d))
    w = t(rng.normal(size=(3 * d, d)) * d**-0.5).to(dtype)  # nn.Linear (out, in)
    bias = t(0.02 * rng.normal(size=3 * d))
    return x, g, be, w, bias


@pytest.mark.parametrize("shape", [
    (4, 229, 768, 12, 229, "bfloat16"),  # flagship block: 1 + 32 VPT + 196 patches, ViT-B
    (4, 229, 768, 12, 200, "bfloat16"),  # masked keys
    (3, 37, 128, 2, 33, "bfloat16"),  # ragged length, narrow width
    (4, 229, 768, 12, 229, "float32"),  # flagship block, fp32 activations (no --amp)
    (3, 37, 128, 2, 33, "float32"),  # ragged length, masked keys, narrow width
    (2, 289, 1024, 16, 289, "bfloat16"),  # ViT-L window block: 1 + 32 VPT + 256 patches
    (2, 289, 1024, 16, 250, "float32"),  # ViT-L, fp32, masked keys
    (3, 37, 1024, 16, 33, "bfloat16"),  # ViT-L width, ragged length (one 128-row item)
    (2, 320, 1024, 16, 320, "bfloat16"),  # ViT-L width at the route's longest window
])
def test_attention_kernel_matches_plain(cuda, shape):
    b, l, d, h, kv_len, dtype = shape
    dtype = getattr(torch, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    args = _attn_inputs(b, l, d, seed=l + kv_len, dev=cuda, dtype=dtype)
    before = fused_ln_qkv_attention.launches
    got = fused_ln_qkv_attention(*args, h, kv_len, (d // h) ** -0.5)
    torch.cuda.synchronize()
    assert fused_ln_qkv_attention.launches == before + 1
    assert got.dtype == dtype
    want = ln_qkv_attention_plain(*args, h, kv_len, (d // h) ** -0.5)
    np.testing.assert_allclose(got[:, :kv_len].float().cpu().numpy(),
                               want[:, :kv_len].float().cpu().numpy(), rtol=tol, atol=tol)


def test_attention_wrapper_raises_instead_of_falling_back(cuda):
    x, g, be, w, bias = _attn_inputs(2, 37, 128, seed=0, dev=cuda)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        fused_ln_qkv_attention(x.half(), g, be, w.half(), bias, 2, 37, 0.125)
    with pytest.raises(ValueError, match="w must be"):
        fused_ln_qkv_attention(x.float(), g, be, w, bias, 2, 37, 0.125)  # bf16 w, fp32 x
    with pytest.raises(ValueError, match="head dim"):
        fused_ln_qkv_attention(x, g, be, w, bias, 4, 37, 0.125)  # dh = 32
    wide = _attn_inputs(1, 37, 1088, seed=0, dev=cuda)  # 17 heads: D > MAX_FUSED_DIM
    with pytest.raises(ValueError, match="D <= 1024"):
        fused_ln_qkv_attention(*wide, 17, 37, 0.125)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction,truncation", [(8, 4), (32, 19)])  # K = 5, K = 20
def test_head_kernel_matches_plain(cuda, dtype, reduction, truncation):
    _, anchors = get_bins_and_anchors(reduction, truncation, "qnrf")
    k = len(anchors)
    rng = np.random.default_rng(k)
    args = (torch.from_numpy(rng.normal(size=(4097, 512)).astype(np.float32))
            .to(cuda, getattr(torch, dtype)),
            torch.from_numpy(rng.normal(size=(k, 512)).astype(np.float32)).to(cuda),
            torch.tensor(1 / 0.07, device=cuda),
            torch.tensor(anchors, dtype=torch.float32, device=cuda))
    before = fused_ebc_head.launches
    got = fused_ebc_head(*args)
    torch.cuda.synchronize()
    assert fused_ebc_head.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ebc_head_plain(*args).cpu().numpy(),
                               rtol=1e-4, atol=1e-6)


def _head_args(cuda, n, c, k, dtype, seed, rows=None):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    if rows is not None:
        feats = rows(feats)
    return (torch.from_numpy(feats).to(cuda, getattr(torch, dtype)),
            torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)).to(cuda),
            torch.tensor(1 / 0.07, device=cuda),
            torch.from_numpy(np.sort(rng.uniform(0, 4, size=k)).astype(np.float32)).to(cuda))


def _zero_and_large_rows(feats):
    feats[0] = 0.0  # the norm's 1e-12 clamp: a uniform softmax
    feats[1::3] *= 1e15  # squares near 1e33: no overflow in fp32, divided out by the norm
    return feats


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,c,k", [
    (1, 512, 5),  # one row: one group, one warp
    (7, 512, 5),  # fewer rows than a warp's group
    (4097, 256, 1),  # one bin; rows not a multiple of a group (8 bf16, 4 fp32)
    (4097, 512, 32),  # the most bins
    (1031, 1024, 5),  # the widest features (16 reads a lane)
    (1031, 1024, 20),  # wide and more than 8 bins
    (1030, 384, 12),  # a width between the instantiations (6 reads a lane)
    (33, 64, 5),  # the narrowest width (one read a lane)
    (109760, 512, 5),  # the flagship image
    (4097, 640, 5),  # RN50x4's embedding
    (4097, 768, 5),  # ViT-L's and RN50x16's
    (140 * 56 * 56 // 4, 1024, 5),  # RN50's (and RN50x64's): 140 windows at reduction 8
])
@pytest.mark.parametrize("rows", ["normal", "zero and large"])
def test_head_kernel_matches_plain_at_edges(cuda, dtype, n, c, k, rows):
    """The head kernel against its plain version at the edges of its row
    groups, widths and bins, with a zero feature row and rows of very large
    magnitude: rtol 1e-4, atol 1e-6 (all math in fp32 on both sides)."""
    edit = _zero_and_large_rows if rows != "normal" else None
    args = _head_args(cuda, n, c, k, dtype, seed=n + c + k, rows=edit)
    before = fused_ebc_head.launches
    got = fused_ebc_head(*args)
    torch.cuda.synchronize()
    assert fused_ebc_head.launches == before + 1
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ebc_head_plain(*args).cpu().numpy(),
                               rtol=1e-4, atol=1e-6)


def test_head_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    for c, k in ((96, 5), (1088, 5), (512, 33)):
        with pytest.raises(ValueError):
            fused_ebc_head(*_head_args(cuda, 8, c, k, "bfloat16", seed=0))


def test_model_takes_both_kernels_and_matches_plain_path(cuda):
    """A whole ViT-B/16 CLIP-EBC forward on 64 px windows in bf16: 12
    attention launches and 1 head launch per forward, and the density of
    the plain path (``attn_backend="sdpa"``, ``fused_head="off"``) within
    the bf16 tolerance of the count."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(0).normal(size=(96, 144, 3)).astype(np.float32)
    counts = {}
    for paths in ({}, {"attn_backend": "sdpa", "fused_head": "off"}):
        model = get_model("clip_vit_b_16", 64, 8, bins, anchors, dtype=torch.bfloat16,
                          num_vpt=32, seed=0, device=cuda, **paths)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=64, stride=32,
                       pad_to_multiple=16)
        ev.text_features()
        fused_ln_qkv_attention.launches = fused_ebc_head.launches = 0
        density = ev.predict_density(image)
        torch.cuda.synchronize()
        assert tuple(density.shape) == (12, 18)
        assert bool(torch.isfinite(density).all())
        fused = not paths
        assert fused_ln_qkv_attention.launches == (12 if fused else 0)
        assert fused_ebc_head.launches == (1 if fused else 0)
        counts[fused] = float(density.sum())
    assert abs(counts[True] - counts[False]) <= 2e-2 * abs(counts[False])


def test_fp32_model_takes_the_attention_kernel(cuda):
    """A default (fp32, no ``--amp``) model on the card takes the kernel in
    every block, ``attn_backend`` "fused" and "auto" alike, and agrees with
    the plain path within the fp32 slice tolerance (1e-3)."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(1).normal(size=(64, 96, 3)).astype(np.float32)
    counts = {}
    for backend in ("fused", "auto", "sdpa"):
        model = get_model("clip_vit_b_16", 64, 8, bins, anchors, dtype=torch.float32,
                          num_vpt=32, seed=0, device=cuda, attn_backend=backend)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=64, stride=32,
                       pad_to_multiple=16)
        ev.text_features()
        fused_ln_qkv_attention.launches = 0
        counts[backend] = ev.predict_count(image)
        torch.cuda.synchronize()
        assert fused_ln_qkv_attention.launches == (0 if backend == "sdpa" else 12)
    for backend in ("fused", "auto"):
        assert abs(counts[backend] - counts["sdpa"]) <= 1e-3 * abs(counts["sdpa"])


def _assert_close_scaled(got, want, tol):
    """Max abs error within ``tol`` x the largest magnitude of ``want``."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(got).all()
    err, limit = float(np.abs(got - want).max()), tol * float(np.abs(want).max())
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("shape", [
    (16, 229, 768, 12, 229, "bfloat16"),  # flagship training step: 8 images x 2 crops
    (16, 229, 768, 12, 200, "bfloat16"),  # masked keys
    (3, 37, 128, 2, 33, "bfloat16"),  # ragged length, narrow width
    (16, 229, 768, 12, 229, "float32"),
    (16, 229, 768, 12, 200, "float32"),  # masked keys: exact zeros
    (3, 37, 128, 2, 33, "float32"),
    (2, 320, 128, 2, 300, "float32"),  # the longest key instantiation
    (1, 229, 768, 12, 229, "bfloat16"),  # fewer (window, head) blocks than SMs
    (2, 256, 128, 2, 256, "bfloat16"),  # every key chunk full
    (2, 320, 128, 2, 320, "bfloat16"),  # the longest length: five query tiles and key slices
    (3, 64, 128, 2, 1, "bfloat16"),  # one valid key
    (2, 229, 128, 2, 65, "bfloat16"),  # one key past a 64-key chunk
    (3, 37, 128, 2, 37, "bfloat16"),  # ragged length, no masked key
    (16, 289, 1024, 16, 289, "bfloat16"),  # a ViT-L training step: 16 heads, 1 + 32 + 256 tokens
    (16, 289, 1024, 16, 250, "bfloat16"),  # ViT-L, masked keys
    (16, 289, 1024, 16, 289, "float32"),  # ViT-L without --amp (the split path's kernel)
])
def test_attention_bwd_kernel_matches_plain(cuda, shape):
    b, l, d, h, kv_len, dtype = shape
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(l + kv_len)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * d)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.normal(size=(b, l, d)).astype(np.float32)).to(cuda, dtype)
    before = attention_bwd.launches
    got = attention_bwd(qkv, g, h, kv_len, (d // h) ** -0.5)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    want = attention_bwd_plain(qkv, g, h, kv_len, (d // h) ** -0.5)
    for i in range(3):  # dQ, dK, dV, each against its own magnitude
        cols = slice(i * d, (i + 1) * d)
        _assert_close_scaled(got[..., cols], want[..., cols], 2e-2 if dtype == torch.bfloat16 else 1e-4)
    assert not got[:, kv_len:, d:].float().abs().sum()  # masked keys: no gradient


@pytest.mark.parametrize("shape", [
    (16, 229, 768, 12, 229),
    (16, 229, 768, 12, 200),
    (3, 37, 128, 2, 33),
    (16, 289, 1024, 16, 289),  # a ViT-L training step
    (16, 289, 1024, 16, 250),
])
def test_ln_qkv_bwd_frozen_kernel_matches_plain(cuda, shape):
    b, l, d, h, kv_len = shape
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=l + kv_len, dev=cuda)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(b, l, d)).astype(np.float32))
    g = g.to(cuda, torch.bfloat16)
    before = ln_qkv_bwd_frozen.launches
    got = ln_qkv_bwd_frozen(x, g, gam, be, w, bias, h, kv_len, (d // h) ** -0.5)
    torch.cuda.synchronize()
    assert ln_qkv_bwd_frozen.launches == before + 1
    want = ln_qkv_bwd_frozen_plain(x, g, gam, be, w, bias, h, kv_len, (d // h) ** -0.5)
    _assert_close_scaled(got, want, 2e-2)


def _ln_bwd_dx_inputs(cuda, m, d, seed, x_mean=0.0, x_std=1.0, dqkv_scale=1.0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(x_mean + x_std * rng.normal(size=(m, d))).to(torch.bfloat16)
    dqkv = t(dqkv_scale * rng.normal(size=(m, 3 * d))).to(torch.bfloat16)
    gam = t(1.0 + 0.1 * rng.normal(size=d))
    w = t(rng.normal(size=(3 * d, d)) * d**-0.5).to(torch.bfloat16)  # nn.Linear (out, in)
    return x, dqkv, gam, w


@pytest.mark.parametrize("d", [128, 384, 512, 640, 768, 896, 1024])
@pytest.mark.parametrize("m", [1, 37, 229, 300, 3664, 4624])
def test_ln_bwd_dx_matches_plain(cuda, m, d):
    """The frozen backward's last launch alone (``ebc_ln_bwd_dx``: dy =
    d_qkv W, then the LayerNorm backward) at one row, ragged row counts
    (37, 229, 300: not multiples of its 128-row tiles) and a training step's
    16 x 229 (ViT-B) and 16 x 289 (ViT-L) rows, at widths that split into
    clusters of 1 to 8 blocks (896 and 1024: 7 and 8 blocks of 128 columns,
    a row of 4 chunks a lane), against ``ln_bwd_dx_plain``: 2e-2 of the
    largest magnitude of dx, as the whole frozen backward is held."""
    args = _ln_bwd_dx_inputs(cuda, m, d, seed=m + d)
    before = ln_bwd_dx.launches
    got = ln_bwd_dx(*args)
    torch.cuda.synchronize()
    assert ln_bwd_dx.launches == before + 1
    assert got.shape == (m, d) and got.dtype == torch.bfloat16
    _assert_close_scaled(got, ln_bwd_dx_plain(*args), 2e-2)


@pytest.mark.parametrize("m,d", [(229, 384), (3664, 768), (4624, 1024)])
@pytest.mark.parametrize("case", ["large mean", "large d_qkv"])
def test_ln_bwd_dx_on_hard_inputs(cuda, m, d, case):
    """Rows of mean 50 +- 0.1 (a one-pass variance, E[x^2] - mu^2, would
    cancel there) and a d_qkv of large magnitude (1e4: dy near 2e4),
    against ``ln_bwd_dx_plain`` within 2e-2 of dx's largest magnitude."""
    kw = {"x_mean": 50.0, "x_std": 0.1} if case == "large mean" else {"dqkv_scale": 1e4}
    args = _ln_bwd_dx_inputs(cuda, m, d, seed=m, **kw)
    got = ln_bwd_dx(*args)
    torch.cuda.synchronize()
    _assert_close_scaled(got, ln_bwd_dx_plain(*args), 2e-2)


def test_ln_bwd_dx_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dqkv, gam, w = _ln_bwd_dx_inputs(cuda, 8, 768, seed=0)
    with pytest.raises(ValueError):
        ln_bwd_dx(x.float(), dqkv, gam, w)
    wide = _ln_bwd_dx_inputs(cuda, 8, 1152, seed=0)  # D > 1024
    with pytest.raises(ValueError):
        ln_bwd_dx(*wide)
    narrow = _ln_bwd_dx_inputs(cuda, 8, 192, seed=0)  # D % 128 != 0
    with pytest.raises(ValueError):
        ln_bwd_dx(*narrow)


def _vpt_step_grads(dev, dtype, **paths):
    """One training forward and backward of a ViT-B/16 CLIP-EBC on eight
    64 px windows: the gradients of the VPT prompts and the decoder."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    model = get_model("clip_vit_b_16", 64, 8, bins, anchors, dtype=dtype, num_vpt=32,
                      seed=0, device=dev, **paths).train()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 64, 64, 3)).astype(np.float32))
    logits, density = model(x.to(dev))
    (logits.float().square().mean() + density.sum()).backward()
    return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def _group_err(got: dict, want: dict, prefixes: tuple) -> float:
    """Relative L2 error over the gradients of the parameters whose name
    starts with one of ``prefixes``, concatenated."""
    names = sorted(n for n in want if n.startswith(prefixes))
    a = torch.cat([got[n].float().flatten() for n in names])
    b = torch.cat([want[n].float().flatten() for n in names])
    return float((a - b).norm() / b.norm())


GROUPS = {"vpt": ("vpt_",), "decoder": ("image_decoder.", "projection.")}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vpt_gradients_flow_through_the_kernels(cuda, dtype):
    """The repair: with grad enabled on the card the trunk's attention
    kernel is differentiable, so every VPT prompt gets a gradient, and it
    agrees with the plain path's. bf16 takes the frozen backward kernel,
    fp32 the split path's attention-backward kernel, 12 each a step.

    Bound, against the plain path in the same dtype: 5e-2 in bf16, 1e-3 in
    fp32. The plain path's own bf16 error against its fp32 gradient is
    printed beside it: at random weights bf16 moves the decoder's
    convolution gradients through train-mode BatchNorm by ~15%, and the
    groups by ~3% at eight windows (~4.5% at two, where the kernel path
    came within 3.8e-2 of the plain path; 1.9e-2 at eight; measured on an
    H100)."""
    dtype = getattr(torch, dtype)
    fused_ln_qkv_attention.launches = attention_bwd.launches = ln_qkv_bwd_frozen.launches = 0
    got = _vpt_step_grads(cuda, dtype)
    torch.cuda.synchronize()
    assert fused_ln_qkv_attention.launches == 12
    if dtype == torch.bfloat16:
        assert ln_qkv_bwd_frozen.launches == 12
    else:
        assert (ln_qkv_bwd_frozen.launches, attention_bwd.launches) == (0, 12)
    want = _vpt_step_grads(cuda, dtype, attn_backend="sdpa")
    assert sorted(got) == sorted(want)
    assert all(got[n] is not None for n in want)
    bf16 = dtype == torch.bfloat16
    ref = _vpt_step_grads(cuda, torch.float32, attn_backend="sdpa") if bf16 else None
    for name, prefixes in GROUPS.items():
        err = _group_err(got, want, prefixes)
        bound = 5e-2 if bf16 else 1e-3
        print(f"{name}: kernel vs plain rel L2 {err:.3e} (bound {bound:g})"
              + (f"; plain bf16 vs plain fp32 {_group_err(want, ref, prefixes):.3e}" if bf16 else ""))
        assert err <= bound, (name, err, bound)


def test_fused_head_refuses_grad(cuda):
    feats = torch.randn(8, 512, device=cuda, requires_grad=True)
    text = torch.randn(5, 512, device=cuda)
    args = (text, torch.tensor(1 / 0.07, device=cuda), torch.arange(5.0, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_ebc_head(feats, *args)
    with torch.no_grad():
        assert fused_ebc_head(feats, *args).shape == (8,)


@pytest.mark.parametrize("shape", [
    (16, 229, 768, 12, 229, "bfloat16"),  # a calibration batch of the flagship
    (16, 229, 768, 12, 200, "bfloat16"),  # masked keys
    (3, 37, 128, 2, 33, "bfloat16"),  # ragged length, narrow width
    (16, 229, 768, 12, 229, "float32"),
    (3, 37, 128, 2, 33, "float32"),
    (16, 229, 768, 12, 200, "float32"),  # masked keys
    (2, 320, 768, 12, 320, "float32"),  # the longest fused length
    (3, 64, 128, 2, 1, "float32"),  # one valid key
    (140, 229, 768, 12, 229, "float32"),  # a window forward's batch
    (16, 289, 1024, 16, 289, "bfloat16"),  # a ViT-L/14 calibration batch
    (16, 289, 1024, 16, 250, "bfloat16"),  # masked keys
    (140, 289, 1024, 16, 289, "bfloat16"),  # a ViT-L/14 --quant int8 window forward
    (16, 289, 1024, 16, 289, "float32"),
    (16, 289, 1024, 16, 250, "float32"),
])
def test_qkv_attention_kernel_matches_plain_and_differentiates(cuda, shape):
    b, l, d, h, kv_len, dtype = shape
    dtype = getattr(torch, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    rng = np.random.default_rng(l + kv_len)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * d)).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.normal(size=(b, l, d)).astype(np.float32)).to(cuda, dtype)
    sm = (d // h) ** -0.5
    before, before_bwd = fused_qkv_attention.launches, attention_bwd.launches
    leaf = qkv.clone().requires_grad_()
    got = fused_qkv_attention(leaf, h, kv_len, sm)
    got.backward(g)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert attention_bwd.launches == before_bwd + 1  # the backward is the attention_bwd kernel
    assert got.dtype == dtype
    want = qkv_attention_plain(qkv, h, kv_len, sm)
    np.testing.assert_allclose(got[:, :kv_len].detach().float().cpu().numpy(),
                               want[:, :kv_len].float().cpu().numpy(), rtol=tol, atol=tol)
    want_grad = attention_bwd_plain(qkv, g, h, kv_len, sm)
    for i in range(3):
        cols = slice(i * d, (i + 1) * d)
        _assert_close_scaled(leaf.grad[..., cols], want_grad[..., cols], tol)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1), h, kv_len, sm)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        fused_qkv_attention(qkv.half(), h, kv_len, sm)


def _in_new_thread(fn):
    """``fn()`` run on a new host thread (one that has made no CUDA call
    yet), its result or its exception handed back."""
    out = {}

    def run():
        try:
            out["value"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - re-raised on this thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.mark.parametrize("entry", ["attention_bwd", "fused_ln_qkv_attention", "ln_bwd_dx",
                                   "int8_attention", "flash_tiled", "autograd"])
def test_tma_kernels_launch_from_a_new_thread(cuda, entry):
    """Every launch that encodes a TMA tensor map, made from a new host
    thread, gives what the same launch gives on this one. Such a thread has
    no current CUDA context until it makes a CUDA call, and the encode
    failed there with error 1 (``cudaErrorInvalidValue``): the bf16
    attention backward, when a backward began with it on autograd's device
    thread, as it did in a filtered run of
    ``test_qkv_attention_kernel_matches_plain_and_differentiates``
    (``csrc/common.cuh`` ``encode_tiled`` now makes the tensor's device
    current and encodes again). ``autograd``: the masked attention's
    backward called through autograd from the new thread."""
    b, l, d, h, kv = 3, 37, 128, 2, 33
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=7, dev=cuda)
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * d)).astype(np.float32)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(b, l, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    sm = (d // h) ** -0.5
    if entry == "attention_bwd":
        fn = lambda: attention_bwd(qkv, g, h, kv, sm)  # noqa: E731
    elif entry == "fused_ln_qkv_attention":
        fn = lambda: fused_ln_qkv_attention(x, gam, be, w, bias, h, kv, sm)  # noqa: E731
    elif entry == "ln_bwd_dx":
        fn = lambda: ln_bwd_dx(x, qkv, gam, w)  # noqa: E731
    elif entry == "int8_attention":
        xi, gi, bi, wi, biasi, act, aq = _int8_attn_inputs(b, l, d, kv, cuda, torch.bfloat16)
        fn = lambda: fused_ln_qkv_attention_int8(xi, gi, bi, wi, biasi, act, h, kv, sm,  # noqa: E731
                                                 attn_scales=aq)
    elif entry == "flash_tiled":
        q, k, v = _flash_inputs(1, 2, 1100, 9, cuda, torch.bfloat16)
        fn = lambda: fa.flash_tiled(q, k, v, 0.125)  # noqa: E731
    else:
        def fn():
            leaf = qkv.clone().requires_grad_()
            fused_qkv_attention(leaf, h, kv, sm).backward(g)
            return leaf.grad
    got = _in_new_thread(fn)
    want = fn()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _max_median(got, want):
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    return float(diff.max()) / top, float(diff.median()) / top


@pytest.mark.parametrize("shape", [
    (8, 229, 768, 12, 229, "bfloat16"),  # flagship block
    (8, 229, 768, 12, 200, "bfloat16"),  # masked keys
    (3, 37, 128, 2, 33, "bfloat16"),  # ragged length, one W tile deep
    (8, 229, 768, 12, 229, "float32"),  # fp32 activations (no --amp)
    (3, 37, 128, 2, 33, "float32"),
])
def test_int8_attention_kernel_matches_plain(cuda, shape):
    b, l, d, h, kv_len, dtype = shape
    dtype = getattr(torch, dtype)
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=l + kv_len, dev=cuda, dtype=torch.float32)
    x = x.to(dtype)
    y = torch.nn.functional.layer_norm(x.float(), (d,), gam, be)
    act_scale = y.abs().amax() / 127.0  # what a calibration records
    sm = (d // h) ** -0.5
    before = fused_ln_qkv_attention_int8.launches
    got = fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, h, kv_len, sm)
    torch.cuda.synchronize()
    assert fused_ln_qkv_attention_int8.launches == before + 1
    assert got.dtype == dtype
    w_q, s_col = quant.quantize_weight(w)
    want = ln_qkv_attention_int8_plain(x, gam, be, w_q, s_col, bias, act_scale, h, kv_len, sm)
    err, med = _max_median(got[:, :kv_len], want[:, :kv_len])
    max_tol, med_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (2e-3, 1e-4)
    assert err <= max_tol and med <= med_tol, (err, med)
    # a prequantized weight gives the same bits; unsupported tensors raise
    again = fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, h, kv_len, sm,
                                        quantized=(w_q, s_col))
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        fused_ln_qkv_attention_int8(x.half(), gam, be, w, bias, act_scale, h, kv_len, sm)
    with pytest.raises(ValueError, match="w_q must be"):
        fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, h, kv_len, sm,
                                    quantized=(w_q.int(), s_col))


# (B, L, kv_len) of the bf16 attention body at the width of ViT-B (D = 768,
# 12 heads): a window forward, a calibration batch with masked keys (its
# query tiles in two parts a pair), one valid key, the longest fused length
# (two sweeps over three key chunks) and a length that is no multiple of 16
BF16_BODY_SHAPES = [(140, 229, 229), (16, 229, 200), (3, 64, 1), (2, 320, 320), (2, 77, 77)]


@pytest.mark.parametrize("b,l,kv_len", BF16_BODY_SHAPES)
@pytest.mark.parametrize("entry", ["qkv", "ln_qkv", "ln_qkv_int8"])
def test_bf16_attention_body_through_each_entry(cuda, entry, b, l, kv_len):
    """The wgmma attention body, through each entry that launches it (row 3:
    ``fused_qkv_attention``; row 2: ``fused_ln_qkv_attention``; row 2b:
    ``fused_ln_qkv_attention_int8`` without an int8 attention), against the
    entry's plain version: max 2e-2 and median 1e-3 of the largest output
    (P rounded to bf16 unnormalized and O divided by the fp32 row sum on
    both sides; sums in another order)."""
    d, h = 768, 12
    sm = (d // h) ** -0.5
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=b + l + kv_len, dev=cuda)
    if entry == "qkv":
        qkv = torch.randn(b, l, 3 * d, generator=torch.Generator(device=cuda).manual_seed(l),
                          device=cuda).to(torch.bfloat16)
        fn, counter = fused_qkv_attention, fused_qkv_attention
        args, want = (qkv,), qkv_attention_plain(qkv, h, kv_len, sm)
    elif entry == "ln_qkv":
        fn, counter = fused_ln_qkv_attention, fused_ln_qkv_attention
        args, want = (x, gam, be, w, bias), ln_qkv_attention_plain(x, gam, be, w, bias, h, kv_len, sm)
    else:
        act_scale = torch.nn.functional.layer_norm(x.float(), (d,), gam, be).abs().amax() / 127.0
        fn, counter = fused_ln_qkv_attention_int8, fused_ln_qkv_attention_int8
        w_q, s_col = quant.quantize_weight(w.float())
        args = (x, gam, be, w.float(), bias, act_scale)
        want = ln_qkv_attention_int8_plain(x, gam, be, w_q, s_col, bias, act_scale, h, kv_len, sm)
    before = counter.launches
    with torch.no_grad():
        got = fn(*args, h, kv_len, sm)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    err, med = _max_median(got[:, :kv_len], want[:, :kv_len])
    assert err <= 2e-2 and med <= 1e-3, (err, med)
    with pytest.raises(ValueError, match="sm_scale > 0"):
        fn(*args, h, kv_len, -sm)


def test_int8_products_are_exact_on_the_card(cuda):
    """``int_mm`` and both convolution routes give the int32 accumulators of
    the plain integer product and convolution, computed on the CPU."""
    rng = np.random.default_rng(0)
    for m, k, n in ((3664, 768, 2304), (5, 3072, 768), (784, 6912, 768)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
        assert torch.equal(quant.int_mm(a.to(cuda), b.to(cuda)).cpu(), a.int() @ b.int().T)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(torch.zeros(32, 12, dtype=torch.int8, device=cuda),
                     torch.zeros(8, 12, dtype=torch.int8, device=cuda))
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 14, 14, 768)).astype(np.int8)).permute(0, 3, 1, 2)
    w_q = torch.from_numpy(rng.integers(-127, 128, (768, 768, 3, 3)).astype(np.int8))
    want = quant.int8_conv2d_plain(x_q, w_q, (1, 1), (1, 1), (1, 1))
    for route in (quant.int8_conv2d_im2col, quant.int8_conv2d_shifted):
        assert torch.equal(route(x_q.to(cuda), w_q.to(cuda), (1, 1), (1, 1), (1, 1)).cpu(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_model_takes_both_kernels_and_matches_plain_path(cuda, dtype):
    """A whole W8A8 ViT-B/16 CLIP-EBC on 64 px windows: a calibration pass
    and a dynamic forward launch ``fused_qkv_attention`` 12 times, a static
    forward ``fused_ln_qkv_attention_int8`` 12 times, and on one set of
    scales the static count is within 1e-2 of the plain path's
    (``attn_backend="sdpa"``, ``fused_head="off"``)."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(0).normal(size=(96, 144, 3)).astype(np.float32)
    windows = torch.from_numpy(image[None, :64, :64]).to(cuda)
    kw = dict(dtype=getattr(torch, dtype), num_vpt=32, seed=0, device=cuda, quant_int8=True)
    counters = (fused_ln_qkv_attention_int8, fused_qkv_attention, fused_ln_qkv_attention)

    def launches(fn):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches for c in counters)

    dyn = get_model("clip_vit_b_16", 64, 8, bins, anchors, **kw)
    state, n = launches(lambda: quant.calibrate_int8(dyn, [windows]))
    assert n == (0, 12, 0)
    with torch.no_grad():
        _, n = launches(lambda: dyn(windows))
    assert n == (0, 12, 0)
    counts = {}
    for paths in ({}, {"attn_backend": "sdpa", "fused_head": "off"}):
        model = get_model("clip_vit_b_16", 64, 8, bins, anchors, quant_mode="static", **kw, **paths)
        quant.load_quant_state(model, state)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=64, stride=32,
                       pad_to_multiple=16)
        ev.text_features()
        density, n = launches(lambda: ev.predict_density(image))
        assert n == ((12, 0, 0) if not paths else (0, 0, 0))
        assert bool(torch.isfinite(density).all())
        counts[not paths] = float(density.sum())
    assert abs(counts[True] - counts[False]) <= 1e-2 * abs(counts[False])


def _int8_attn_inputs(b, l, d, kv_len, dev, dtype):
    """Block inputs with the scales a calibration records: the LN output's
    max-abs / 127, and each of q, k, v's."""
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=l + kv_len + 1, dev=dev, dtype=torch.float32)
    x = x.to(dtype)
    y = torch.nn.functional.layer_norm(x.float(), (d,), gam, be)
    act_scale = y.abs().amax() / 127.0
    aq = (y @ w.T + bias).reshape(-1, 3, d).abs().amax((0, 2)) / 127.0
    return x, gam, be, w, bias, act_scale, aq


INT8_ATTN_SHAPES = [
    (8, 229, 768, 12, 229, "bfloat16"),  # flagship block
    (8, 229, 768, 12, 200, "bfloat16"),  # masked keys
    (3, 37, 256, 4, 33, "bfloat16"),  # ragged length and batch, narrow width
    (8, 229, 768, 12, 229, "float32"),  # fp32 activations (no --amp)
    (3, 300, 256, 4, 290, "float32"),  # five key chunks
    (2, 357, 768, 12, 357, "bfloat16"),  # --window_size 288
    (2, 433, 768, 12, 400, "bfloat16"),  # --window_size 320, masked keys
    (2, 433, 768, 12, 433, "float32"),
    (3, 512, 256, 4, 500, "float32"),  # the longest key instantiation
    (8, 289, 1024, 16, 289, "bfloat16"),  # a ViT-L window block: 16 heads, D = 1024
    (8, 289, 1024, 16, 250, "float32"),  # ViT-L, fp32, masked keys
    (2, 433, 1024, 16, 433, "bfloat16"),  # ViT-L at 433 tokens
]


@pytest.mark.parametrize("shape", INT8_ATTN_SHAPES)
@pytest.mark.parametrize("branch", ["static", "dynamic"])
def test_int8_attention_branches_match_plain(cuda, shape, branch):
    """The fully int8 attention: calibrated ``attn_scales`` (the projection
    writes int8 q, k, v) or dynamic ``quant_attn`` scales (the float
    projection, the scale pass, then the same int8 attention kernel)."""
    b, l, d, h, kv_len, dtype = shape
    dtype = getattr(torch, dtype)
    x, gam, be, w, bias, act_scale, aq = _int8_attn_inputs(b, l, d, kv_len, cuda, dtype)
    sm = (d // h) ** -0.5
    w_q, s_col = quant.quantize_weight(w)
    counter = "launches_" + branch
    before = (getattr(fused_ln_qkv_attention_int8, counter), fused_ln_qkv_attention_int8.launches)
    kw = dict(attn_scales=aq) if branch == "static" else dict(quant_attn=True)
    got = fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, h, kv_len, sm, **kw)
    torch.cuda.synchronize()
    assert (getattr(fused_ln_qkv_attention_int8, counter), fused_ln_qkv_attention_int8.launches) == (
        before[0] + 1, before[1])
    assert got.dtype == dtype
    if branch == "static":
        want = ln_qkv_attention_int8_static_plain(x, gam, be, w_q, s_col, bias, act_scale, aq, h,
                                                  kv_len, sm)
    else:
        want = ln_qkv_attention_int8_dynamic_plain(x, gam, be, w_q, s_col, bias, act_scale, h,
                                                   kv_len, sm, block_b=2 if dtype == torch.bfloat16 else 1)
    err, med = _max_median(got[:, :kv_len], want[:, :kv_len])
    assert err <= 2e-2 and med <= 1e-3, (err, med)


def test_int8_attention_wrapper_raises_instead_of_falling_back(cuda):
    x, gam, be, w, bias, act_scale, aq = _int8_attn_inputs(2, 520, 256, 520, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="L <= 512"):
        fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, 4, 520, 0.125, attn_scales=aq)
    # the float attention keeps its 320 keys
    with pytest.raises(ValueError, match="L <= 320"):
        fused_ln_qkv_attention_int8(x[:, :400], gam, be, w, bias, act_scale, 4, 400, 0.125)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        fused_ln_qkv_attention_int8(x[:, :64].half(), gam, be, w, bias, act_scale, 4, 64, 0.125,
                                    quant_attn=True)


def _mlp_inputs(b, l, d, hidden, dev, dtype, seed=11):
    """x, the LN parameters, torch-layout weights at a trained CLIP MLP's
    scale, and the scales a calibration records (the LN output's and the
    GELU output's max-abs / 127)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, l, d, generator=g, device=dev).to(dtype)
    gam = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    be = 0.1 * torch.randn(d, generator=g, device=dev)
    w_fc = 0.06 * torch.randn(hidden, d, generator=g, device=dev)
    b_fc = 0.02 * torch.randn(hidden, generator=g, device=dev)
    w_pj = 0.03 * torch.randn(d, hidden, generator=g, device=dev)
    b_pj = 0.02 * torch.randn(d, generator=g, device=dev)
    y = torch.nn.functional.layer_norm(x.float(), (d,), gam, be)
    hh = y @ w_fc.T + b_fc
    act1 = y.abs().amax() / 127.0
    act2 = (hh * torch.sigmoid(1.702 * hh)).abs().amax() / 127.0
    return x, gam, be, w_fc, b_fc, act1, w_pj, b_pj, act2


def _proj_inputs(b, l, d, n, dev, dtype, seed=21):
    """x, the LN parameters, a quantized torch-layout weight with its
    dequantize factor and bias, and the LN output's calibrated scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, l, d, generator=g, device=dev).to(dtype)
    gam = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    be = 0.1 * torch.randn(d, generator=g, device=dev)
    w_q, s_col = quant.quantize_weight(torch.randn(n, d, generator=g, device=dev) * d**-0.5)
    bias = 0.02 * torch.randn(n, generator=g, device=dev)
    act = torch.nn.functional.layer_norm(x.float(), (d,), gam, be).abs().amax() / 127.0
    return x, gam, be, w_q, s_col * act, bias, act


def _proj_kernel(x, gam, be, w_q, sw, bias, act, epilogue, act_out=None):
    """The LN + int8 projection's launch alone through the C entries that
    run it: the QKV projection's (qkv in x's dtype, or int8 q, k, v) for N =
    3D, the MLP's first launch for the GELU epilogue (its int8 hidden)."""
    b, l, d = x.shape
    n, dev, f32 = w_q.shape[0], x.device, int(x.dtype == torch.float32)
    inv = torch.stack([1.0 / act, 1.0 / act_out if act_out is not None else act]).reshape(2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if epilogue == "gelu_int8":
        hq = torch.empty(b, l, n, dtype=torch.int8, device=dev)
        rc = fatt._entry("fused_mlp_int8", "ebc_ln_proj_gelu_int8")(
            x.data_ptr(), gam.data_ptr(), be.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), inv[0:1].data_ptr(), inv[1:2].data_ptr(), hq.data_ptr(), b * l, d, n, 1, f32,
            1e-5, stream)
        assert rc == 0
        return hq
    assert n == 3 * d
    name = "ebc_ln_qkv_proj_int8" if epilogue == "float" else "ebc_ln_qkv_proj_int8_q"
    got = torch.empty(b, l, n, dtype=x.dtype if epilogue == "float" else torch.int8, device=dev)
    rc = fatt._entry("fused_attention_int8", name)(
        x.data_ptr(), gam.data_ptr(), be.data_ptr(), w_q.data_ptr(), sw.data_ptr(), bias.data_ptr(),
        inv[0:1].data_ptr(), got.data_ptr(), b * l, d, f32, 1e-5, stream)
    assert rc == 0
    return got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("epilogue", ["float", "int8", "gelu_int8"])
@pytest.mark.parametrize("d", [128, 256, 768, 896, 1024])
@pytest.mark.parametrize("b,l", [(3, 37), (16, 229), (140, 229)])
def test_int8_projection_matches_plain(cuda, b, l, d, epilogue, dtype):
    """The LN + int8 projection alone (csrc/int8_proj.cuh) with each
    epilogue: N = 3D (the QKV projection; its int8 epilogue with q, k, v
    scales folded in) or 4D (the MLP's fc with the GELU). The kernel and
    the plain version sum the LayerNorm in another order, so an LN output
    can land one int8 step apart; in fp32 that one step moves a row's
    outputs by up to sw x 127, which at D = 128 is more than 2e-3 of the
    largest output: the max limit allows two such steps where they exceed
    it (the median, at 1e-4, still catches a wrong scale or fold)."""
    dtype = getattr(torch, dtype)
    n = 4 * d if epilogue == "gelu_int8" else 3 * d
    x, gam, be, w_q, sw, bias, act = _proj_inputs(b, l, d, n, cuda, dtype)
    act_out = None
    if epilogue == "int8":  # v in the int8 domain, as the static attention folds it
        sw, bias = sw * 40.0, bias * 40.0
    elif epilogue == "gelu_int8":
        h = ln_proj_int8_plain(x, gam, be, w_q, sw, bias, act, "float").float()
        act_out = (h * torch.sigmoid(1.702 * h)).abs().amax() / 127.0
    got = _proj_kernel(x, gam, be, w_q, sw, bias, act, epilogue, act_out)
    torch.cuda.synchronize()
    assert got.shape == (b, l, n) and got.dtype == (dtype if epilogue == "float" else torch.int8)
    want = ln_proj_int8_plain(x, gam, be, w_q, sw, bias, act, epilogue, act_out)
    err, med = _max_median(got, want)
    max_tol, med_tol = (2e-3, 1e-4) if dtype == torch.float32 and epilogue == "float" else (2e-2, 1e-3)
    if epilogue == "float":
        max_tol = max(max_tol, 2 * 127 * float(sw.max()) / float(want.float().abs().max()))
    assert err <= max_tol and med <= med_tol, (err, med)


def _untied_ln_inputs(b, l, d, n, dev, dtype, seed=5):
    """Inputs whose LN outputs, quantized, lie at least 0.02 of a step from
    a rounding tie however the LayerNorm's sums are ordered: each row is mu
    +- s (half the columns each way, so its mean and variance are exact),
    and a column's beta is drawn again until all its (row kind, sign)
    values clear the ties."""
    rng = np.random.default_rng(seed)
    kinds = [(mu, s) for mu in (-1.0, 0.0, 0.5, 1.5) for s in (0.5, 1.0, 2.0)]
    kind = rng.integers(0, len(kinds), b * l)
    signs = np.stack([rng.permutation(np.repeat([1.0, -1.0], d // 2)) for _ in range(b * l)])
    x = np.array([kinds[k][0] for k in kind])[:, None] + signs * np.array([kinds[k][1] for k in kind])[:, None]
    gam = 1.0 + 0.1 * rng.normal(size=d)
    be = 0.1 * rng.normal(size=d)
    rstd = np.array([1.0 / np.sqrt(s * s + 1e-5) for _, s in kinds])
    ys = np.concatenate([np.outer(sg * np.array([s for _, s in kinds]) * rstd, gam) for sg in (1.0, -1.0)])
    act = float(np.abs(ys + be).max()) / 120.0
    for c in range(d):
        while True:
            t = (ys[:, c] + be[c]) / act
            if np.all(np.abs(t - np.floor(t) - 0.5) > 0.02):
                break
            be[c] = 0.1 * rng.normal()
    w_q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    xhat = (x - x.mean(1, keepdims=True)) / np.sqrt(x.var(1, keepdims=True) + 1e-5)
    acc = np.clip(np.round((xhat * gam + be) / act), -127, 127) @ w_q.T.astype(np.float64)
    sw = rng.uniform(0.5, 1.5, size=n) * 30.0 / acc.std(0)  # v of a few tens: most outputs unclipped
    bias = 0.5 * rng.normal(size=n)
    f = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    return (f(x.reshape(b, l, d)).to(dtype), f(gam), f(be), torch.from_numpy(w_q).to(dev), f(sw),
            f(bias), f(act))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_projection_int8_epilogue_is_exact(cuda, dtype):
    """Away from rounding ties of the LN output the int8 epilogue equals
    its plain version bit for bit: the int32 accumulators are exact and the
    dequantize multiply, the bias add and the rounding are the same IEEE
    operations on both sides."""
    dtype = getattr(torch, dtype)
    args = _untied_ln_inputs(16, 229, 768, 2304, cuda, dtype)
    got = _proj_kernel(*args, "int8")
    want = ln_proj_int8_plain(*args, "int8")
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and int((want == 127).sum() + (want == -127).sum()) < want.numel() // 10
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [768, 1024])
def test_int8_projection_is_exact_at_the_largest_sums(cuda, d, dtype):
    """Rows of +-1 (half each way: LN outputs +-1 / sqrt(1 + eps), all
    quantized to +-127) against weight rows of +-127 with the same signs:
    accumulators up to D x 127 x 127 (16,516,096 at D = 1024, just under
    2^24, where an fp32 still holds every integer). The float epilogue
    equals its plain version bit for bit, so every int32 sum reached the
    float multiply exact."""
    dtype = getattr(torch, dtype)
    rng = np.random.default_rng(d)
    m, n = 128, 3 * d
    signs = np.stack([rng.permutation(np.repeat([1.0, -1.0], d // 2)) for _ in range(m)])
    w_q = (127 * signs[np.arange(n) % m] * np.where(np.arange(n) // m % 2, -1, 1)[:, None]).astype(np.int8)
    x = torch.from_numpy(signs.reshape(2, m // 2, d).astype(np.float32)).to(cuda, dtype)
    gam, be = torch.ones(d, device=cuda), torch.zeros(d, device=cuda)
    act = torch.tensor(1.0 / np.sqrt(1.0 + 1e-5) / 127.0, dtype=torch.float32, device=cuda)
    sw = torch.full((n,), 1e-6, device=cuda)
    bias = torch.zeros(n, device=cuda)
    args = (x, gam, be, torch.from_numpy(w_q).to(cuda), sw, bias, act)
    got = _proj_kernel(*args, "float")
    want = ln_proj_int8_plain(*args, "float")
    torch.cuda.synchronize()
    assert float(want.float().abs().max()) == pytest.approx(d * 127 * 127 * 1e-6, rel=1e-2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [
    (8, 229, 768, 3072, True, "bfloat16"),  # flagship block's MLP
    (8, 229, 768, 3072, True, "float32"),
    (3, 37, 256, 1024, False, "float32"),  # ragged rows, narrow width, the tanh GELU
    (3, 37, 256, 1024, False, "bfloat16"),
])
def test_mlp_int8_kernel_matches_plain(cuda, shape):
    b, l, d, hidden, quick, dtype = shape
    dtype = getattr(torch, dtype)
    args = _mlp_inputs(b, l, d, hidden, cuda, dtype)
    before = fused_ln_mlp_int8.launches
    got = fused_ln_mlp_int8(*args, quick_gelu=quick)
    torch.cuda.synchronize()
    assert fused_ln_mlp_int8.launches == before + 1 and got.dtype == dtype
    x, gam, be, w_fc, b_fc, act1, w_pj, b_pj, act2 = args
    want = ln_mlp_int8_plain(x, gam, be, *quant.quantize_weight(w_fc), b_fc, act1,
                             *quant.quantize_weight(w_pj), b_pj, act2, quick)
    err, med = _max_median(got, want)
    max_tol, med_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (2e-3, 1e-4)
    assert err <= max_tol and med <= med_tol, (err, med)
    if dtype == torch.float32:
        err, med = _max_median(got - x, want - x)
        assert err <= 2e-2 and med <= 1e-3, (err, med)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_ln_mlp_int8(x[..., :96].contiguous(), gam[:96], be[:96], w_fc[:, :96], b_fc, act1,
                          w_pj[:96], b_pj[:96], act2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_int8_kernel_matches_plain_at_vit_l_width(cuda, dtype):
    """A ViT-L block's W8A8 MLP (8 windows x 289 tokens, D = 1024, hidden
    4096) against its plain version: max 2e-2 and median 1e-3 (bf16) or
    1e-4 (fp32) of the largest output, and in fp32 the MLP branch (output
    - x) within 5e-2 and 1e-3 of its own, as ``chip_smoke.py``
    ``phase_mlp_int8`` holds the flagship's: the kernel and the plain
    version sum the LayerNorm in another order, and an LN output one int8
    step apart moves all 4096 hidden units of its row (one such step is
    4.6e-3 of the largest fp32 output here, on an H100), while a wrong
    scale or fold moves every output (the median)."""
    dtype = getattr(torch, dtype)
    args = _mlp_inputs(8, 289, 1024, 4096, cuda, dtype)
    before = fused_ln_mlp_int8.launches
    got = fused_ln_mlp_int8(*args)
    torch.cuda.synchronize()
    assert fused_ln_mlp_int8.launches == before + 1 and got.dtype == dtype
    x, gam, be, w_fc, b_fc, act1, w_pj, b_pj, act2 = args
    want = ln_mlp_int8_plain(x, gam, be, *quant.quantize_weight(w_fc), b_fc, act1,
                             *quant.quantize_weight(w_pj), b_pj, act2, True)
    err, med = _max_median(got, want)
    assert err <= 2e-2 and med <= (1e-3 if dtype == torch.bfloat16 else 1e-4), (err, med)
    if dtype == torch.float32:
        err, med = _max_median(got - x, want - x)
        assert err <= 5e-2 and med <= 1e-3, (err, med)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,d,hidden", [(140 * 229, 768, 3072), (3 * 37, 256, 1024), (300, 640, 2560),
                                        (140 * 289, 1024, 4096), (300, 1024, 4096)])
def test_int8_gemm_residual_matches_plain_bitwise(cuda, m, d, hidden, dtype):
    """The MLP's second launch alone: x + (hq . W_pj^T * sw2 + b_proj) at the
    flagship block (D = 768: persistent blocks on 128-row tiles of 192
    columns in bf16, 128 in fp32), ragged rows at D = 256 (tiles of 128
    columns) and D = 640 (5 tiles of 128), equal to
    ``int8_gemm_residual_plain`` bit for bit; one launch counted."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(m + d)
    hq = torch.randint(-127, 128, (m, hidden), generator=g, device=cuda, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (d, hidden), generator=g, device=cuda, dtype=torch.int8)
    sw2 = torch.rand(d, generator=g, device=cuda) * 2e-5
    b_pj = 0.02 * torch.randn(d, generator=g, device=cuda)
    x = torch.randn(m, d, generator=g, device=cuda).to(dtype)
    before = fatt.int8_gemm_residual.launches
    got = fatt.int8_gemm_residual(hq, w_q, sw2, b_pj, x)
    torch.cuda.synchronize()
    assert fatt.int8_gemm_residual.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, fatt.int8_gemm_residual_plain(hq, w_q, sw2, b_pj, x))
    with pytest.raises(ValueError, match="multiple of 128"):
        fatt.int8_gemm_residual(hq[:, :96].contiguous(), w_q[:, :96].contiguous(), sw2, b_pj, x)


def _scale_pass_qkv(b, l, dtype, dev, seed):
    """A float qkv (B, L, 3D) at ViT-B width whose heads differ in magnitude."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mag = (0.5 + torch.rand(36, generator=g, device=dev)).repeat_interleave(64)
    return (torch.randn(b, l, 3 * 768, generator=g, device=dev) * mag).to(dtype)


@pytest.mark.parametrize("dtype,block_b", [("bfloat16", 2), ("float32", 1)])
@pytest.mark.parametrize("b,l", [(140, 229), (70, 433), (3, 512), (5, 64)])
def test_qkv_quant_dynamic_matches_plain_bitwise(cuda, b, l, dtype, block_b):
    """The dynamic scale pass alone at the flagship windows, --window_size
    320, the longest window and an odd batch (a short last tile in bf16):
    qkv_q and the scales equal ``qkv_quant_dynamic_plain``'s bit for bit;
    one launch counted."""
    qkv = _scale_pass_qkv(b, l, getattr(torch, dtype), cuda, b * l)
    before = fatt.qkv_quant_dynamic.launches
    got_q, got_s = fatt.qkv_quant_dynamic(qkv, 12, block_b)
    torch.cuda.synchronize()
    assert fatt.qkv_quant_dynamic.launches == before + 1
    want_q, want_s = fatt.qkv_quant_dynamic_plain(qkv, 12, block_b)
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,block_b", [(11, 5), (9, 8)])
def test_qkv_quant_dynamic_tiles_wider_than_a_cluster(cuda, b, block_b, dtype):
    """Tiles of more than 4 windows: a block takes every 4th window of its
    tile and reads all but the last again to quantize them; bit-equal to
    the plain version. The wrapper refuses what the kernel does not take."""
    qkv = _scale_pass_qkv(b, 77, getattr(torch, dtype), cuda, b)
    got_q, got_s = fatt.qkv_quant_dynamic(qkv, 12, block_b)
    torch.cuda.synchronize()
    want_q, want_s = fatt.qkv_quant_dynamic_plain(qkv, 12, block_b)
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)
    with pytest.raises(ValueError, match="L <= 512"):
        fatt.qkv_quant_dynamic(torch.zeros(1, 513, 3 * 768, dtype=qkv.dtype, device=cuda), 12, 2)
    with pytest.raises(ValueError, match="block_b"):
        fatt.qkv_quant_dynamic(qkv, 12, 0)


@pytest.mark.parametrize("dtype,block_b", [("bfloat16", 2), ("float32", 1)])
@pytest.mark.parametrize("b,l", [(140, 289), (70, 433), (5, 64)])
def test_qkv_quant_dynamic_matches_plain_bitwise_at_vit_l_width(cuda, b, l, dtype, block_b):
    """The dynamic scale pass at ViT-L's 16 heads (D = 1024: 8 head pairs
    a part) at its windows of 289 tokens, of 433 and an odd batch: bit-equal
    to ``qkv_quant_dynamic_plain``."""
    g = torch.Generator(device=cuda).manual_seed(b * l)
    mag = (0.5 + torch.rand(48, generator=g, device=cuda)).repeat_interleave(64)
    qkv = (torch.randn(b, l, 3 * 1024, generator=g, device=cuda) * mag).to(getattr(torch, dtype))
    got_q, got_s = fatt.qkv_quant_dynamic(qkv, 16, block_b)
    torch.cuda.synchronize()
    want_q, want_s = fatt.qkv_quant_dynamic_plain(qkv, 16, block_b)
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)


def test_quant_attn_model_takes_the_int8_attention(cuda):
    """A W8A8 ViT-B/16 CLIP-EBC with ``quant_attn``: on 64 px windows a
    static forward with ``True`` launches the int8 attention 12 times and
    the float attention never; ``"xla"`` launches neither. The two modes'
    counts are within 2e-2 of each other, and each within 8e-2 (the JAX
    package's int8 tolerance) of the plain path's (``attn_backend="sdpa"``,
    ``fused_head="off"``, whose blocks keep the float attention there, as
    in the JAX package)."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(0).normal(size=(96, 144, 3)).astype(np.float32)
    windows = torch.from_numpy(image[None, :64, :64]).to(cuda)
    kw = dict(dtype=torch.bfloat16, num_vpt=32, seed=0, device=cuda, quant_int8=True)
    state = quant.calibrate_int8(get_model("clip_vit_b_16", 64, 8, bins, anchors, quant_attn=True, **kw),
                                 [windows])
    counts = {}
    for name, extra in (("kernel", dict(quant_attn=True)), ("xla", dict(quant_attn="xla")),
                        ("plain", dict(quant_attn=True, attn_backend="sdpa", fused_head="off"))):
        model = get_model("clip_vit_b_16", 64, 8, bins, anchors, quant_mode="static", **kw, **extra)
        quant.load_quant_state(model, state)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=64, stride=32,
                       pad_to_multiple=16)
        ev.text_features()
        fused_ln_qkv_attention_int8.launches = fused_ln_qkv_attention_int8.launches_static = 0
        density = ev.predict_density(image)
        torch.cuda.synchronize()
        n = (fused_ln_qkv_attention_int8.launches_static, fused_ln_qkv_attention_int8.launches)
        assert n == ((12, 0) if name == "kernel" else (0, 0)), (name, n)
        assert bool(torch.isfinite(density).all())
        counts[name] = float(density.sum())
    assert abs(counts["kernel"] - counts["xla"]) <= 2e-2 * abs(counts["kernel"])
    for name in ("kernel", "xla"):
        assert abs(counts[name] - counts["plain"]) <= 8e-2 * abs(counts["plain"]), counts


def _flash_inputs(b, h, l, seed, dev, dtype):
    """q, k, v as the model hands them in: strided head views of a joint
    qkv (B, L, 3 H 64) of unit variance."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * h * 64)).astype(np.float32)).to(dev, dtype)
    return [t.reshape(b, l, h, 64).transpose(1, 2) for t in qkv.split(h * 64, dim=-1)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("route,b,h,l,causal", [
    ("short", 4, 12, 229, False),  # flagship windows under attn_backend="flash"
    ("short", 140, 12, 229, False),  # all 140 windows of the flagship image
    ("short", 5, 8, 77, True),  # the text tower
    ("short", 2, 2, 320, False),  # three key chunks: the two-sweep body
    ("short", 2, 2, 512, False),  # the longest short sequence
    ("short", 2, 2, 321, False),  # past 320 keys: 21 keys a thread, one block an SM
    ("short", 3, 4, 400, True),
    ("short", 2, 2, 300, True),
    ("tiled", 1, 2, 1100, False),  # ragged: 8 full key tiles and one of 76 keys
    ("tiled", 2, 3, 1100, True),
    ("tiled", 1, 2, 513, False),
    ("tiled", 1, 2, 129, False),  # one key in the last tile
    ("tiled", 3, 12, 2048, True),  # more items than SMs, causal
    ("tiled", 1, 12, 1024, False),
    ("tiled", 1, 16, 1 + 32 + 36 * 54, False),  # ViT-L/14, 16 heads, a 504 x 756 image whole
    ("short", 5, 10, 77, True),  # RN50x4's text tower: 10 heads
    ("short", 5, 16, 77, True),  # RN50x64's text tower: 16 heads
])
def test_flash_kernels_match_plain(cuda, route, b, h, l, causal, dtype):
    dtype = getattr(torch, dtype)
    q, k, v = _flash_inputs(b, h, l, seed=l + causal, dev=cuda, dtype=dtype)
    wrapper = fa.flash_short if route == "short" else fa.flash_tiled
    plain = fa.flash_short_plain if route == "short" else fa.flash_tiled_plain
    before = wrapper.launches
    got = wrapper(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, l, 64)
    want = plain(q, k, v, 0.125, causal).float()
    tol = 2e-2 * want.abs().max().item() if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want).abs().max().item() <= tol


def test_flash_attention_routes_and_differentiates(cuda):
    """``flash_attention`` launches the short kernel up to 512 tokens and
    the tiled one above; its gradient is the einsum reference's."""
    for l, wrapper in ((512, fa.flash_short), (513, fa.flash_tiled)):
        q, k, v = (t.detach().requires_grad_(True) for t in
                   _flash_inputs(1, 2, l, seed=l, dev=cuda, dtype=torch.float32))
        before = wrapper.launches
        out = fa.flash_attention(q, k, v)
        assert wrapper.launches == before + 1
        g = torch.randn_like(out)
        got = torch.autograd.grad(out, (q, k, v), g)
        want = torch.autograd.grad(fa.attention_reference(q, k, v, 0.125, False), (q, k, v), g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


def test_flash_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _flash_inputs(1, 2, 300, seed=0, dev=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
        fa.flash_short(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="must be a"):
        fa.flash_tiled(q.float(), k, v, 0.125)  # mixed dtypes
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_tiled(q[..., :32], k[..., :32], v[..., :32], 0.125)
    long = _flash_inputs(1, 2, 600, seed=0, dev=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash_tiled"):
        fa.flash_short(*long, 0.125)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_image_takes_the_tiled_kernel_and_matches_plain_path(cuda, dtype):
    """A whole ViT-B/16 CLIP-EBC on a 512 x 512 image run whole (1 + 32 +
    1024 = 1057 tokens): "auto" launches the tiled kernel 12 times and the
    fused kernel never, and the count is that of the plain path."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(2).normal(size=(512, 512, 3)).astype(np.float32)
    tol = 1e-2 if dtype == "bfloat16" else 1e-3
    counts = {}
    for backend in ("auto", "sdpa"):
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=getattr(torch, dtype),
                          num_vpt=32, seed=0, device=cuda, attn_backend=backend)
        ev = Evaluator(model, reduction=8, pad_to_multiple=16)
        ev.text_features()
        fa.flash_tiled.launches = fused_ln_qkv_attention.launches = 0
        density = ev.predict_density(image)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(density).all())
        assert fa.flash_tiled.launches == (12 if backend == "auto" else 0)
        assert fused_ln_qkv_attention.launches == 0
        counts[backend] = float(density.sum())
    assert abs(counts["auto"] - counts["sdpa"]) <= tol * abs(counts["sdpa"])


def test_flash_backend_takes_the_short_kernel(cuda):
    """``attn_backend="flash"`` on 64 px windows: the text tower (causal)
    and the trunk each launch the short kernel 12 times, and the count is
    that of the fused kernel path within the bf16 tolerance."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = np.random.default_rng(3).normal(size=(96, 144, 3)).astype(np.float32)
    counts = {}
    for backend in ("flash", "auto"):
        model = get_model("clip_vit_b_16", 64, 8, bins, anchors, dtype=torch.bfloat16,
                          num_vpt=32, seed=0, device=cuda, attn_backend=backend)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=64, stride=32,
                       pad_to_multiple=16)
        fa.flash_short.launches = 0
        ev.text_features()
        assert fa.flash_short.launches == (12 if backend == "flash" else 0)
        fa.flash_short.launches = 0
        density = ev.predict_density(image)
        torch.cuda.synchronize()
        assert fa.flash_short.launches == (12 if backend == "flash" else 0)
        counts[backend] = float(density.sum())
    assert abs(counts["flash"] - counts["auto"]) <= 1e-2 * abs(counts["auto"])


@pytest.mark.parametrize("d", [128, 256, 768, 832, 1024])
@pytest.mark.parametrize("m", [1, 63, 65, 129, 3664])
def test_ln_qkv_proj_matches_plain(cuda, m, d):
    """The bf16 LN + QKV projection alone (``ebc_ln_qkv_proj``, the first
    launch of the bf16 attention and the recompute of the frozen backward)
    at the edges of its 128-row items (1, 63, 65, 129 rows) and at a
    training step's 16 x 229 rows (items split into column parts), against
    ``ln_qkv_proj_plain``: max 2e-2 and median 1e-3 of the largest output
    (both round y and qkv to bf16 at the same points)."""
    rng = np.random.default_rng(m + d)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa: E731
    x = t(rng.normal(size=(m, d))).to(torch.bfloat16)
    gam, be = t(1.0 + 0.1 * rng.normal(size=d)), t(0.1 * rng.normal(size=d))
    w = t(rng.normal(size=(3 * d, d)) * d**-0.5).to(torch.bfloat16)
    bias = t(0.02 * rng.normal(size=3 * d))
    got = torch.full((m, 3 * d), float("nan"), dtype=torch.bfloat16, device=cuda)
    rc = fatt._entry("fused_attention", "ebc_ln_qkv_proj")(
        x.data_ptr(), gam.data_ptr(), be.data_ptr(), w.data_ptr(), bias.data_ptr(), got.data_ptr(),
        m, d, 1e-5, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = fatt.ln_qkv_proj_plain(x, gam, be, w, bias)
    assert bool(torch.isfinite(got).all())
    err, med = _max_median(got, want)
    assert err <= 2e-2 and med <= 1e-3, (err, med)


# key counts of the int8 attention body: one key, a 64-row query tile and
# one past it, the flagship windows, the one-sweep limit (256) and one past
# it (two sweeps), --window_size 320 and the longest
INT8_BODY_LENGTHS = [17, 64, 65, 229, 256, 257, 433, 512]


def _int8_body_vs_plain(cuda, branch, qkv, h, kv_len):
    """The int8 attention body (``ebc_int8_attention``) on a float qkv ``(B,
    L, 3D)`` in the output dtype and its plain version: static scales on the
    qkv quantized per tensor, or the dynamic scale pass. Returns ``(got,
    want)``, both ``(B, L, D)``."""
    b, l, three_d = qkv.shape
    d, out_dtype = three_d // 3, qkv.dtype
    f32 = out_dtype == torch.float32
    sm = (d // h) ** -0.5
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if branch == "static":
        aq = torch.clamp(qkv.float().reshape(b, l, 3, d).abs().amax((0, 1, 3)), min=1e-8) / 127.0
        qkv_q = torch.clamp(torch.round(qkv.float() / aq.repeat_interleave(d)), -127, 127).to(torch.int8)
        scales = aq.contiguous()
        want = fatt.int8_attention_static_plain(qkv_q, aq, h, kv_len, sm, out_dtype)
    else:
        block_b = 1 if f32 else 2
        qkv_q, scales = fatt.qkv_quant_dynamic(qkv, h, block_b)
        want = fatt.int8_attention_dynamic_plain(qkv, h, kv_len, sm, block_b)
    got = torch.full((b, l, d), float("nan"), dtype=out_dtype, device=cuda)
    rc = fatt._entry("fused_attention_int8", "ebc_int8_attention")(
        qkv_q.data_ptr(), scales.data_ptr(), got.data_ptr(), b, l, d, h, kv_len,
        int(branch == "dynamic"), int(f32), sm, stream)
    torch.cuda.synchronize()
    assert rc == 0
    return got, want


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l", INT8_BODY_LENGTHS)
@pytest.mark.parametrize("branch", ["static", "dynamic"])
def test_int8_attention_body_matches_plain(cuda, branch, l, masked, out_dtype):
    """The int8 attention body alone (``ebc_int8_attention``) at ViT-B width
    (12 heads), B in {1, 3, 16} (16 x 12 pairs: more than one a block),
    kv_len = L or below it: static scales on a qkv quantized per tensor,
    or the dynamic scale pass on a float qkv; against
    ``int8_attention_static_plain`` / ``int8_attention_dynamic_plain``, max
    2e-2 and median 1e-3 of the largest output."""
    d, h = 768, 12
    b = (1, 3, 16)[INT8_BODY_LENGTHS.index(l) % 3]
    kv_len = max(1, l - 29) if masked else l
    rng = np.random.default_rng(l + 7 * masked)
    qkv = torch.from_numpy(rng.normal(size=(b, l, 3 * d)).astype(np.float32)).to(cuda)
    got, want = _int8_body_vs_plain(cuda, branch, qkv.to(getattr(torch, out_dtype)), h, kv_len)
    assert bool(torch.isfinite(got).all())
    err, med = _max_median(got[:, :kv_len], want[:, :kv_len])
    assert err <= 2e-2 and med <= 1e-3, (err, med)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("l", [433, 512])
@pytest.mark.parametrize("branch", ["static", "dynamic"])
def test_int8_attention_body_exact_on_large_pv_sums(cuda, branch, l, out_dtype):
    """P V's int32 sums past 2^22 convert exactly: q = 0 makes the attention
    uniform (every p8 = 127) over kv_len = L keys, and in every head V's
    channel 0 is +max and channel 1 -max in every key (int8 +-127), so
    those sums reach +-L x 127^2 (7.0M at 433 tokens, 8.3M at 512). Both
    channels of the output must equal +-max; the whole output against the
    plain version with max 2e-2 and median 1e-3 of the largest output."""
    d, h, b = 768, 12, 2
    rng = np.random.default_rng(l)
    qkv = rng.normal(size=(b, l, 3, h, d // h)).astype(np.float32)
    qkv[:, :, 0] = 0.0
    qkv[:, :, 2, :, 0], qkv[:, :, 2, :, 1] = 8.0, -8.0  # the max-abs of V: int8 +-127
    qkv = torch.from_numpy(qkv.reshape(b, l, 3 * d)).to(cuda).to(getattr(torch, out_dtype))
    got, want = _int8_body_vs_plain(cuda, branch, qkv, h, l)
    assert bool(torch.isfinite(got).all())
    heads = got.float().reshape(b, l, h, d // h)
    assert torch.allclose(heads[..., 0], torch.full_like(heads[..., 0], 8.0), rtol=1e-2, atol=0)
    assert torch.allclose(heads[..., 1], torch.full_like(heads[..., 1], -8.0), rtol=1e-2, atol=0)
    err, med = _max_median(got, want)
    assert err <= 2e-2 and med <= 1e-3, (err, med)


def test_projection_and_int8_body_count_their_launches(cuda):
    """``fused_ln_qkv_attention.launches_proj`` counts each launch of the
    bf16 LN + QKV projection kernel (the bf16 forward and the frozen
    backward's recompute; the fp32 forward has its own kernel), and
    ``fused_ln_qkv_attention_int8.launches_attn`` each launch of the int8
    attention body (static and dynamic scales, not the float attention)."""
    b, l, d, h, kv_len = 2, 37, 128, 2, 33
    sm = (d // h) ** -0.5
    p, q = fused_ln_qkv_attention, fused_ln_qkv_attention_int8
    for dtype, n in ((torch.bfloat16, 1), (torch.float32, 0)):
        args = _attn_inputs(b, l, d, seed=3, dev=cuda, dtype=dtype)
        before = p.launches_proj
        fused_ln_qkv_attention(*args, h, kv_len, sm)
        assert p.launches_proj == before + n
    x, gam, be, w, bias = _attn_inputs(b, l, d, seed=4, dev=cuda)
    before = p.launches_proj
    ln_qkv_bwd_frozen(x, torch.ones_like(x), gam, be, w, bias, h, kv_len, sm)
    assert p.launches_proj == before + 1
    x, gam, be, w, bias, act_scale, aq = _int8_attn_inputs(b, l, 256, kv_len, cuda, torch.bfloat16)
    for kw, n in ((dict(attn_scales=aq), 1), (dict(quant_attn=True), 1), ({}, 0)):
        before = q.launches_attn
        fused_ln_qkv_attention_int8(x, gam, be, w, bias, act_scale, 4, kv_len, 64**-0.5, **kw)
        assert q.launches_attn == before + n, kw
    torch.cuda.synchronize()


# ---- the plain ViT's path: LayerNorm eps 1e-6, trainable LN and projection ----


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [8, 140])  # a training batch; the windows of a 2048 x 3072 image
def test_attention_kernel_takes_the_vit_eps(cuda, b, dtype):
    """Row 2 at the plain ViT's 197 tokens with LayerNorm eps 1e-6, on rows
    of variance 1e-6, where eps 1e-5 would move every output: the kernel
    matches its plain version at 1e-6 and not at 1e-5 (``chip_smoke``
    runs the same check)."""
    dtype = getattr(torch, dtype)
    err, err_at_1e5, launches = smoke.vit_eps_errors(cuda, dtype, b)
    assert launches == 1
    assert err <= smoke.VIT_KERNEL_TOL[dtype] < err_at_1e5, (err, err_at_1e5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,l,kv_len", [(8, 197, 197), (3, 37, 33)])
def test_split_backward_trains_ln_and_projection(cuda, b, l, kv_len, dtype):
    """The backward of row 2 when the LayerNorm, the projection and its
    bias train, in bf16 too: dx, dgamma, dbeta, dW and db each within 2e-2
    (bf16) or 1e-4 (fp32) of its own largest magnitude of plain autograd
    through the plain version; one attention-backward launch, no
    frozen-backward launch (``chip_smoke`` runs the same check)."""
    dtype = getattr(torch, dtype)
    d = 768 if l == 197 else 128
    errs, launches = smoke.split_backward_errors(cuda, dtype, b, l, kv_len, d)
    assert launches == (1, 0)
    assert all(v <= smoke.VIT_KERNEL_TOL[dtype] for v in errs.values()), errs


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_vit_takes_rows_2_and_4(cuda, dtype):
    """A ``vit_b_16`` Classifier (every parameter trains) on eight 224 px
    windows: 12 launches of row 2 a forward, 12 of row 4 a backward, none
    of the frozen backward; its count and every gradient against the same
    weights on the plain path (``attn_backend="sdpa"``): count 1e-2 (bf16)
    and 1e-3 (fp32) relative; gradients relative L2 over all parameters
    5e-2 (bf16) and 1e-3 (fp32)."""
    dtype = getattr(torch, dtype)
    model, plain = smoke.vit_pair(cuda, dtype, seed=0)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 224, 224, 3)).astype(np.float32))
    x = x.to(cuda)

    def loss_of(m):
        logits, density = m(x)
        return logits.float().square().mean() + density.sum()

    out = smoke.vit_against_plain(model, plain, lambda m: m(x).sum(), loss_of)
    assert out["serve"]["fused_ln_qkv_attention"] == 12
    n = out["train"]
    assert (n["fused_ln_qkv_attention"], n["attention_bwd"], n["ln_qkv_bwd_frozen"]) == (12, 12, 0)
    count, want = out["count"], out["plain_count"]
    assert abs(count - want) <= smoke.VIT_COUNT_TOL[dtype] * abs(want)
    print(f"plain ViT gradients: kernel vs plain path rel L2 {out['grad_err']:.3e}")
    assert out["grad_err"] <= smoke.VIT_GRAD_TOL[dtype]


def test_vit_l_block_routes_to_row_2_and_matches_plain(cuda):
    """A ViT-L window block (D = 1024, 16 heads, 289 tokens) on the card:
    ``attention_route`` says ``fused``, the block launches row 2 once (in
    bf16 its projection launch too) and its output is the plain block's
    (``attn_backend="sdpa"``, same weights) within 2e-2 of the largest
    magnitude in bf16 and 1e-4 in fp32."""
    from clip_ebc_tpu_torch.models.transformer import ResidualAttentionBlock

    torch.manual_seed(3)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        block = ResidualAttentionBlock(1024, 16).to(cuda)
        plain = ResidualAttentionBlock(1024, 16, attn_backend="sdpa").to(cuda)
        with torch.no_grad():
            for p in block.parameters():
                p.normal_(0.0, 0.03)
            plain.load_state_dict(block.state_dict())
            x = torch.randn(2, 289, 1024, device=cuda).to(dtype)
            assert block.route(x, None, None, False) == "fused"
            fused_ln_qkv_attention.launches = fused_ln_qkv_attention.launches_proj = 0
            got = block(x)
            torch.cuda.synchronize()
            assert fused_ln_qkv_attention.launches == 1
            assert fused_ln_qkv_attention.launches_proj == (1 if dtype == torch.bfloat16 else 0)
            want = plain(x).float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (dtype, err)
