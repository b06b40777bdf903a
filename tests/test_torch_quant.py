"""The port's W8A8 int8 pieces against the JAX package: the quantize and
matmul functions, ``Int8Conv2d``, calibration, the two kernel modules
(``fused_ln_qkv_attention_int8`` and ``fused_qkv_attention``, which the JAX
package interprets on the CPU by itself) and one trunk block. The port
runs the kernels' plain versions: the tensors are CPU tensors.

Tolerances. Int8 rounding turns a last-place difference upstream (another
summation order in a LayerNorm, an XLA fusion) into a rare one-step flip,
so integer tensors are compared by the share of entries that differ (by at
most 1, in under 0.1% of entries), and float outputs by both a maximum
(2e-2 of the largest magnitude: the JAX package's bf16 kernel tolerance,
which also covers a few flipped steps) and a median (1e-3 of it: a wrong
scale or a wrong fold moves every entry, not a few). Where nothing is
quantized (``fused_qkv_attention``) the usual 2e-4 (fp32) and 2e-2 (bf16)
apply. Calibrated max-abs trees agree at rtol 1e-4 in fp32.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models.transformer import ResidualAttentionBlock as JaxBlock
from clip_ebc_tpu.ops import quant as jq
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention_int8 as jax_fused_int8
from clip_ebc_tpu.ops.fused_attention import fused_qkv_attention as jax_qkv_attention
from clip_ebc_tpu_torch.models.convert import _resblocks, quant_state_from_jax, quant_state_to_jax
from clip_ebc_tpu_torch.models.transformer import ResidualAttentionBlock, Transformer
from clip_ebc_tpu_torch.ops import quant as tq
from clip_ebc_tpu_torch.ops.fused_attention import (
    attention_bwd_plain,
    fused_ln_qkv_attention_int8,
    fused_qkv_attention,
    ln_qkv_attention_int8_plain,
    qkv_attention_plain,
)

torch.set_num_threads(2)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def assert_ints_close(got, want, share=1e-3):
    """Integer tensors: entries differ by at most 1, in under ``share`` of them."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < share, (diff > 0).mean()


def assert_close_max_median(got, want, max_tol=2e-2, med_tol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= max_tol * top, (diff.max(), top)
    assert np.median(diff) <= med_tol * top, (np.median(diff), top)


# ---- functions ---------------------------------------------------------------------


def test_quantize_rowwise_and_colwise_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 33, 64)).astype(np.float32) * 3
    w = (rng.normal(size=(64, 40)) * 0.1).astype(np.float32)
    for ours, theirs, a in ((tq.quantize_rowwise, jq.quantize_rowwise, x),
                            (tq.quantize_colwise, jq.quantize_colwise, w)):
        q, s = ours(_t(a))
        jq_, js = theirs(jnp.asarray(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert_ints_close(q.numpy(), jq_)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    # the torch-layout quantizer is the column-wise one on the transpose
    q, s = tq.quantize_weight(_t(w.T))
    qc, sc = tq.quantize_colwise(_t(w))
    assert torch.equal(q, qc.T) and torch.equal(s, sc[0])


@pytest.mark.parametrize("m,k,n", [(5, 36, 7), (294, 768, 2304), (64, 3072, 768)])
def test_int_mm_is_the_exact_int32_product(m, k, n):
    rng = np.random.default_rng(m)
    a = _t(rng.integers(-127, 128, (m, k)).astype(np.int8), "int8")
    b = _t(rng.integers(-127, 128, (n, k)).astype(np.int8), "int8")
    got = tq.int_mm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, a.int() @ b.int().T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_dynamic_and_static_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    kernel = (rng.normal(size=(64, 48)) * 0.125).astype(np.float32)
    bias = (0.05 * rng.normal(size=48)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jq.int8_matmul(jx, jnp.asarray(kernel), jnp.asarray(bias))
    got = tq.int8_matmul(_t(x, dtype), _t(kernel), _t(bias))
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy(), np.asarray(want, np.float32))
    scale = np.float32(np.abs(x).max() / 127.0)
    want = jq.int8_matmul_static(jx, jnp.asarray(kernel), jnp.asarray(scale), jnp.asarray(bias))
    got = tq.int8_matmul_static(_t(x, dtype), _t(kernel), float(scale), _t(bias))
    assert_close_max_median(got.float().numpy(), np.asarray(want, np.float32))
    # and both stay within quantization distance of the float product
    ref = x @ kernel + bias
    assert np.median(np.abs(got.float().numpy() - ref)) < 0.03 * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv2d_matches_jax_int8_conv(mode, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)  # NHWC
    kernel = (rng.normal(size=(3, 3, 16, 24)) * 0.1).astype(np.float32)  # HWIO
    amax = np.float32(np.abs(x).max())
    jconv = jq.Int8Conv(24, (3, 3), padding=((1, 1), (1, 1)), use_bias=False,
                        dtype=getattr(jnp, dtype), quant_mode=mode)
    variables = {"params": {"kernel": jnp.asarray(kernel)}, "quant": {"act_amax": jnp.asarray(amax)}}
    want = np.asarray(jconv.apply(variables, jnp.asarray(x, getattr(jnp, dtype))), np.float32)

    conv = tq.Int8Conv2d(16, 24, 3, padding=1, bias=False, quant_mode=mode)
    conv.load_state_dict({"weight": _t(kernel.transpose(3, 2, 0, 1))})  # HWIO -> OIHW
    tq.load_quant_state(conv, {"act_amax": torch.tensor(amax)})
    with torch.no_grad():
        got = conv(_t(x, dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy(), want)


@pytest.mark.parametrize("cfg", [
    dict(k=3, stride=1, padding=1, dilation=1),
    dict(k=1, stride=1, padding=0, dilation=1),
    dict(k=3, stride=2, padding=2, dilation=2),
])
def test_int8_conv_routes_give_the_plain_accumulators(cfg):
    """The im2col a CUDA tensor takes, and the shifted-products alternative
    measured beside it, hold the plain int32 convolution's accumulators
    exactly, here on the CPU."""
    rng = np.random.default_rng(3)
    x_q = _t(rng.integers(-127, 128, (2, 9, 7, 16)).astype(np.int8), "int8").permute(0, 3, 1, 2)
    w_q = _t(rng.integers(-127, 128, (24, 16, cfg["k"], cfg["k"])).astype(np.int8), "int8")
    args = ((cfg["stride"],) * 2, (cfg["padding"],) * 2, (cfg["dilation"],) * 2)
    if cfg["dilation"] == 1:
        want = tq.int8_conv2d_plain(x_q, w_q, *args)
    else:  # torch has no dilated integer convolution on the CPU; float64 is exact here
        want = torch.nn.functional.conv2d(x_q.double(), w_q.double(), None, *args).int()
    for route in (tq.int8_conv2d_im2col, tq.int8_conv2d_shifted):
        got = route(x_q, w_q, *args)
        assert got.dtype == torch.int32 and torch.equal(got, want)


def test_calibrate_int8_keeps_a_running_max_over_batches():
    rng = np.random.default_rng(5)
    small = rng.normal(size=(4, 16)).astype(np.float32)
    big = small * 10.0
    layer = tq.Int8Linear(16, 8)
    state = tq.calibrate_int8(layer, [_t(small), _t(big), _t(small)])
    assert np.isclose(float(state["act_amax"]), np.abs(big).max(), rtol=1e-6)
    # the JAX package's calibrate_int8 on the same weights and batches
    params = {"params": {"kernel": jnp.asarray(layer.weight.detach().numpy().T),
                         "bias": jnp.asarray(layer.bias.detach().numpy())}}
    dyn = jq.Int8Dense(8, quant_mode="dynamic")
    v = jq.calibrate_int8(lambda vv, b: dyn.apply(vv, b, mutable=["quant"]), params,
                          [jnp.asarray(small), jnp.asarray(big), jnp.asarray(small)])
    np.testing.assert_allclose(float(state["act_amax"]), float(v["quant"]["act_amax"]), rtol=1e-6)
    # outside a calibration pass a dynamic layer records nothing; a static one never does
    layer(_t(big * 2))
    assert float(layer.act_amax) == float(state["act_amax"])
    static = tq.Int8Linear(16, 8, quant_mode="static")
    with pytest.raises(ValueError, match="act_amax == 0"):
        tq.calibrate_int8(static, [_t(small)], forward=lambda b: None)
    with pytest.raises(ValueError, match="no quantized layers"):
        tq.calibrate_int8(torch.nn.Linear(16, 8), [_t(small)])


def test_validate_quant_scales_raises_on_all_zero_and_warns_on_some(caplog):
    zero, one = torch.zeros(()), torch.ones(())
    with pytest.raises(ValueError, match="uncalibrated int8 activation scales"):
        tq.validate_quant_scales({"a.act_amax": zero, "b.qkv_amax": torch.zeros(3)})
    with pytest.raises(ValueError, match="no quant state"):
        tq.validate_quant_scales({})
    with caplog.at_level(logging.WARNING, logger="clip_ebc_tpu_torch"):
        tq.validate_quant_scales({"a.act_amax": zero, "b.act_amax": one})
    assert "a.act_amax" in caplog.text and "b.act_amax" not in caplog.text
    with pytest.raises(ValueError, match="a.act_amax"):
        tq.validate_quant_scales({"a.act_amax": zero, "b.act_amax": one}, strict=True)
    tq.validate_quant_scales({"b.act_amax": one, "c.qkv_amax": torch.ones(3)})


def test_static_layer_raises_uncalibrated_and_quant_buffers_stay_out_of_state_dict():
    plain = ResidualAttentionBlock(128, 2)
    block = ResidualAttentionBlock(128, 2, quant_int8=True, quant_mode="static")
    assert list(block.state_dict()) == list(plain.state_dict())
    assert sorted(tq.quant_state(block)) == [
        "attn.in_proj_act_amax", "attn.out_proj.act_amax", "attn.qkv_amax",
        "mlp.c_fc.act_amax", "mlp.c_proj.act_amax"]
    with torch.no_grad(), pytest.raises(RuntimeError, match="uncalibrated activation scale"):
        block(torch.zeros(1, 8, 128))
    # quant_attn builds with the same buffers; a value outside False, True,
    # "xla" is refused
    for quant_attn in (True, "xla"):
        qa = ResidualAttentionBlock(128, 2, quant_int8=True, quant_mode="static", quant_attn=quant_attn)
        assert sorted(tq.quant_state(qa)) == sorted(tq.quant_state(block))
    with pytest.raises(ValueError, match="quant_attn"):
        ResidualAttentionBlock(128, 2, quant_int8=True, quant_mode="static", quant_attn="bogus")
    with pytest.raises(KeyError):
        tq.load_quant_state(block, {"attn.qkv_amax": torch.ones(3)})


def test_weight_change_requantizes():
    layer = tq.Int8Linear(16, 8)
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        first = layer(x)
        layer.weight.mul_(2.0)
        layer.bias.zero_()
        second = layer(x)
    bias = first - (second / 2)  # the old bias: the product doubled exactly
    assert torch.allclose(bias, bias[:1].expand_as(bias), atol=1e-5)
    assert not torch.equal(first, second)


# ---- kernel A's module ---------------------------------------------------------------


def _attn_inputs(b, l, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    be = (0.1 * rng.normal(size=d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) * d**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * d)).astype(np.float32)
    return x, g, be, w, bias


ATTN_SHAPES = [(64, 64, "float32"), (64, 64, "bfloat16"), (229, 200, "float32"),
               (229, 229, "bfloat16")]


@pytest.mark.parametrize("l,kv_len,dtype", ATTN_SHAPES)
def test_ln_qkv_attention_int8_plain_matches_jax_kernel(l, kv_len, dtype):
    b, d, h = 2, 768, 12
    x, g, be, w, bias = _attn_inputs(b, l, d, seed=l + kv_len)
    sm = (d // h) ** -0.5
    xf = x - x.mean(-1, keepdims=True)
    y = xf / np.sqrt((xf**2).mean(-1, keepdims=True) + 1e-5) * g + be
    act_scale = np.float32(np.abs(y).max() / 127.0)  # what a calibration records
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(act_scale), h, kv_len, sm), np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    before = fused_ln_qkv_attention_int8.launches
    got = fused_ln_qkv_attention_int8(*args, h, kv_len, sm)
    assert fused_ln_qkv_attention_int8.launches == before  # a CPU tensor: the plain version
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len])
    w_q, s_col = tq.quantize_weight(args[3])
    plain = ln_qkv_attention_int8_plain(*args[:3], w_q, s_col, args[4], args[5], h, kv_len, sm)
    assert torch.equal(got, plain)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_ln_qkv_attention_int8(args[0].requires_grad_(), *args[1:], h, kv_len, sm)


# ---- kernel B's module ---------------------------------------------------------------


@pytest.mark.parametrize("l,kv_len,dtype", ATTN_SHAPES)
def test_qkv_attention_plain_matches_jax_kernel(l, kv_len, dtype):
    b, d, h = 2, 768, 12
    qkv = np.random.default_rng(l).normal(size=(b, l, 3 * d)).astype(np.float32)
    sm = (d // h) ** -0.5
    want = np.asarray(jax_qkv_attention(jnp.asarray(qkv, getattr(jnp, dtype)), h, kv_len, sm),
                      np.float32)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(_t(qkv, dtype), h, kv_len, sm)
    assert fused_qkv_attention.launches == before
    assert torch.equal(got, qkv_attention_plain(_t(qkv, dtype), h, kv_len, sm))
    tol = {"float32": 2e-4, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy()[:, :kv_len], want[:, :kv_len], rtol=tol, atol=tol)


@pytest.mark.parametrize("l,kv_len", [(64, 64), (229, 200)])
def test_qkv_attention_gradient_matches_jax_grad(l, kv_len):
    """The backward is the port's ``attention_bwd`` (its plain version on
    the CPU), as the JAX VJP is ``_attention_bwd``; fp32, 2e-4 of the
    largest gradient."""
    b, d, h = 1, 768, 12
    rng = np.random.default_rng(l)
    qkv = rng.normal(size=(b, l, 3 * d)).astype(np.float32)
    cot = rng.normal(size=(b, l, d)).astype(np.float32)
    cot[:, kv_len:] = 0  # outputs of rows >= kv_len are not specified
    sm = (d // h) ** -0.5
    want = np.asarray(jax.grad(
        lambda t: (jax_qkv_attention(t, h, kv_len, sm) * jnp.asarray(cot)).sum())(jnp.asarray(qkv)))
    t = _t(qkv).requires_grad_()
    (fused_qkv_attention(t, h, kv_len, sm) * _t(cot)).sum().backward()
    assert torch.equal(t.grad, attention_bwd_plain(_t(qkv), _t(cot), h, kv_len, sm))
    got = t.grad.numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    assert not got[:, kv_len:, d:].any()  # masked keys: no gradient


# ---- one block -----------------------------------------------------------------------


def test_block_static_int8_matches_jax_with_carried_and_own_calibration():
    """A JAX block is calibrated on its dynamic twin and run static with
    ``fused_qkv=True`` (the int8 Pallas kernel, interpreted); the port's
    block (``attn_backend="fused"``: the kernels' plain versions) runs
    against it with the JAX scales carried across, then with the port's own
    calibration, whose tree must agree with the JAX one."""
    b, l, h, d = 1, 128, 12, 768
    x = np.random.default_rng(5).normal(size=(b, l, d)).astype(np.float32)
    dense = functools.partial(jq.Int8Dense, quant_mode="static")
    jstatic = JaxBlock(num_heads=h, fused_qkv=True, kv_len=l, quant_int8=True,
                       quant_mode="static", dense_cls=dense)
    jdyn = JaxBlock(num_heads=h, fused_qkv=True, kv_len=l, quant_int8=True,
                    quant_mode="dynamic", dense_cls=jq.Int8Dense)
    v = dict(jstatic.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = jq.calibrate_int8(lambda vv, bb: jdyn.apply(vv, bb, mutable=["quant"]), v, [jnp.asarray(x)])
    want = np.asarray(jstatic.apply(v, jnp.asarray(x)), np.float32)
    want_dyn = np.asarray(jdyn.apply({"params": v["params"]}, jnp.asarray(x)), np.float32)

    sd = {}
    _resblocks(sd, {"resblock_0": jax.tree_util.tree_map(np.asarray, v["params"])})
    weights = {k[len("transformer."):]: t for k, t in sd.items()}
    prefix = "image_encoder.transformer."
    jax_state = {k[len(prefix):]: t for k, t in quant_state_from_jax(
        {"image_encoder": {"resblock_0": jax.tree_util.tree_map(np.asarray, v["quant"])}},
        decoder_cfg=()).items()}

    def port(mode):
        m = Transformer(d, 1, h, attn_backend="fused", quant_int8=True, quant_mode=mode)
        m.load_state_dict(weights)
        return m.eval()

    static, dyn = port("static"), port("dynamic")
    block = static.resblocks[0]
    assert block.route(_t(x), None, None, False) == "fused"
    assert block.fuse_ln() and not dyn.resblocks[0].fuse_ln()
    tq.load_quant_state(static, jax_state)
    with torch.no_grad():
        assert_close_max_median(block(_t(x)).numpy(), want)
        assert_close_max_median(dyn.resblocks[0](_t(x)).numpy(), want_dyn)
        own = tq.calibrate_int8(dyn, [_t(x)], forward=dyn.resblocks[0])
    assert sorted(own) == sorted(jax_state)
    for k in own:
        np.testing.assert_allclose(own[k].numpy(), jax_state[k].numpy(), rtol=1e-4, err_msg=k)
    tq.load_quant_state(static, own)
    with torch.no_grad():
        assert_close_max_median(block(_t(x)).numpy(), want)
    # and back: the port's state as a JAX tree feeds the JAX block the same scales
    tree = quant_state_to_jax({prefix + k: t for k, t in own.items()}, decoder_cfg=())
    back = np.asarray(jstatic.apply({"params": v["params"],
                                     "quant": tree["image_encoder"]["resblock_0"]},
                                    jnp.asarray(x)), np.float32)
    assert_close_max_median(back, want)
