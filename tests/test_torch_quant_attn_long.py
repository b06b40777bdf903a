"""Windows of 321-512 tokens against the JAX package: the int8 attention of
a static ``quant_attn=True`` block (``--window_size 288``: 1 + 32 + 18 x 18
= 357 tokens; ``--window_size 320``: 433), the route table's boundaries,
and the plain versions of the short flash route and of the attention
backward at the lengths their kernels were redesigned for (77 causal, 229,
512). The JAX Pallas kernels run interpreted on the CPU by themselves; the
port's tensors are CPU tensors, so its wrappers run their plain versions.

The JAX package fuses a block up to a padded L of 512
(``clip_ebc_tpu/models/transformer.py:356-377``), where a static block
with calibrated ``qkv_amax`` runs ``_pair_attention_body_static``: its
attention is int8. The port routes such a block to the fused int8 route up
to ``MAX_FUSED_SEQ_INT8_ATTN`` = 512 tokens too; before, it took the plain
route there, whose attention is float, and the block's output moved by what
int8 attention does.

Sizes: D = 128, 2 heads, 1 window (2 in the op test). Tolerances as in
``tests/test_torch_quant_attn.py``: a flipped int8 step is rare and moves a
value by a step, a wrong route or scale moves every value, so outputs are
held to a maximum (2e-2 of the largest magnitude) and a median (1e-3 of it
in fp32). The block is compared on its update ``block(x) - x``: the
residual ``x`` is the same on both sides and would hide the attention in
the largest magnitude. Flash and backward: the tolerances of
``tests/test_torch_flash_attention.py`` and
``tests/test_torch_attention_bwd.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models.transformer import ResidualAttentionBlock as JaxBlock
from clip_ebc_tpu.ops import quant as jq
from clip_ebc_tpu.ops.flash_attention import flash_attention as jax_flash
from clip_ebc_tpu.ops.fused_attention import _attention_bwd
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention_int8 as jax_fused_int8
from clip_ebc_tpu_torch.models import transformer as tr
from clip_ebc_tpu_torch.models.convert import _resblocks, quant_state_from_jax
from clip_ebc_tpu_torch.ops import flash_attention as fa
from clip_ebc_tpu_torch.ops import quant as tq
from clip_ebc_tpu_torch.ops.fused_attention import (
    MAX_FUSED_SEQ,
    MAX_FUSED_SEQ_INT8_ATTN,
    attention_bwd_plain,
    fused_ln_qkv_attention_int8,
    ln_qkv_attention_int8_static_plain,
    supports,
)

torch.set_num_threads(2)
D, H = 128, 2
SM = (D // H) ** -0.5


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def assert_close_max_median(got, want, max_tol=2e-2, med_tol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= max_tol * top, (diff.max(), top)
    assert np.median(diff) <= med_tol * top, (np.median(diff), top)


# ---- one static quant_attn=True block ------------------------------------------------


def _jax_block(l, quant_attn, mode="static"):
    dense = functools.partial(jq.Int8Dense, quant_mode=mode)
    return JaxBlock(num_heads=H, fused_qkv=True, kv_len=l, quant_int8=True, quant_mode=mode,
                    dense_cls=dense, quant_attn=quant_attn)


@functools.lru_cache(maxsize=None)
def _block_setup(l):
    """A JAX block at L tokens, calibrated on its dynamic twin, and the
    port's weights and quant state carried across by models/convert.py."""
    x = np.random.default_rng(l).normal(size=(1, l, D)).astype(np.float32)
    v = dict(_jax_block(l, True).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    dyn = _jax_block(l, False, "dynamic")
    v = jq.calibrate_int8(lambda vv, bb: dyn.apply(vv, bb, mutable=["quant"]), v, [jnp.asarray(x)])
    sd = {}
    _resblocks(sd, {"resblock_0": jax.tree_util.tree_map(np.asarray, v["params"])})
    weights = {k[len("transformer."):]: t for k, t in sd.items()}
    prefix = "image_encoder.transformer."
    state = {k[len(prefix):]: t for k, t in quant_state_from_jax(
        {"image_encoder": {"resblock_0": jax.tree_util.tree_map(np.asarray, v["quant"])}},
        decoder_cfg=()).items()}
    return x, v, weights, state


def _port_block(weights, state, quant_attn, **kw):
    m = tr.Transformer(D, 1, H, attn_backend="fused", quant_int8=True, quant_mode="static",
                       quant_attn=quant_attn, **kw)
    m.load_state_dict(weights)
    tq.load_quant_state(m, state)
    return m.eval().resblocks[0]


@pytest.mark.parametrize("l", [357, 433])
def test_static_int8_attention_block_matches_jax_at_long_windows(l):
    """The port's block takes the fused int8 route at these lengths, as the
    JAX block does, and its update matches the JAX block's."""
    x, v, weights, state = _block_setup(l)
    want = np.asarray(_jax_block(l, True).apply(v, jnp.asarray(x)), np.float32)
    block = _port_block(weights, state, True)
    assert block.route(_t(x), None, None, False) == "fused" and block.fuse_ln()
    before = fused_ln_qkv_attention_int8.launches_static
    with torch.no_grad():
        got = block(_t(x)).numpy()
    assert fused_ln_qkv_attention_int8.launches_static == before  # CPU: the plain version
    assert_close_max_median(got - x, want - x)


@pytest.mark.parametrize("kv_len,dtype", [(433, "float32"), (400, "float32"), (433, "bfloat16")])
def test_static_int8_attention_op_matches_jax_kernel_at_433(kv_len, dtype):
    l = 433
    rng = np.random.default_rng(kv_len)
    x = rng.normal(size=(2, l, D)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    be = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * D)).astype(np.float32)
    xf = x - x.mean(-1, keepdims=True)
    y = xf / np.sqrt((xf**2).mean(-1, keepdims=True) + 1e-5) * g + be
    act_scale = np.float32(np.abs(y).max() / 127.0)
    aq = (np.abs(y @ w + bias).reshape(-1, 3, D).max(axis=(0, 2)) / 127.0).astype(np.float32)
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(act_scale), H, kv_len, SM, attn_scales=jnp.asarray(aq)),
        np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    got = fused_ln_qkv_attention_int8(*args, H, kv_len, SM, attn_scales=torch.from_numpy(aq))
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len],
                            med_tol=1e-3 if dtype == "float32" else 4e-3)
    w_q, s_col = tq.quantize_weight(args[3])
    plain = ln_qkv_attention_int8_static_plain(*args[:3], w_q, s_col, args[4], args[5],
                                               torch.from_numpy(aq), H, kv_len, SM)
    assert torch.equal(got, plain)


# ---- the route table ----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["fused", "auto"])
@pytest.mark.parametrize("l,int8_attn,want", [
    (MAX_FUSED_SEQ, False, "fused"), (MAX_FUSED_SEQ + 1, False, "plain"),
    (MAX_FUSED_SEQ + 1, True, "fused"), (MAX_FUSED_SEQ_INT8_ATTN, True, "fused"),
    (MAX_FUSED_SEQ_INT8_ATTN + 1, True, "plain"),
])
def test_route_table_boundaries(backend, l, int8_attn, want):
    assert (MAX_FUSED_SEQ, MAX_FUSED_SEQ_INT8_ATTN) == (320, 512)
    assert supports(H, 64, l, MAX_FUSED_SEQ_INT8_ATTN if int8_attn else MAX_FUSED_SEQ) == (
        want == "fused")
    assert tr.attention_route(backend, "cuda", l, "none", int8_attn=int8_attn) == want
    assert tr.attention_route(backend, "cuda", l, "padding", int8_attn=int8_attn) == want
    # "auto" on a CPU tensor is plain, as before
    assert tr.attention_route("auto", "cpu", l, "none", int8_attn=int8_attn) == "plain"


@pytest.mark.parametrize("quant_attn,fuse_ln_mode,l,want", [
    (True, "auto", 433, "fused"), (True, "auto", 512, "fused"), (True, "auto", 513, "plain"),
    (True, "off", 433, "plain"),  # the float attention: no int8 on the unfused route
    (False, "auto", 321, "plain"), (False, "auto", 320, "fused"),
    ("xla", "auto", 433, "plain"),  # the xla attention reads the unfused projection's qkv
])
def test_block_routes_by_its_int8_attention(quant_attn, fuse_ln_mode, l, want):
    _, _, weights, state = _block_setup(357)
    block = _port_block(weights, state, quant_attn, fuse_ln_mode=fuse_ln_mode)
    assert block.route(torch.zeros(1, l, D), None, None, False) == want
    # a calibration pass records through the unfused projection at any length
    block.calibrating = True
    assert block.route(torch.zeros(1, l, D), None, None, False) == (
        "fused" if l <= MAX_FUSED_SEQ else "plain")


# ---- plain versions of the redesigned kernels at their lengths ----------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,causal", [(77, True), (229, False), (512, False)])
def test_flash_short_plain_matches_jax(l, causal, dtype):
    rng = np.random.default_rng(l)
    q, k, v = (rng.normal(size=(1, 2, l, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(*(jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v)), None,
                                causal, 128, 128, True), np.float32)
    got = fa.flash_short_plain(*(_t(t, dtype) for t in (q, k, v)), 64**-0.5, causal)
    tol = {"float32": 2e-5, "bfloat16": 3e-2}[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,kv_len", [(77, 77), (229, 229), (229, 200), (512, 512)])
def test_attention_bwd_plain_matches_jax_kernel(l, kv_len, dtype):
    rng = np.random.default_rng(l + kv_len)
    qkv = (0.5 * rng.normal(size=(1, l, 3 * D))).astype(np.float32)
    g = rng.normal(size=(1, l, D)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(_attention_bwd(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), H, kv_len, SM,
                                     1, True), np.float32)
    got = attention_bwd_plain(_t(qkv, dtype), _t(g, dtype), H, kv_len, SM).float().numpy()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    scale = 1.0 if dtype == "float32" else max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
    assert not np.abs(got[:, kv_len:, D:]).sum()  # masked keys: exactly no gradient
