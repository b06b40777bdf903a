"""The port's int8 attention (``quant_attn``) against the JAX package: the
plain integer-product attention of ``--quant_attn xla``
(``ops/int8_attention.py``), the two int8 branches of
``fused_ln_qkv_attention_int8`` (calibrated ``attn_scales``, and the dynamic
``quant_attn=True``; the JAX Pallas kernel runs interpreted on the CPU by
itself), one trunk block in each mode, the routing, and a two-block
CLIP-EBC through the ``Evaluator``. The port's tensors are CPU tensors, so
its kernel wrappers run their plain versions.

Sizes: D = 256, 4 heads, L = 128, B = 2 windows; the model slice keeps the
flagship width (768, 12 heads) at two blocks and 64 px windows.

Tolerances. The int8 values of q, k and v of the ``xla`` path are compared
for equality. Elsewhere int8 rounding turns a last-place difference
upstream (an ``exp``, a LayerNorm sum taken in another order) into a rare
one-step flip, so float outputs are held to a maximum (2e-2 of the largest
magnitude: the JAX package's bf16 kernel tolerance, which also covers a few
flipped steps) and a median (1e-3 of it in fp32, 4e-3 in bf16, one bf16
step: a wrong scale or fold moves every entry, not a few). Counts of the
model slice: 2e-3; the ``kernel`` and ``xla`` counts within 2e-2 of each
other (the JAX package's ``tests/test_int8_attention.py`` tolerance between
the two modes). Calibrated max-abs trees: rtol 1e-4 in the first block,
2e-2 after it (the calibration twin is the dynamic model, whose int8 flips
compound from block to block).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_image_encoder
from clip_ebc_tpu.models.transformer import ResidualAttentionBlock as JaxBlock
from clip_ebc_tpu.cli._common import calibrate_static_int8 as jax_calibrate_static
from clip_ebc_tpu.ops import quant as jq
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention_int8 as jax_fused_int8
from clip_ebc_tpu.ops.int8_attention import _q8 as jax_q8
from clip_ebc_tpu.ops.int8_attention import xla_int8_qkv_attention
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli._common import QUANT_ATTN, calibrate_static_int8
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip import image_encoder as port_image_encoder
from clip_ebc_tpu_torch.models.convert import _resblocks, quant_state_from_jax
from clip_ebc_tpu_torch.models.transformer import Transformer, check_quant_args
from clip_ebc_tpu_torch.ops import quant as tq
from clip_ebc_tpu_torch.ops.fused_attention import (
    dynamic_attn_scales,
    fused_ln_qkv_attention_int8,
    ln_qkv_attention_int8_dynamic_plain,
    ln_qkv_attention_int8_static_plain,
)
from clip_ebc_tpu_torch.ops.int8_attention import int8_qkv_attention, int_bmm, quantize_static
from clip_ebc_tpu_torch.training.evaluate import Evaluator

torch.set_num_threads(2)
B, L, D, H = 2, 128, 256, 4
SM = (D // H) ** -0.5


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def assert_close_max_median(got, want, max_tol=2e-2, med_tol=1e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= max_tol * top, (diff.max(), top)
    assert np.median(diff) <= med_tol * top, (np.median(diff), top)


def _med_tol(dtype):
    return {"float32": 1e-3, "bfloat16": 4e-3}[dtype]


def _qkv_scales(qkv):
    """Per-{q, k, v} max-abs / 127 of a (B, L, 3D) qkv: what a calibration
    pass records."""
    return (np.abs(np.asarray(qkv, np.float32)).reshape(-1, 3, qkv.shape[-1] // 3).max(axis=(0, 2))
            / 127.0).astype(np.float32)


# ---- ops/int8_attention.py ---------------------------------------------------------


@pytest.mark.parametrize("kv_len,dtype", [(L, "float32"), (100, "float32"), (L, "bfloat16")])
def test_int8_qkv_attention_matches_jax(kv_len, dtype):
    qkv = np.random.default_rng(kv_len).normal(size=(B, L, 3 * D)).astype(np.float32)
    scales = _qkv_scales(qkv)
    jqkv = jnp.asarray(qkv, getattr(jnp, dtype))
    tqkv = _t(qkv, dtype)
    # the quantized q, k and v are equal, not merely close
    for i in range(3):
        want = np.asarray(jax_q8(jqkv[..., i * D:(i + 1) * D], jnp.asarray(scales[i])))
        got = quantize_static(tqkv[..., i * D:(i + 1) * D], torch.tensor(scales[i]))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(xla_int8_qkv_attention(jqkv, H, kv_len, SM, jnp.asarray(scales)), np.float32)
    got = int8_qkv_attention(tqkv, H, kv_len, SM, torch.from_numpy(scales))
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len], med_tol=_med_tol(dtype))


def test_int_bmm_is_exact_beyond_one_fp32_product():
    """Past 1024 keys an fp32 product of int8 values is no longer exact; the
    chunked sum is."""
    rng = np.random.default_rng(1)
    a = _t(rng.integers(-127, 128, (3, 8, 2500)).astype(np.int8), "int8")
    b = _t(rng.integers(-127, 128, (3, 2500, 16)).astype(np.int8), "int8")
    got = int_bmm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got, (a.long() @ b.long()).int())


# ---- fused_ln_qkv_attention_int8: attn_scales (static) and quant_attn (dynamic) ----


def _block_inputs(seed, b=B, l=L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, D)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    be = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * D)).astype(np.float32)
    xf = x - x.mean(-1, keepdims=True)
    y = xf / np.sqrt((xf**2).mean(-1, keepdims=True) + 1e-5) * g + be
    act_scale = np.float32(np.abs(y).max() / 127.0)  # what a calibration records
    return x, g, be, w, bias, act_scale, _qkv_scales(y @ w + bias)


@pytest.mark.parametrize("kv_len,dtype", [(L, "float32"), (100, "float32"), (L, "bfloat16"),
                                          (100, "bfloat16")])
def test_static_int8_attention_matches_jax_kernel(kv_len, dtype):
    x, g, be, w, bias, act_scale, aq = _block_inputs(seed=kv_len)
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(act_scale), H, kv_len, SM, attn_scales=jnp.asarray(aq)),
        np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    before = fused_ln_qkv_attention_int8.launches_static
    got = fused_ln_qkv_attention_int8(*args, H, kv_len, SM, attn_scales=torch.from_numpy(aq))
    assert fused_ln_qkv_attention_int8.launches_static == before  # a CPU tensor: the plain version
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len], med_tol=_med_tol(dtype))
    w_q, s_col = tq.quantize_weight(args[3])
    plain = ln_qkv_attention_int8_static_plain(*args[:3], w_q, s_col, args[4], args[5],
                                               torch.from_numpy(aq), H, kv_len, SM)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kv_len,dtype", [(L, "float32"), (100, "bfloat16")])
def test_dynamic_int8_attention_matches_jax_kernel(kv_len, dtype):
    """B = 2 is a multiple of the JAX block_b (2 in bf16, 1 in fp32) and L =
    128 of its 16-row padding: the port's tiles (real rows only) are the
    JAX kernel's."""
    x, g, be, w, bias, act_scale, _ = _block_inputs(seed=7 + kv_len)
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(act_scale), H, kv_len, SM, quant_attn=True), np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    got = fused_ln_qkv_attention_int8(*args, H, kv_len, SM, quant_attn=True)
    assert got.dtype == getattr(torch, dtype)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len], med_tol=_med_tol(dtype))
    w_q, s_col = tq.quantize_weight(args[3])
    block_b = 1 if dtype == "float32" else 2
    plain = ln_qkv_attention_int8_dynamic_plain(*args[:3], w_q, s_col, args[4], args[5], H, kv_len,
                                                SM, block_b=block_b)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("branch", ["static", "dynamic"])
@pytest.mark.parametrize("l", [256, 257])
def test_int8_attention_plain_matches_jax_kernel_at_the_sweep_boundary(l, branch):
    """The plain int8 attention the CUDA body is held to, at the key counts
    where that body changes design (up to 256 keys the score row stays in
    registers, from 257 it sweeps the keys twice), against the JAX kernel
    (interpreted): 2 heads, 2 windows, fp32, calibrated static scales or
    dynamic per-tile ones."""
    d, h, kv_len = 128, 2, l - 3
    sm = (d // h) ** -0.5
    rng = np.random.default_rng(l)
    x = rng.normal(size=(2, l, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=d)).astype(np.float32)
    be = (0.1 * rng.normal(size=d)).astype(np.float32)
    w = (rng.normal(size=(d, 3 * d)) * d**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * d)).astype(np.float32)
    xf = x - x.mean(-1, keepdims=True)
    y = xf / np.sqrt((xf**2).mean(-1, keepdims=True) + 1e-5) * g + be
    act_scale = np.float32(np.abs(y).max() / 127.0)
    aq = _qkv_scales(y @ w + bias)
    kw = dict(attn_scales=jnp.asarray(aq)) if branch == "static" else dict(quant_attn=True)
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(act_scale), h, kv_len, sm, **kw), np.float32)
    args = (_t(x), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    w_q, s_col = tq.quantize_weight(args[3])
    if branch == "static":
        got = ln_qkv_attention_int8_static_plain(*args[:3], w_q, s_col, args[4], args[5],
                                                 torch.from_numpy(aq), h, kv_len, sm)
    else:
        got = ln_qkv_attention_int8_dynamic_plain(*args[:3], w_q, s_col, args[4], args[5], h, kv_len,
                                                  sm, block_b=1)
    assert_close_max_median(got.numpy()[:, :kv_len], want[:, :kv_len])


def test_dynamic_scales_group_tiles_and_head_pairs():
    """One scale per tile of block_b windows and head for q and v, per head
    pair for k; a last tile of fewer windows keeps its own."""
    qkv = torch.zeros(3, 4, 3 * 256)
    for b in range(3):
        for p in range(3):
            for h in range(4):
                qkv[b, 1, p * 256 + h * 64] = 1 + b + 10 * p + 100 * h
    s = dynamic_attn_scales(qkv, 4, block_b=2) * 127.0
    assert s.shape == (3, 4, 3)
    for b, tile_max in ((0, 1), (1, 1), (2, 2)):
        for h in range(4):
            pair = h | 1
            expect = [1 + tile_max + 100 * h, 1 + tile_max + 10 + 100 * pair, 1 + tile_max + 20 + 100 * h]
            np.testing.assert_allclose(s[b, h].numpy(), expect, rtol=1e-6)


# ---- one trunk block -----------------------------------------------------------------


def _jax_block(quant_attn, mode="static", **kw):
    dense = functools.partial(jq.Int8Dense, quant_mode=mode)
    return JaxBlock(num_heads=H, fused_qkv=True, kv_len=L, quant_int8=True, quant_mode=mode,
                    dense_cls=dense, quant_attn=quant_attn, **kw)


@pytest.fixture(scope="module")
def block_setup():
    """A JAX block's weights and its calibration (on its dynamic twin), the
    port's weights and quant state carried across by models/convert.py."""
    x = np.random.default_rng(5).normal(size=(1, L, D)).astype(np.float32)
    v = dict(_jax_block(True).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    dyn = _jax_block(False, "dynamic")
    v = jq.calibrate_int8(lambda vv, bb: dyn.apply(vv, bb, mutable=["quant"]), v, [jnp.asarray(x)])
    sd = {}
    _resblocks(sd, {"resblock_0": jax.tree_util.tree_map(np.asarray, v["params"])})
    weights = {k[len("transformer."):]: t for k, t in sd.items()}
    prefix = "image_encoder.transformer."
    state = {k[len(prefix):]: t for k, t in quant_state_from_jax(
        {"image_encoder": {"resblock_0": jax.tree_util.tree_map(np.asarray, v["quant"])}},
        decoder_cfg=()).items()}
    return x, v, weights, state


def _port_block(weights, state, quant_attn, fuse_ln_mode="auto"):
    m = Transformer(D, 1, H, attn_backend="fused", quant_int8=True, quant_mode="static",
                    quant_attn=quant_attn, fuse_ln_mode=fuse_ln_mode)
    m.load_state_dict(weights)
    if state is not None:
        tq.load_quant_state(m, state)
    return m.eval().resblocks[0]


@pytest.mark.parametrize("quant_attn", [True, "xla"])
def test_block_with_quant_attn_matches_jax(block_setup, quant_attn):
    x, v, weights, state = block_setup
    want = np.asarray(_jax_block(quant_attn).apply(v, jnp.asarray(x)), np.float32)
    block = _port_block(weights, state, quant_attn)
    assert block.route(_t(x), None, None, False) == "fused"
    assert block.fuse_ln() is (quant_attn is True)
    before = (fused_ln_qkv_attention_int8.launches_static, fused_ln_qkv_attention_int8.launches)
    with torch.no_grad():
        got = block(_t(x)).numpy()
    assert (fused_ln_qkv_attention_int8.launches_static, fused_ln_qkv_attention_int8.launches) == before
    assert_close_max_median(got, want)
    # the two modes differ only in rounding: as close as the JAX package holds them
    other = np.asarray(_jax_block("xla" if quant_attn is True else True).apply(v, jnp.asarray(x)),
                       np.float32)
    assert np.median(np.abs(got - other)) < 0.02 * np.abs(other).max()


def test_quant_attn_routing_keeps_float_attention_off_the_fused_ln_route(block_setup):
    """quant_attn=True changes nothing where the block does not take the
    fused LN route (fuse_ln_mode="off" here), as in the JAX package; "xla"
    still takes the int8 attention there."""
    x, v, weights, state = block_setup
    want = np.asarray(_jax_block(True, fuse_ln_mode="off").apply(v, jnp.asarray(x)), np.float32)
    off = _port_block(weights, state, True, fuse_ln_mode="off")
    assert not off.fuse_ln()
    with torch.no_grad():
        got = off(_t(x))
        plain = _port_block(weights, state, False, fuse_ln_mode="off")(_t(x))
        xla_off = _port_block(weights, state, "xla", fuse_ln_mode="off")(_t(x))
        xla = _port_block(weights, state, "xla")(_t(x))
    assert torch.equal(got, plain)
    assert_close_max_median(got.numpy(), want)
    assert torch.equal(xla_off, xla) and not torch.equal(xla, plain)


def test_quant_attn_values_and_uncalibrated_scales_raise(block_setup):
    x, _, weights, state = block_setup
    for ok in (False, True, "xla"):
        check_quant_args("static", ok)
    for bad in ("kernel", "bogus", 1, None):
        with pytest.raises(ValueError, match="quant_attn"):
            check_quant_args("static", bad)
    zero = dict(state, **{"resblocks.0.attn.qkv_amax": torch.zeros(3)})
    for quant_attn in (True, "xla"):
        block = _port_block(weights, zero, quant_attn)
        with torch.no_grad(), pytest.raises(RuntimeError, match="qkv_amax"):
            block(_t(x))
    with pytest.raises(ValueError, match="qkv_amax"):
        tq.validate_quant_scales({"a.act_amax": torch.ones(()), "a.qkv_amax": torch.zeros(3)},
                                 quant_attn=True)
    tq.validate_quant_scales({"a.act_amax": torch.ones(()), "a.qkv_amax": torch.zeros(3)})
    assert QUANT_ATTN == {"kernel": True, "xla": "xla", None: False}


# ---- the slice: a two-block CLIP-EBC through the Evaluator ---------------------------

WINDOW, SIZE = 64, (96, 144)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
ARGS = types.SimpleNamespace(model="clip_vit_b_16", input_size=WINDOW, reduction=8,
                             window_size=WINDOW)
EVAL_KW = dict(reduction=8, sliding_window=True, window_size=WINDOW, stride=WINDOW,
               pad_to_multiple=16)


@pytest.fixture(scope="module")
def two_blocks():
    """Both packages build ViT-B/16 at its width with two trunk blocks."""
    cfg = (16, 768, 2, 12, 512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_image_encoder.VIT_CONFIGS, "vit_b_16", cfg)
        mp.setitem(port_image_encoder.VIT_CONFIGS, "vit_b_16", cfg)
        yield


@pytest.fixture(scope="module")
def slice_setup(two_blocks):
    rng = np.random.default_rng(3)
    images = [((rng.integers(0, 256, SIZE + (3,)) / 255.0 - 0.45) / 0.225).astype(np.float32)
              for _ in range(2)]
    port = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, seed=0, device="cpu")
    weights = port.state_dict()
    params, stats = jax_convert.convert_reference_clip_ebc(weights)
    # calibrated on the unpadded trunk ("auto" on the CPU): the fused route
    # pads the sequence to a multiple of 16, and the padded rows would enter
    # the recorded maxima of the later blocks; the variable tree is the same
    kw = dict(num_vpt=32, dtype=jnp.float32, quant_int8=True, quant_attn=True)
    variables = jax_calibrate_static(ARGS, kw, BINS, ANCHORS,
                                     {"params": params, "batch_stats": stats}, images)
    return images, weights, variables


@pytest.mark.parametrize("mode", ["kernel", "xla"])
def test_slice_counts_match_jax_evaluator(slice_setup, mode):
    images, weights, variables = slice_setup
    quant_attn = QUANT_ATTN[mode]
    jmodel = jax_get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, dtype=jnp.float32,
                           num_vpt=32, quant_int8=True, quant_mode="static",
                           attn_backend="fused", quant_attn=quant_attn)
    want = np.asarray(JaxEvaluator(jmodel, **EVAL_KW).predict_density(variables, images[0]))

    kw = dict(num_vpt=32, dtype=torch.float32, device="cpu", quant_int8=True,
              attn_backend="fused", quant_attn=quant_attn)
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, quant_mode="static", **kw)
    model.load_state_dict(weights)
    # the port's own calibration (its CLI's recipe) records the JAX tree
    calibrate_static_int8(ARGS, kw, BINS, ANCHORS, model, images)
    jax_state = quant_state_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables["quant"])))
    own = tq.quant_state(model)
    assert sorted(own) == sorted(jax_state) and len(own) == 2 * 5 + 2
    for k in own:
        rtol = 1e-4 if ".resblocks.0." in k else 2e-2
        np.testing.assert_allclose(own[k].numpy(), jax_state[k].numpy(), rtol=rtol, err_msg=k)
    # on the same scales: the density and the count
    tq.load_quant_state(model, jax_state)
    got = Evaluator(model, **EVAL_KW).predict_density(images[0]).numpy()
    assert got.shape == (SIZE[0] // 8, SIZE[1] // 8)
    assert_close_max_median(got, want)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=2e-3)
    # the two modes: within the JAX package's 2e-2 of each other
    other = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, quant_mode="static",
                      **dict(kw, quant_attn=QUANT_ATTN["xla" if mode == "kernel" else "kernel"]))
    other.load_state_dict(weights)
    tq.load_quant_state(other, jax_state)
    count = Evaluator(other, **EVAL_KW).predict_count(images[0])
    assert abs(count - got.sum()) <= 2e-2 * abs(got.sum())


@pytest.mark.parametrize("flags", [["--quant_attn"], ["--quant_attn", "xla"]])
def test_predict_cli_runs_quant_attn_on_the_cpu(two_blocks, tmp_path, flags):
    """The predict CLI with ``--quant int8_static --quant_attn [xla]`` and
    ``--device cpu`` (seeded weights, its own calibration) writes the count
    the Evaluator gives the same model, calibrated by the same recipe."""
    rng = np.random.default_rng(4)
    for i in range(2):
        np.save(tmp_path / f"{i}.npy", rng.integers(0, 256, SIZE + (3,), dtype=np.uint8))
    images = [normalize_image(_load_image(str(tmp_path / f"{i}.npy"))) for i in range(2)]
    out = tmp_path / "counts.csv"
    predict.main([str(tmp_path), "--device", "cpu", "--sliding_window", "--window_size",
                  str(WINDOW), "--stride", str(WINDOW), "--seed", "3", "--quant", "int8_static",
                  "--calib_images", "2", "--out", str(out), *flags])
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == ["0.npy", "1.npy"]
    kw = dict(num_vpt=32, dtype=torch.float32, device="cpu", quant_int8=True, seed=3,
              quant_attn=QUANT_ATTN[flags[1] if len(flags) > 1 else "kernel"])
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, quant_mode="static", **kw)
    calibrate_static_int8(ARGS, kw, BINS, ANCHORS, model, images)
    want = Evaluator(model, **EVAL_KW).predict_count(images[0])
    np.testing.assert_allclose(float(rows[0][1]), want, rtol=1e-5, atol=0.01)
