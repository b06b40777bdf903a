"""The port's W8A8 inference slice against the JAX package end to end:
CLIP-EBC ViT-B/16 at its real width (12 layers, deep VPT-32, the
768-channel decoder) with 64 px windows at stride 64 on 96 x 144 images,
so the last window row and column are edge-clamped and overlap.

The weights are the port's seeded random init, carried into the JAX
package through its own ``convert_reference_clip_ebc``. Both packages
calibrate their static scales themselves, with their own
``calibrate_static_int8``, on the same two images. The JAX side runs its
default ``auto`` paths on the CPU (unfused ``Int8Dense`` projections,
einsum attention); the port runs once on its ``auto`` paths and once with
``attn_backend="fused"``, which takes the plain versions of the two int8
slice kernels (the tensors are CPU tensors).

Tolerances. Calibrated max-abs trees (fp32): rtol 1e-4 in the first
block, where only the summation order differs; 2e-2 everywhere, because
the calibration twin is the *dynamic* model: one flipped int8 step of a
row (1/127 of its range) moves a later layer's maximum by up to ~1e-3, and
the flips compound through 12 blocks (measured: up to 1.0e-2 at the last
block and the decoder). Density maps on the same scales: max 2e-2 and
median 2e-3 of the largest density in fp32 (int8 rounding turns a
last-place difference into a one-step flip, and through 12 quantized
blocks and the decoder the flips reach every output: measured medians 1.0e-3
to 1.2e-3, where one module or block alone stays under 1e-3; a wrong
scale or fold moves the median by far more), median 4e-3 in bf16 (one bf16
step, 2^-8). With each package on its own calibration the scales differ
by up to that 1e-2, so the median limit is 3e-3. Counts: 2e-3. Int8 against the unquantized
model: the JAX package's own 8% of the count.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.cli._common import calibrate_static_int8 as jax_calibrate_static
from clip_ebc_tpu.data.crowd import _load_image as jax_load_image
from clip_ebc_tpu.data.crowd import normalize_image as jax_normalize
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli._common import calibrate_static_int8
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.convert import quant_state_from_jax, quant_state_to_jax
from clip_ebc_tpu_torch.ops.quant import load_quant_state, quant_state
from clip_ebc_tpu_torch.training.evaluate import Evaluator

torch.set_num_threads(2)
WINDOW, STRIDE, SIZE = 64, 64, (96, 144)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
ARGS = types.SimpleNamespace(model="clip_vit_b_16", input_size=WINDOW, reduction=8,
                             window_size=WINDOW)
EVAL_KW = dict(reduction=8, sliding_window=True, window_size=WINDOW, stride=STRIDE,
               pad_to_multiple=16)


def assert_close_max_median(got, want, max_tol=2e-2, med_tol=2e-3):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff, top = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= max_tol * top, (diff.max(), top)
    assert np.median(diff) <= med_tol * top, (np.median(diff), top)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(3)
    for i in range(2):
        np.save(d / f"{i}.npy", rng.integers(0, 256, SIZE + (3,), dtype=np.uint8))
    return d


@pytest.fixture(scope="module")
def images(image_dir):
    return [jax_normalize(jax_load_image(str(image_dir / f"{i}.npy"))) for i in range(2)]


@pytest.fixture(scope="module")
def port_weights():
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, seed=0, device="cpu")
    return model.state_dict()


@pytest.fixture(scope="module")
def jax_variables(port_weights):
    params, stats = jax_convert.convert_reference_clip_ebc(port_weights)
    return {"params": params, "batch_stats": stats}


def _jax_evaluator(dtype, **kw):
    model = jax_get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, dtype=getattr(jnp, dtype),
                          num_vpt=32, **kw)
    return JaxEvaluator(model, **EVAL_KW)


@pytest.fixture(scope="module")
def jax_static(jax_variables, images):
    """The JAX package's int8_static recipe in fp32: variables with the
    calibrated ``quant`` collection, and the densities of both images."""
    kw = dict(num_vpt=32, dtype=jnp.float32, quant_int8=True)
    variables = jax_calibrate_static(ARGS, kw, BINS, ANCHORS, dict(jax_variables), images)
    ev = _jax_evaluator("float32", quant_int8=True, quant_mode="static")
    densities = [np.asarray(ev.predict_density(variables, im)) for im in images]
    return variables, densities


def _port_model(port_weights, dtype="float32", **kw):
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, num_vpt=32,
                      dtype=getattr(torch, dtype), device="cpu", **kw)
    model.load_state_dict(port_weights)
    return model


@pytest.mark.parametrize("paths", [
    {},  # "auto": the unfused int8 layers and plain attention on CPU tensors
    {"attn_backend": "fused", "fused_head": "on"},  # the kernels' plain versions
])
def test_static_fp32_density_and_calibration_match_jax(port_weights, jax_static, images, paths):
    variables, want = jax_static
    kw = dict(quant_int8=True, dtype=torch.float32, num_vpt=32, device="cpu", **paths)
    model = _port_model(port_weights, quant_int8=True, quant_mode="static", **paths)
    calibrate_static_int8(ARGS, kw, BINS, ANCHORS, model, images)
    state = quant_state(model)
    assert len(state) == 12 * 5 + 2 and all(bool((v > 0).all()) for v in state.values())
    got_tree = jax.tree_util.tree_leaves_with_path(quant_state_to_jax(state))
    want_tree = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, dict(variables["quant"])))
    assert [p for p, _ in got_tree] == [p for p, _ in want_tree]
    for (path, a), (_, b) in zip(got_tree, want_tree):
        name = jax.tree_util.keystr(path)
        rtol = 1e-4 if "'resblock_0'" in name else 2e-2
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name)
    evaluator = Evaluator(model, **EVAL_KW)
    got = evaluator.predict_density(images[0]).numpy()
    assert got.shape == (SIZE[0] // 8, SIZE[1] // 8)
    assert_close_max_median(got, want[0], med_tol=3e-3)  # each on its own calibration
    load_quant_state(model, quant_state_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(variables["quant"]))))
    assert_close_max_median(evaluator.predict_density(images[0]).numpy(), want[0])  # same scales


def test_static_bf16_density_matches_jax(port_weights, jax_static, images):
    """bf16 compute, both packages on the scales the JAX fp32 calibration
    recorded (carried across through the quant-state bridge)."""
    variables, _ = jax_static
    want = np.asarray(_jax_evaluator("bfloat16", quant_int8=True, quant_mode="static")
                      .predict_density(variables, images[0]))
    state = quant_state_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables["quant"])))
    for paths in ({}, {"attn_backend": "fused", "fused_head": "on"}):
        model = _port_model(port_weights, "bfloat16", quant_int8=True, quant_mode="static", **paths)
        load_quant_state(model, state)
        got = Evaluator(model, **EVAL_KW).predict_density(images[0]).numpy()
        assert_close_max_median(got, want, med_tol=4e-3)


def test_dynamic_int8_density_matches_jax(port_weights, jax_variables, images):
    want = np.asarray(_jax_evaluator("float32", quant_int8=True)
                      .predict_density(jax_variables, images[0]))
    for paths in ({}, {"attn_backend": "fused", "fused_head": "on"}):
        model = _port_model(port_weights, quant_int8=True, **paths)
        got = Evaluator(model, **EVAL_KW).predict_density(images[0]).numpy()
        assert_close_max_median(got, want)


def test_predict_cli_int8_static_matches_jax(image_dir, jax_variables, jax_static, tmp_path):
    _, want = jax_static
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **jax_convert._flatten_tree(jax_variables["params"], "params"),
             **jax_convert._flatten_tree(jax_variables["batch_stats"], "stats"))
    out = tmp_path / "counts.csv"
    predict.main([
        str(image_dir), "--device", "cpu", "--sliding_window", "--window_size", str(WINDOW),
        "--stride", str(STRIDE), "--weight_path", weights, "--seed", "7",
        "--quant", "int8_static", "--calib_images", "2", "--out", str(out),
    ])
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == ["0.npy", "1.npy"]
    for (_, count), density in zip(rows, want):
        np.testing.assert_allclose(float(count), density.sum(), rtol=2e-3, atol=0.01)


def test_int8_count_stays_close_to_unquantized(port_weights, jax_static, images):
    variables, _ = jax_static
    base = Evaluator(_port_model(port_weights), **EVAL_KW).predict_count(images[1])
    static = _port_model(port_weights, quant_int8=True, quant_mode="static")
    load_quant_state(static, quant_state_from_jax(
        jax.tree_util.tree_map(np.asarray, dict(variables["quant"]))))
    dynamic = _port_model(port_weights, quant_int8=True)
    for model in (static, dynamic):
        count = Evaluator(model, **EVAL_KW).predict_count(images[1])
        assert abs(count - base) <= 0.08 * max(abs(base), 1.0), (base, count)


def test_quant_buffers_stay_out_of_the_state_dict_and_uncalibrated_static_raises(port_weights, images):
    model = _port_model(port_weights, quant_int8=True, quant_mode="static")
    assert sorted(model.state_dict()) == sorted(port_weights)
    assert len(quant_state(model)) == 62
    params, stats = jax_convert.convert_reference_clip_ebc(model.state_dict())  # still converts
    assert "quant" not in params and set(params) >= {"image_encoder", "image_decoder"}
    with pytest.raises(RuntimeError, match="uncalibrated activation scale"):
        Evaluator(model, **EVAL_KW).predict_density(images[0])
    # quant_attn builds (the same quant state: qkv_amax is always recorded);
    # a value outside False, True, "xla" is refused
    assert sorted(quant_state(_port_model(port_weights, quant_int8=True, quant_mode="static",
                                          quant_attn=True))) == sorted(quant_state(model))
    with pytest.raises(ValueError, match="quant_attn"):
        _port_model(port_weights, quant_int8=True, quant_mode="static", quant_attn="bogus")
