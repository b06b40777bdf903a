"""The port's flagship inference slice against the JAX package end to end:
CLIP-EBC ViT-B/16 at its real width (12 layers, deep VPT-32, the 12-layer
text tower, the 768-channel decoder) with tiny windows (64 px, stride 32)
on a 96 x 144 image, so the last window column is edge-clamped.

The weights are the port's seeded random init, carried into the JAX
package through its own ``convert_reference_clip_ebc``. The JAX side runs
its default ``auto`` paths on the CPU (einsum attention, unfused head).

Tolerances on the density maps: fp32 1e-3 (12 layers of fp32 summation
in another order); bf16 2e-2 (the JAX package's bf16 kernel tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.data.crowd import _load_image as jax_load_image
from clip_ebc_tpu.data.crowd import normalize_image as jax_normalize
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.training.evaluate import Evaluator

torch.set_num_threads(2)
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
WINDOW, STRIDE, SIZE = 64, 32, (96, 144)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")


@pytest.fixture(scope="module")
def port_weights():
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, seed=0, device="cpu")
    return model.state_dict()


@pytest.fixture(scope="module")
def jax_variables(port_weights):
    params, stats = jax_convert.convert_reference_clip_ebc(port_weights)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_evaluators(jax_variables):
    """One JAX Evaluator per (dtype, decoder order), built on first use so
    each jit compiles once per module."""
    cache = {}

    def get(dtype, before=False):
        if (dtype, before) not in cache:
            model = jax_get_model(
                "clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, dtype=getattr(jnp, dtype),
                num_vpt=32, decoder_before_upsample=before,
            )
            cache[dtype, before] = JaxEvaluator(
                model, reduction=8, sliding_window=True, window_size=WINDOW, stride=STRIDE,
                pad_to_multiple=16,
            )
        return cache[dtype, before]

    return get


def _image(seed):
    return np.random.default_rng(seed).normal(size=SIZE + (3,)).astype(np.float32)


def _port_evaluator(port_weights, dtype, **kw):
    model = get_model("clip_vit_b_16", WINDOW, 8, BINS, ANCHORS, num_vpt=32,
                      dtype=getattr(torch, dtype), device="cpu", **kw)
    model.load_state_dict(port_weights)
    return Evaluator(model, reduction=8, sliding_window=True, window_size=WINDOW,
                     stride=STRIDE, pad_to_multiple=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paths", [
    {},  # "auto": the plain torch paths on CPU tensors
    {"attn_backend": "fused", "fused_head": "on"},  # the kernels' plain versions
])
def test_sliding_window_density_matches_jax(port_weights, jax_variables, jax_evaluators,
                                            dtype, paths):
    image = _image(1)
    want = np.asarray(jax_evaluators(dtype).predict_density(jax_variables, image))
    got = _port_evaluator(port_weights, dtype, **paths).predict_density(image).numpy()
    assert got.shape == want.shape == (SIZE[0] // 8, SIZE[1] // 8)
    assert np.isfinite(got).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_decoder_before_upsample_matches_jax(port_weights, jax_variables, jax_evaluators):
    image = _image(2)
    want = np.asarray(jax_evaluators("float32", True).predict_density(jax_variables, image))
    got = _port_evaluator(port_weights, "float32", decoder_before_upsample=True)
    np.testing.assert_allclose(got.predict_density(image).numpy(), want, rtol=1e-3, atol=1e-3)


def test_predict_cli_with_jax_weights_matches_jax(port_weights, jax_variables, jax_evaluators,
                                                  tmp_path):
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        np.save(img_dir / f"{i}.npy", rng.integers(0, 256, SIZE + (3,), dtype=np.uint8))
    # the prepared-tree format (save_prepared_tree's keys), written without
    # compression: deflating the full model's random weights takes a minute
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **jax_convert._flatten_tree(jax_variables["params"], "params"),
             **jax_convert._flatten_tree(jax_variables["batch_stats"], "stats"))
    out = tmp_path / "counts.csv"
    predict.main([
        str(img_dir), "--device", "cpu", "--sliding_window", "--window_size", str(WINDOW),
        "--stride", str(STRIDE), "--weight_path", weights, "--seed", "7", "--out", str(out),
    ])
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == ["0.npy", "1.npy"]
    ev = jax_evaluators("float32")
    for name, count in rows:
        image = jax_normalize(jax_load_image(str(img_dir / name)))
        want = ev.predict_count(jax_variables, image)
        np.testing.assert_allclose(float(count), want, rtol=1e-3, atol=0.01)


@pytest.mark.parametrize("extra,error", [
    (["--quant", "int8", "--quant_attn", "xla"], SystemExit),  # int8 attention needs static scales
    (["--packed_eval"], SystemExit),  # needs --sliding_window, as the JAX CLI says
    (["--pretrained", "clip.pt"], FileNotFoundError),  # accepted; the file is missing
    (["--quant_attn"], SystemExit),  # needs --quant int8_static, as the JAX CLI says
    (["--allow_byte_tokenizer"], SystemExit),  # accepted; the image directory is empty
])
def test_predict_cli_rejects_unported_options(tmp_path, extra, error):
    with pytest.raises(error):
        predict.main([str(tmp_path), "--device", "cpu", *extra])
