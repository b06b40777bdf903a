"""The port's transformer, text-tower and decoder pieces against the JAX
package at narrow widths (D=128, H=2), on the same numpy-seeded weights
and inputs.

Tolerances: fp32 1e-4 (same math, other summation order); bf16 2e-2, the
JAX package's own kernel tolerance; the pure resizes 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models.blocks import BasicBlock as JaxBasicBlock
from clip_ebc_tpu.models.blocks import resize_bilinear as jax_resize_bilinear
from clip_ebc_tpu.models.clip.prompts import bin_prompts as jax_bin_prompts
from clip_ebc_tpu.models.clip.text_encoder import ClipTextEncoder as JaxText
from clip_ebc_tpu.models.clip.tokenizer import tokenize as jax_tokenize
from clip_ebc_tpu.models.transformer import PatchifyMatmul as JaxPatchify
from clip_ebc_tpu.models.transformer import ResidualAttentionBlock as JaxBlock
from clip_ebc_tpu.models.transformer import interpolate_pos_embed as jax_interp
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models.blocks import BasicBlock, resize_bilinear
from clip_ebc_tpu_torch.models.clip.prompts import bin_prompts
from clip_ebc_tpu_torch.models.clip.text_encoder import ClipTextEncoder
from clip_ebc_tpu_torch.models.clip.tokenizer import tokenize
from clip_ebc_tpu_torch.models.convert import _resblocks, basic_block_state, clip_text_state
from clip_ebc_tpu_torch.models.transformer import (
    PatchifyMatmul,
    ResidualAttentionBlock,
    Transformer,
    interpolate_pos_embed,
)

torch.set_num_threads(2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _fill(tree, seed):
    """Replace every leaf of a JAX variable tree with seeded values of a
    sensible scale: kernels ~ 1/sqrt(fan_in), LN/BN scales ~ 1, BN
    variances > 0, everything else small."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = np.shape(x)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * fan_in**-0.5).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _load(module, sd):
    module.load_state_dict({k: v for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["sdpa", "fused"])
@pytest.mark.parametrize("kv_len", [37, 33])
def test_residual_block_matches_jax(kv_len, backend, dtype):
    b, l, d, h = 3, 37, 128, 2
    x = np.random.default_rng(kv_len).normal(size=(b, l, d)).astype(np.float32)
    jblock = JaxBlock(num_heads=h, dtype=getattr(jnp, dtype), kv_len=kv_len)
    params = _fill(jblock.init(jax.random.PRNGKey(0), jnp.zeros((1, l, d)))["params"], seed=1)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype))),
                      np.float32)

    sd = {}
    _resblocks(sd, {"resblock_0": params})
    port = _load(Transformer(d, 1, h, attn_backend=backend), {
        k[len("transformer."):]: v for k, v in sd.items()
    }).resblocks[0]
    assert isinstance(port, ResidualAttentionBlock)
    assert (port.route(torch.zeros(1, l, d), None, kv_len, False) == "fused") == (backend == "fused")
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(getattr(torch, dtype)), kv_len=kv_len).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got[:, :kv_len], want[:, :kv_len], rtol=tol, atol=tol)


def test_tokens_and_prompts_match_jax():
    for trunc in (2, 4, 11):
        bins, _ = get_bins_and_anchors(8, trunc, "qnrf")
        for kind in ("word", "number"):
            prompts = bin_prompts(bins, kind)
            assert prompts == jax_bin_prompts(bins, kind)
            np.testing.assert_array_equal(tokenize(list(prompts)), jax_tokenize(list(prompts)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_matches_jax(dtype):
    bins, _ = get_bins_and_anchors(8, 4, "qnrf")
    tokens = tokenize(list(bin_prompts(bins)))
    jtext = JaxText(embed_dim=64, width=128, heads=2, layers=2, dtype=getattr(jnp, dtype))
    params = _fill(jtext.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"], seed=2)
    want = np.asarray(jtext.apply({"params": params}, jnp.asarray(tokens)), np.float32)
    port = _load(ClipTextEncoder(64, width=128, heads=2, layers=2, dtype=getattr(torch, dtype)),
                 clip_text_state(params))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("new", [2, 5])
def test_interpolate_pos_embed_matches_jax(new):
    pos = np.random.default_rng(new).normal(size=(1 + 14 * 14, 32)).astype(np.float32)
    want = np.asarray(jax_interp(jnp.asarray(pos), (14, 14), (new, new)))
    got = interpolate_pos_embed(torch.from_numpy(pos), (14, 14), (new, new)).numpy()
    assert got.shape == (1 + new * new, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_bilinear_matches_jax_image_resize():
    x = np.random.default_rng(0).normal(size=(2, 7, 5, 6)).astype(np.float32)  # NHWC
    want = np.asarray(jax_resize_bilinear(jnp.asarray(x), 2.0))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 2.0).permute(0, 2, 3, 1)
    assert got.shape == (2, 14, 10, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_patchify_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 32, 48, 3)).astype(np.float32)
    jmod = JaxPatchify(features=32, patch=16, use_bias=False)
    params = _fill(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed=3)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    port = PatchifyMatmul(32, 16)
    port.weight.data = torch.from_numpy(np.ascontiguousarray(params["kernel"].transpose(3, 2, 0, 1)))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 6, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels", [(16, 16), (16, 32)])  # identity and 1x1 shortcut
def test_basic_block_matches_jax(channels):
    cin, cout = channels
    x = np.random.default_rng(cout).normal(size=(2, 8, 8, cin)).astype(np.float32)
    jmod = JaxBasicBlock(cout)
    variables = _fill(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    port = _load(BasicBlock(cin, cout),
                 basic_block_state(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
