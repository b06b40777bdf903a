"""Full-image inference in the port against the JAX package: the flash
route of a block and of the text tower, the routing table, the whole
CLIP-EBC ViT-B/16 on an image above 512 tokens, and the guard that the
full image is not attended causally.

The JAX package's ``flash_sdpa`` needs a TPU, and on the TPU it takes
any mask for the causal one (ROADMAP Queue 3), so the port is held
against it where it is right: the Pallas kernel in interpret mode through
the adapter of ``tests/test_flash_attention.py`` (a block, the text
tower), and ``attn_backend="sdpa"`` (the whole model). Inputs and weights
come from numpy seeds and the port's seeded init. Tolerances: blocks 1e-4
in fp32 (that of ``tests/test_torch_transformer.py``) and 3e-2 in bf16
(that of ``tests/test_flash_attention.py``: at L = 600 one bf16 step of an
intermediate lands on the other side in a few elements, and the two
packages' plain "sdpa" blocks differ by as much); the model's count 1e-4
relative in fp32 (12 layers summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip.text_encoder import ClipTextEncoder as JaxText
from clip_ebc_tpu.models.transformer import ResidualAttentionBlock as JaxBlock
from clip_ebc_tpu.ops.flash_attention import flash_attention as jax_flash
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models import transformer as tr
from clip_ebc_tpu_torch.models.clip.prompts import bin_prompts
from clip_ebc_tpu_torch.models.clip.text_encoder import ClipTextEncoder
from clip_ebc_tpu_torch.models.clip.tokenizer import tokenize
from clip_ebc_tpu_torch.models.convert import _resblocks, clip_text_state
from clip_ebc_tpu_torch.ops import flash_attention as fa
from clip_ebc_tpu_torch.training.evaluate import Evaluator

torch.set_num_threads(2)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _flash_interp(q, k, v, mask):
    """The JAX test suite's interpret-mode adapter: a mask means causal."""
    return jax_flash(q, k, v, None, mask is not None, 128, 128, True)


def _fill(tree, seed):
    """Seeded leaves of a sensible scale: matrices ~ 1/sqrt(fan_in), LN
    scales ~ 1, the rest small."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        shape = np.shape(x)
        if str(path[-1].key) == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) >= 2:
            return (rng.standard_normal(shape) * int(np.prod(shape[:-1])) ** -0.5).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(np.asarray, tree))


def _port_block(params, d, h, backend="flash"):
    sd = {}
    _resblocks(sd, {"resblock_0": params})
    port = tr.Transformer(d, 1, h, attn_backend=backend)
    port.load_state_dict({k[len("transformer."):]: v for k, v in sd.items()}, strict=True)
    return port.eval().resblocks[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l", [197, 600])  # the short route, the tiled route
def test_flash_block_matches_jax_block(l, dtype):
    b, d, h = 2, 128, 2
    x = np.random.default_rng(l).normal(size=(b, l, d)).astype(np.float32)
    jblock = JaxBlock(num_heads=h, dtype=getattr(jnp, dtype), attn_impl=_flash_interp)
    params = _fill(jblock.init(jax.random.PRNGKey(0), jnp.zeros((1, l, d)))["params"], seed=1)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x, getattr(jnp, dtype))),
                      np.float32)
    port = _port_block(params, d, h)
    assert port.route(torch.zeros(1, l, d), None, None, False) == "flash"
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_text_tower_matches_jax(dtype):
    """``attn_backend="flash"``: the text tower's blocks take the short
    route with ``causal=True``, as the JAX tower with ``flash_sdpa`` does."""
    bins, _ = get_bins_and_anchors(8, 4, "qnrf")
    tokens = tokenize(list(bin_prompts(bins)))
    jtext = JaxText(embed_dim=64, width=128, heads=2, layers=2, dtype=getattr(jnp, dtype),
                    attn_impl=_flash_interp)
    params = _fill(jtext.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"], seed=2)
    want = np.asarray(jtext.apply({"params": params}, jnp.asarray(tokens)), np.float32)
    port = ClipTextEncoder(64, width=128, heads=2, layers=2, dtype=getattr(torch, dtype),
                           attn_backend="flash")
    port.load_state_dict(clip_text_state(params), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(tokens).long()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("backend,device,l,mask,want", [
    ("auto", "cuda", 320, "none", "fused"),  # the fused kernel's longest sequence
    ("auto", "cuda", 321, "none", "plain"),
    ("auto", "cuda", 1023, "none", "plain"),
    ("auto", "cuda", 1024, "none", "flash"),  # FLASH_MIN_SEQ_LEN: the full image
    ("auto", "cuda", 24609, "none", "flash"),  # the flagship 2048 x 3072 image
    ("auto", "cpu", 24609, "none", "plain"),
    ("auto", "cuda", 229, "padding", "fused"),  # the fused kernel masks keys itself
    ("auto", "cuda", 2000, "padding", "plain"),
    ("auto", "cuda", 77, "causal", "plain"),  # the text tower stays plain, as on the TPU
    ("flash", "cuda", 229, "none", "flash"),  # windows
    ("flash", "cpu", 229, "none", "flash"),
    ("flash", "cuda", 77, "causal", "flash"),  # the text tower, causal=True
    ("flash", "cuda", 2000, "padding", "plain"),  # kv_len < L: no key-padding on the flash path
    ("flash", "cuda", 77, "other", "plain"),
    ("fused", "cpu", 229, "none", "fused"),
    ("fused", "cuda", 77, "causal", "plain"),
    ("sdpa", "cuda", 24609, "none", "plain"),
])
def test_attention_route_table(backend, device, l, mask, want):
    assert tr.attention_route(backend, device, l, mask) == want


def test_flash_route_with_short_keys_takes_the_plain_path():
    """A block asked for kv_len < L under "flash" masks the padded keys on
    the plain path, equal to the "sdpa" block."""
    d, h, l, kv = 128, 2, 40, 33
    jblock = JaxBlock(num_heads=h)
    params = _fill(jblock.init(jax.random.PRNGKey(0), jnp.zeros((1, l, d)))["params"], seed=3)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, l, d)).astype(np.float32))
    flash, sdpa = _port_block(params, d, h), _port_block(params, d, h, "sdpa")
    assert flash.route(x, None, kv, False) == "plain"
    with torch.no_grad():
        torch.testing.assert_close(flash(x, kv_len=kv)[:, :kv], sdpa(x, kv_len=kv)[:, :kv])


def test_full_image_path_is_not_causal(monkeypatch):
    """On the card, "auto" sends a full image's trunk (L >= 1024, no mask,
    no padding) to the tiled flash kernel. Here that route is forced by
    reading every device as "cuda", so CPU tensors take the tiled plain
    version. Changing the last token must change the first token's output
    (a causal pass leaves it bit for bit), and the result must equal the plain
    bidirectional attention."""
    route = tr.attention_route
    monkeypatch.setattr(tr, "attention_route", lambda b, dev, *a: route(b, "cuda", *a))
    calls = []
    tiled = fa.flash_tiled_plain
    monkeypatch.setattr(fa, "flash_tiled_plain", lambda *a: calls.append(a[4]) or tiled(*a))
    d, h, l = 128, 2, 1100
    jblock = JaxBlock(num_heads=h)
    params = _fill(jblock.init(jax.random.PRNGKey(0), jnp.zeros((1, l, d)))["params"], seed=5)
    block = _port_block(params, d, h, "auto")
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, l, d)).astype(np.float32))
    x2 = x.clone()
    x2[:, -1] = 4.0 * torch.from_numpy(np.random.default_rng(7).normal(size=d).astype(np.float32))
    with torch.no_grad():
        y, y2 = block(x), block(x2)
        want = _port_block(params, d, h, "sdpa")(x)
    assert calls == [False, False]  # two tiled passes, neither causal
    assert (y[:, 0] - y2[:, 0]).abs().max() > 1e-4
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


def test_clip_ebc_full_image_count_matches_jax(monkeypatch):
    """CLIP-EBC ViT-B/16 at full width (12 layers, deep VPT-32, the text
    tower, the 768-channel decoder) on a 384 x 384 image, run whole: 1 + 32
    + 576 = 609 tokens. The port with ``attn_backend="flash"`` (the tiled
    route's plain version in the trunk, the short route causal in the text
    tower) against the JAX model with ``attn_backend="sdpa"``, weights
    through the JAX package's ``convert_reference_clip_ebc``."""
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    port = get_model("clip_vit_b_16", 224, 8, bins, anchors, attn_backend="flash", seed=0,
                     device="cpu")
    params, stats = jax_convert.convert_reference_clip_ebc(port.state_dict())
    jmodel = jax_get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=jnp.float32,
                           num_vpt=32, attn_backend="sdpa")
    image = np.random.default_rng(7).normal(size=(384, 384, 3)).astype(np.float32)
    want = JaxEvaluator(jmodel, reduction=8, pad_to_multiple=16).predict_count(
        {"params": params, "batch_stats": stats}, image)
    calls = []
    tiled = fa.flash_tiled_plain
    monkeypatch.setattr(fa, "flash_tiled_plain", lambda *a: calls.append(a[2].shape[2]) or tiled(*a))
    got = Evaluator(port, reduction=8, pad_to_multiple=16).predict_count(image)
    assert calls == [609] * 12  # every trunk block took the tiled route
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
