"""The port's other CLIP ViTs and text towers against the JAX package's:
``clip_vit_b_32`` (eval, and a VPT train step's gradients),
``clip_vit_l_14`` and ``clip_vit_l_14_336px`` (width 1024, 16 heads, eval),
the text tower at each width a CLIP backbone uses (512, 640, 768 and 1024
with 8, 10, 12 and 16 heads), row 2's plain version at D = 1024 against
the JAX kernel (``fused_ln_qkv_attention``, interpreting on the CPU by
itself), and the route a ViT-L window block takes on the card.

Weights: the JAX variable tree filled with seeded numpy values
(``test_torch_models._seeded_variables``), carried into the port by
``models.convert.from_jax_params``; the trunks and text towers are cut to
two blocks in both packages (``VIT_CONFIGS`` patched in both for the
test), at full width. Outputs are held to the JAX model's fp32 run by
relative L2 (``tests/test_torch_models.py``'s rule): fp32 2e-4, bf16
2e-2 plus twice the JAX package's own bf16 error. The VPT step's
gradients are held to the JAX package's float64 gradient (``jax.grad``
under ``jax.enable_x64``) as ``test_torch_clip_resnet.py`` holds the
ResNet's: 5e-3 over all, 2e-2 a tensor (the decoder's train-mode
BatchNorm). The row-2 plain version: fp32 1e-4, bf16 2e-2, as
``tests/test_torch_fused_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_ie
from clip_ebc_tpu.models.clip.text_encoder import ClipTextEncoder as JaxText
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention as jax_fused
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models import transformer as tr
from clip_ebc_tpu_torch.models.clip import image_encoder as ie
from clip_ebc_tpu_torch.models.clip.prompts import bin_prompts
from clip_ebc_tpu_torch.models.clip.text_encoder import ClipTextEncoder
from clip_ebc_tpu_torch.models.clip.tokenizer import tokenize
from clip_ebc_tpu_torch.models.convert import clip_text_state, from_jax_params
from clip_ebc_tpu_torch.ops import fused_attention as fa
from test_torch_fused_attention import _inputs, _port
from test_torch_models import _hold, _seeded_variables, _train_variables, rel

torch.set_num_threads(4)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
DTYPES = ("float32", "bfloat16")
DEPTH = 2


@pytest.fixture(autouse=True)
def cut_depth(monkeypatch):
    for table in (jax_ie.VIT_CONFIGS, ie.VIT_CONFIGS):
        for name, (patch, width, _, heads, embed) in list(table.items()):
            monkeypatch.setitem(table, name, (patch, width, DEPTH, heads, embed))


def _check_ref(ref: np.ndarray, what) -> None:
    assert np.std(ref) > 1e-3 * np.abs(ref).mean() and np.count_nonzero(ref) > ref.size // 10, \
        f"{what}: degenerate reference"


# ---- the text towers ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width,heads,embed", [(512, 8, 1024), (640, 10, 640), (768, 12, 768),
                                               (1024, 16, 1024)])
def test_text_tower_matches_jax(width, heads, embed, dtype):
    """The 77-token causal tower at each CLIP width (RN50's 512/8 with a
    1024 embedding, RN50x4's 640 with 10 heads, ViT-L's and RN50x16's
    768/12, RN50x64's 1024/16), two blocks, on the prompts of the qnrf
    bins."""
    tokens = tokenize(list(bin_prompts(BINS)))
    outs = {}
    for dt in DTYPES:
        jm = JaxText(embed_dim=embed, width=width, heads=heads, layers=DEPTH, dtype=getattr(jnp, dt))
        if dt == "float32":
            v = _seeded_variables(_TextInit(jm), jnp.asarray(tokens))
        outs[dt] = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(tokens)).astype(jnp.float32),
                              np.float64)
    pm = ClipTextEncoder(embed, width=width, heads=heads, layers=DEPTH, dtype=getattr(torch, dtype))
    pm.load_state_dict(clip_text_state(v["params"]), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens).long()).double().numpy()
    _check_ref(outs["float32"], "text")
    _hold(rel(got, outs["float32"]), rel(outs[dtype], outs["float32"]), dtype, ("text", width))


class _TextInit:
    """``_seeded_variables`` calls ``init(key, x, train=False)``; the text
    tower takes no ``train``."""

    def __init__(self, m):
        self.m = m

    def init(self, key, x, train=False):
        return self.m.init(key, x)


# ---- the ViT backbones ---------------------------------------------------------------------


_CASES: dict = {}


def _vit_case(backbone: str, size: int) -> dict:
    """Eval density of one CLIP ViT through both packages, fp32 and bf16,
    the text features a seeded input (the towers are held above)."""
    key = (backbone, size)
    if key in _CASES:
        return _CASES[key]
    _CASES.clear()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    embed = jax_ie.VIT_CONFIGS[backbone][4]
    text = rng.normal(size=(len(BINS), embed)).astype(np.float32)
    out = {}
    for dt in DTYPES:
        jm = jax_get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, dtype=getattr(jnp, dt))
        if dt == "float32":
            v = _seeded_variables(jm, jnp.asarray(x))
            v["params"]["logit_scale"] = np.float32(np.log(100.0))  # a varied density
        ev = jax.jit(lambda v, x, t, jm=jm: jm.apply(v, x, train=False, text_feats=t))(
            v, jnp.asarray(x), jnp.asarray(text))
        out[f"jax_{dt}"] = np.asarray(ev, np.float64)
        pm = get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, dtype=getattr(torch, dt),
                       device="cpu", fused_head="off")
        pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg),
                           strict=True)
        with torch.no_grad():
            out[f"port_{dt}"] = pm(torch.from_numpy(x), text_feats=torch.from_numpy(text)).double().numpy()
    _CASES[key] = out
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backbone,size", [("vit_b_32", 64), ("vit_l_14", 28),
                                           ("vit_l_14_336px", 28)])
def test_clip_vit_matches_jax(backbone, size, dtype):
    """ViT-B/32 on 64 px (2 x 2 patches, 1 + 32 + 4 tokens with deep
    VPT-32), ViT-L/14 at width 1024 and 16 heads on 28 px, and its 336 px
    variant, whose 24 x 24 positional grid resizes to 2 x 2: the eval
    density of the whole model (trunk, upsample to reduction 8, the basic
    decoder, projection, head)."""
    case = _vit_case(backbone, size)
    exact = case["jax_float32"]
    assert case[f"port_{dtype}"].shape == exact.shape == (2, size // 8, size // 8)
    _check_ref(exact, backbone)
    _hold(rel(case[f"port_{dtype}"], exact), rel(case[f"jax_{dtype}"], exact), dtype,
          (backbone, size))


def test_clip_vit_b_32_vpt_step_gradients_match_jax():
    """A VPT train step of ``clip_vit_b_32`` in fp32 (a seeded linear
    function of the logits and the density): the prompts, the decoder,
    the projection and the logit scale against the JAX float64 gradient;
    the trunk and the text tower frozen, with no gradient in the port."""
    size = 64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    text = rng.normal(size=(len(BINS), 512)).astype(np.float32)
    r_logits = rng.normal(size=(2, size // 8, size // 8, len(BINS))).astype(np.float32)
    r_dens = rng.normal(size=(2, size // 8, size // 8)).astype(np.float32)
    v = _train_variables(_seeded_variables(
        jax_get_model("clip_vit_b_32", size, 8, BINS, ANCHORS), jnp.asarray(x)))

    def jax_grads(dt):
        jm = jax_get_model("clip_vit_b_32", size, 8, BINS, ANCHORS, dtype=dt)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731

        def loss(params):
            (lg, dens), _ = jm.apply({"params": params, "batch_stats": cast(v["batch_stats"])},
                                     jnp.asarray(x, dt), train=True,
                                     text_feats=jnp.asarray(text, dt), mutable=["batch_stats"])
            return jnp.sum(lg * r_logits) + jnp.sum(dens * r_dens)

        g = jax.jit(jax.grad(loss))(cast(v["params"]))
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
        sd = from_jax_params(g, v["batch_stats"], (768,))
        return {k: t.double().numpy() for k, t in sd.items()}

    with jax.enable_x64():
        want = jax_grads(jnp.float64)
    pm = get_model("clip_vit_b_32", size, 8, BINS, ANCHORS, device="cpu")
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg), strict=True)
    pm.train()
    lg, dens = pm(torch.from_numpy(x), text_feats=torch.from_numpy(text))
    (torch.sum(lg * torch.from_numpy(r_logits)) + torch.sum(dens * torch.from_numpy(r_dens))).backward()
    got, ref, trained = [], [], set()
    for name, p in pm.named_parameters():
        if name.startswith(("image_encoder.", "text_encoder.")):
            assert not p.requires_grad and p.grad is None, name
            continue
        assert p.requires_grad and p.grad is not None, name
        trained.add(name.split(".")[0])
        got.append(p.grad.double().numpy().ravel())
        ref.append(want[name].ravel())
        assert rel(got[-1], ref[-1]) <= 2e-2, (name, rel(got[-1], ref[-1]))
    assert trained == {"vpt_0", "vpt_1", "image_decoder", "projection", "logit_scale"}
    assert rel(np.concatenate(got), np.concatenate(ref)) <= 5e-3


# ---- row 2 at D = 1024 -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", [289, 250])
def test_row2_plain_matches_jax_kernel_at_vit_l_width(kv_len, dtype):
    """The plain version the D = 1024 kernels are held to on the card,
    at a ViT-L window's shape (289 tokens, 16 heads), against the JAX
    kernel; keys past kv_len masked."""
    b, l, d, h = 1, 289, 1024, 16
    x, g, be, w, bias = _inputs(b, l, d, seed=kv_len)
    sm = (d // h) ** -0.5
    want = np.asarray(jax_fused(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be),
                                jnp.asarray(w), jnp.asarray(bias), h, kv_len, sm), np.float32)
    got = fa.ln_qkv_attention_plain(*_port(x, g, be, w, bias, dtype), h, kv_len, sm).float().numpy()
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(got[:, :kv_len], want[:, :kv_len], rtol=tol, atol=tol)


def test_vit_l_window_blocks_route_to_the_fused_kernel_on_cuda():
    """A ViT-L window block (16 heads, 1 + 32 + 256 = 289 tokens; up to
    MAX_FUSED_SEQ) takes row 2 on the card, as the JAX package fuses it;
    the 336 px window (609 tokens, padded to 640 > 512 in the JAX
    package) stays plain, a whole image goes to the flash kernel, and a
    CPU tensor takes the plain path. The int8 and backward kernels take
    D = 1024 too, and a calibrated int8 attention block the same 289
    tokens."""
    assert fa.MAX_FUSED_DIM == fa.MAX_INT8_DIM == fa.MAX_BWD_DX_DIM == 1024
    assert tr.attention_route("auto", "cuda", 289, "none", 16, 64, int8_attn=True) == "fused"
    for l in (289, fa.MAX_FUSED_SEQ):
        assert fa.supports(16, 64, l)
        for backend in ("auto", "fused"):
            assert tr.attention_route(backend, "cuda", l, "none", 16, 64) == "fused"
        assert tr.attention_route("auto", "cpu", l, "none", 16, 64) == "plain"
    assert tr.attention_route("auto", "cuda", 609, "none", 16, 64) == "plain"
    assert tr.attention_route("auto", "cuda", 32 * 48 + 1, "none", 16, 64) == "flash"
    assert not fa.supports(17, 64, 289)  # D = 1088

