"""W8A8 at ViT-L's width and on the CLIP ResNets: the port against the
JAX package.

* The int8 LN + QKV projection and attention at D = 1024 and 16 heads
  (the plain versions of rows 2b, 2c and 2d: float, static int8 and
  dynamic int8 attention) against the JAX ``fused_ln_qkv_attention_int8``,
  and the W8A8 MLP's plain version (row 6) at D = 1024, hidden 4096,
  against the JAX ``fused_ln_mlp_int8``; the JAX Pallas kernels interpret
  on the CPU by themselves. Held as ``tests/test_torch_quant_attn.py`` and
  ``tests/test_torch_mlp_int8.py`` hold them at D = 256: a maximum of
  2e-2 of the largest magnitude and a median of 1e-3 of it in fp32 (4e-3
  in bf16): int8 rounding turns a last-place difference upstream into a
  rare one-step flip.
* ``clip_vit_l_14`` (two blocks at full width) on two 28 px windows under
  ``--quant int8_static``, ``int8_static`` with ``quant_attn`` ``kernel``
  and ``xla``, and ``--quant int8``, against the JAX model on the same
  weights, the same text features and, for the static modes, the
  same calibrated scales (the JAX package's ``calibrate_int8`` of its
  dynamic twin, carried in by ``quant_state_from_jax``; the port's own
  calibration records the same tree, within 1e-4 in the first block and
  2e-2 past its int8 outputs): the density by the maximum and median
  above, the count within 2e-3.
* ``clip_resnet50`` (stages cut to (2, 1, 1, 1), 32 px windows) under
  ``--quant int8_static`` and ``--quant int8``: the Bottleneck decoder's
  convolutions in int8, the trunk and the projection float, against the
  JAX model in the same way; the predict CLI with each ``--quant`` on the
  CPU against the Evaluator on the same model.
* ``quant_state_from_jax`` / ``quant_state_to_jax`` over ViT-L's 24 blocks
  and a Bottleneck decoder: the names of the full-depth models of both
  packages (the JAX variable tree by ``jax.eval_shape``, the port's
  buffers on the meta device), and a round trip of the values.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_ie
from clip_ebc_tpu.ops import quant as jq
from clip_ebc_tpu.ops.fused_attention import fused_ln_mlp_int8 as jax_mlp
from clip_ebc_tpu.ops.fused_attention import fused_ln_qkv_attention_int8 as jax_fused_int8
from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli._common import QUANT_ATTN, calibrate_static_int8
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip import image_encoder as ie
from clip_ebc_tpu_torch.models.clip.model import DECODER_CFGS, ClipEBC
from clip_ebc_tpu_torch.models.convert import quant_state_from_jax, quant_state_to_jax
from clip_ebc_tpu_torch.ops import quant as tq
from clip_ebc_tpu_torch.ops.fused_attention import (
    fused_ln_mlp_int8,
    fused_ln_qkv_attention_int8,
)
from clip_ebc_tpu_torch.training.evaluate import Evaluator
from test_torch_quant_attn import _qkv_scales, assert_close_max_median

torch.set_num_threads(4)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
B, L, D, H = 2, 64, 1024, 16
SM = (D // H) ** -0.5
VIT_CONFIGS_FULL, RESNET_CONFIGS_FULL = dict(ie.VIT_CONFIGS), dict(ie.RESNET_CONFIGS)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _med_tol(dtype):
    return {"float32": 1e-3, "bfloat16": 4e-3}[dtype]


# ---- the kernels' plain versions at D = 1024 -----------------------------------------------


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    be = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * D)).astype(np.float32)
    xf = x - x.mean(-1, keepdims=True)
    y = xf / np.sqrt((xf**2).mean(-1, keepdims=True) + 1e-5) * g + be
    act_scale = np.float32(np.abs(y).max() / 127.0)  # what a calibration records
    return x, g, be, w, bias, act_scale, _qkv_scales(y @ w + bias)


@pytest.mark.parametrize("branch,kv_len,dtype", [
    ("float", L, "float32"), ("float", 50, "bfloat16"),
    ("static", L, "float32"), ("static", 50, "bfloat16"),
    ("dynamic", L, "float32"), ("dynamic", L, "bfloat16"),
])
def test_int8_ln_qkv_attention_plain_matches_jax_kernel_at_vit_l_width(branch, kv_len, dtype):
    x, g, be, w, bias, act_scale, aq = _block_inputs(seed=kv_len + len(branch))
    kw_j = {"static": dict(attn_scales=jnp.asarray(aq)), "dynamic": dict(quant_attn=True),
            "float": {}}[branch]
    kw_p = {"static": dict(attn_scales=torch.from_numpy(aq)), "dynamic": dict(quant_attn=True),
            "float": {}}[branch]
    want = np.asarray(jax_fused_int8(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(w),
        jnp.asarray(bias), jnp.asarray(act_scale), H, kv_len, SM, **kw_j), np.float32)
    args = (_t(x, dtype), _t(g), _t(be), _t(w.T), _t(bias), torch.tensor(act_scale))
    before = fused_ln_qkv_attention_int8.launches_proj
    got = fused_ln_qkv_attention_int8(*args, H, kv_len, SM, **kw_p)
    assert fused_ln_qkv_attention_int8.launches_proj == before  # a CPU tensor: the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, L, D)
    assert_close_max_median(got.float().numpy()[:, :kv_len], want[:, :kv_len],
                            med_tol=_med_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_mlp_int8_plain_matches_jax_kernel_at_vit_l_width(dtype):
    hid = 4 * D
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 100, D)).astype(np.float32)  # rows the JAX kernel pads
    g = rng.uniform(0.8, 1.2, D).astype(np.float32)
    be = (rng.normal(size=D) * 0.1).astype(np.float32)
    wfc = (rng.normal(size=(D, hid)) * 0.03).astype(np.float32)
    bfc = (rng.normal(size=hid) * 0.02).astype(np.float32)
    wpj = (rng.normal(size=(hid, D)) * 0.015).astype(np.float32)
    bpj = (rng.normal(size=D) * 0.02).astype(np.float32)
    mu = x.mean(-1, keepdims=True)
    y = (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * g + be
    h = y @ wfc + bfc
    act1 = np.float32(np.abs(y).max() / 127.0)
    act2 = np.float32(np.abs(h / (1.0 + np.exp(-1.702 * h))).max() / 127.0)
    want = np.asarray(jax_mlp(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g), jnp.asarray(be), jnp.asarray(wfc),
        jnp.asarray(bfc), jnp.asarray(act1), jnp.asarray(wpj), jnp.asarray(bpj), jnp.asarray(act2),
        quick_gelu=True), np.float32)
    before = fused_ln_mlp_int8.launches
    got = fused_ln_mlp_int8(_t(x, dtype), _t(g), _t(be), _t(wfc.T), _t(bfc), torch.tensor(act1),
                            _t(wpj.T), _t(bpj), torch.tensor(act2))
    assert fused_ln_mlp_int8.launches == before
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    xr = np.asarray(_t(x, dtype).float())  # the residual in x's dtype
    assert_close_max_median(got.float().numpy() - xr, want - xr, med_tol=_med_tol(dtype))


# ---- the models: ViT-L/14 and clip_resnet50 ------------------------------------------------


def _windows(size, n, seed):
    """``n`` normalized windows of ``size`` px, as the Evaluator cuts them."""
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 256, (n, size, size, 3)) / 255.0 - 0.45) / 0.225).astype(np.float32)


def _setup(backbone, size, **jax_kw):
    """The port's seeded weights carried into the JAX tree, a batch of two
    windows, the prompts' text features (the port's text tower, held to
    the JAX one in ``tests/test_torch_clip_vit.py``; both models take them,
    so no JAX text tower runs) and the JAX package's calibration of its
    dynamic twin on the batch (its ``calibrate_int8``, the q, k and v
    scales too). Two small windows: the JAX package's int8 convolutions
    of the decoder take most of the time on the CPU."""
    port = get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, seed=0, device="cpu")
    weights = port.state_dict()
    params, stats = jax_convert.convert_reference_clip_ebc(weights)
    x = _windows(size, 2, seed=3)
    with torch.no_grad():
        text = port.encode_text().numpy()
    dyn = jax_get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, dtype=jnp.float32,
                        quant_int8=True, **jax_kw)
    apply_fn = jax.jit(lambda v, b: dyn.apply(v, b, train=False, text_feats=jnp.asarray(text),
                                              mutable=["quant"]))
    variables = jq.calibrate_int8(apply_fn, {"params": params, "batch_stats": stats}, [x])
    return weights, variables, x, text


def _held_to_jax(backbone, size, setup, mode, jax_kw, port_kw, n_state):
    """The port's density under ``mode`` against the JAX model's on the
    same weights and, for the static modes, the same scales; the port's
    own calibration of its dynamic twin records the JAX tree."""
    weights, variables, x, text = setup
    static = mode != "int8"
    qm = "static" if static else "dynamic"
    jm = jax_get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, dtype=jnp.float32,
                       quant_int8=True, quant_mode=qm, **jax_kw)
    jvars = variables if static else {k: variables[k] for k in ("params", "batch_stats")}
    want = np.asarray(jax.jit(lambda v, b: jm.apply(v, b, train=False, text_feats=jnp.asarray(text)))(
        jvars, jnp.asarray(x)))
    model = get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, device="cpu", quant_int8=True,
                      quant_mode=qm, **port_kw)
    model.load_state_dict(weights)
    xt, tt = torch.from_numpy(x), torch.from_numpy(text)
    if static:
        jax_state = quant_state_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables["quant"])),
                                         model.decoder_cfg)
        dyn = get_model(f"clip_{backbone}", size, 8, BINS, ANCHORS, device="cpu", quant_int8=True,
                        quant_mode="dynamic", **port_kw)
        dyn.load_state_dict(weights)
        own = tq.calibrate_int8(dyn, [xt], forward=lambda b: dyn(b, text_feats=tt))
        assert sorted(own) == sorted(jax_state) and len(own) == n_state
        for k in own:
            rtol = 1e-4 if ".resblocks.0." in k else 2e-2  # past the first block: int8 rounding
            np.testing.assert_allclose(own[k].numpy(), jax_state[k].numpy(), rtol=rtol, err_msg=k)
        tq.load_quant_state(model, jax_state)
    with torch.no_grad():
        got = model(xt, text_feats=tt).numpy()
    assert got.shape == want.shape == (len(x), size // 8, size // 8)
    assert_close_max_median(got, want)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=2e-3)


VIT_SIZE = 28  # 1 + 32 + 2 x 2 tokens


@pytest.fixture(scope="module")
def vit_l_setup():
    """ViT-L/14 at its width with two trunk blocks in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (jax_ie.VIT_CONFIGS, ie.VIT_CONFIGS):
            patch, width, _, heads, embed = table["vit_l_14"]
            mp.setitem(table, "vit_l_14", (patch, width, 2, heads, embed))
        yield _setup("vit_l_14", VIT_SIZE, num_vpt=32, quant_attn=True)


@pytest.mark.parametrize("mode", ["int8_static", "kernel", "xla", "int8"])
def test_vit_l_w8a8_counts_match_jax(vit_l_setup, mode):
    """``mode``: ``--quant int8_static``, with ``--quant_attn kernel`` or
    ``xla``, or ``--quant int8``. The int8 attention kernel's mode takes
    the fused LN route in both packages (the JAX kernels interpreting, the
    port's plain versions); the others the unfused route, as both run a
    CPU tensor."""
    quant_attn = QUANT_ATTN[mode] if mode in ("kernel", "xla") else False
    kw = dict(num_vpt=32, attn_backend="fused" if mode == "kernel" else "auto",
              quant_attn=quant_attn)
    _held_to_jax("vit_l_14", VIT_SIZE, vit_l_setup, mode, kw, kw, 2 * 5 + 2)


RN_WIN, RN_HW = 32, (64, 96)
RN_EVAL = dict(reduction=8, sliding_window=True, window_size=RN_WIN, stride=RN_WIN,
               pad_to_multiple=8)
RN_CUT = (2, 1, 1, 1)


@pytest.fixture(scope="module")
def resnet_cut():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jax_ie.RESNET_CONFIGS, ie.RESNET_CONFIGS):
            _, width, embed, heads = table["resnet50"]
            mp.setitem(table, "resnet50", (RN_CUT, width, embed, heads))
        yield


@pytest.fixture(scope="module")
def resnet_setup(resnet_cut):
    return _setup("resnet50", RN_WIN)


@pytest.mark.parametrize("mode", ["int8_static", "int8"])
def test_clip_resnet50_w8a8_counts_match_jax(resnet_setup, mode):
    """The Bottleneck decoder's three convolutions in int8 (2048 in, 2048
    out: no shortcut), the ModifiedResNet trunk and the projection float."""
    model = get_model("clip_resnet50", RN_WIN, 8, BINS, ANCHORS, device="cpu", quant_int8=True)
    convs = [n for n, m in model.named_modules() if isinstance(m, tq.Int8Conv2d)]
    assert convs == ["image_decoder.0.conv1", "image_decoder.0.conv2", "image_decoder.0.conv3"]
    assert not any(isinstance(m, tq.Int8Linear) for m in model.modules())
    _held_to_jax("resnet50", RN_WIN, resnet_setup, mode, {}, {}, 3)


# ---- the quant state bridge at full depth ------------------------------------------------


def _jax_quant_names(backbone: str, size: int) -> list:
    """The quant collection a calibration pass of the full-depth JAX model
    records (every ``act_amax``, and a ViT block's ``qkv_amax``), by shape
    only."""
    jm = jax_get_model(backbone, size, 8, BINS, ANCHORS, quant_int8=True)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x, train=False), jax.random.PRNGKey(0))
    shapes = {k: v for k, v in shapes.items() if k != "quant"}
    _, mut = jax.eval_shape(lambda v: jm.apply(v, x, train=False, mutable=["quant"]), shapes)
    return sorted("/".join(p.key for p in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(mut["quant"])[0])


def _port_quant_names(backbone: str) -> list:
    """The quant buffers of the full-depth port model, built on the meta device."""
    with torch.device("meta"):
        model = ClipEBC(backbone, BINS, ANCHORS, reduction=8, quant_int8=True, quant_mode="static")
    return sorted(tq._quant_buffers(model))


@pytest.mark.parametrize("backbone,size,n", [
    ("vit_l_14", 224, 24 * 5 + 2),  # 5 a block, the basic decoder's two convolutions
    ("resnet50", 224, 3),  # one bottleneck, 2048 -> 2048
    ("resnet101", 224, 7),  # 2048 -> 2048, then 2048 -> 1024 with its shortcut
])
def test_quant_state_bridge_at_full_depth(monkeypatch, backbone, size, n):
    for tables, full in (((jax_ie.VIT_CONFIGS, ie.VIT_CONFIGS), VIT_CONFIGS_FULL),
                         ((jax_ie.RESNET_CONFIGS, ie.RESNET_CONFIGS), RESNET_CONFIGS_FULL)):
        for table in tables:  # the full depth, whatever a module fixture cut
            for name, cfg in full.items():
                monkeypatch.setitem(table, name, cfg)
    jax_names = _jax_quant_names(f"clip_{backbone}", size)
    port_names = _port_quant_names(backbone)
    assert len(jax_names) == len(port_names) == n
    cfg = DECODER_CFGS[backbone][1]
    rng = np.random.default_rng(len(jax_names))
    tree = {}
    for name in jax_names:
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = rng.uniform(0.5, 2.0, (3,) if leaf == "qkv_amax" else ()).astype(np.float32)
    state = quant_state_from_jax(tree, cfg)
    assert sorted(state) == port_names
    back = quant_state_to_jax(state, cfg)
    flat = lambda t: {"/".join(p.key for p in path): np.asarray(v)  # noqa: E731
                      for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(tree), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
