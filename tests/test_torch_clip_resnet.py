"""The port's CLIP ModifiedResNet backbones against the JAX package's:
``ClipBottleneck``, ``AttentionPool2d``, the ``ClipModifiedResNet`` trunk
of each of the five configurations, ``ClipEBC`` over ``clip_resnet50`` at
reductions 8, 16 and 32, one train step's gradients, and a whole image
whose sides are multiples of 8 but not of 32.

Weights: the JAX variable tree filled with seeded numpy values
(``test_torch_models._seeded_variables``), carried into the port by
``models.convert.from_jax_params`` (``clip_resnet_state`` for a bare
trunk); the images are seeded too. The references, tolerances and
BatchNorm shifts are those of ``tests/test_torch_models.py`` (its module
docstring): each output held to the JAX model's fp32 run by relative L2,
fp32 2e-4, bf16 2e-2 plus twice the JAX package's own bf16 error; the
train-mode checks take every BatchNorm shift from U(0.5, 1.5) and hold
the updated running statistics too. The trunks run at full width with
their stages cut to (2, 1, 1, 1) blocks in both packages (a strided first
block in every stage, an identity block in layer1), at 64 px (128 px at
reduction 32), so layer4 keeps 4 x 4 positions. The text features are seeded
inputs here (the towers are held in ``test_torch_clip_vit.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_ie
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip import image_encoder as ie
from clip_ebc_tpu_torch.models.clip.model import TEXT_CONFIGS
from clip_ebc_tpu_torch.models.convert import _bn, _conv, _dense, _t, clip_resnet_state, from_jax_params
from clip_ebc_tpu_torch.training.evaluate import Evaluator
from test_torch_models import _hold, _seeded_variables, _train_variables, rel

torch.set_num_threads(4)
VARIANTS = ("resnet50", "resnet101", "resnet50x4", "resnet50x16", "resnet50x64")
CUT = (2, 1, 1, 1)
BATCH = 2
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def cut_depth(monkeypatch):
    """The five configurations at full width, their stages cut to CUT, in
    both packages' tables."""
    for table in (jax_ie.RESNET_CONFIGS, ie.RESNET_CONFIGS):
        for name, (_, width, embed, heads) in list(table.items()):
            monkeypatch.setitem(table, name, (CUT, width, embed, heads))


def _size(reduction: int) -> int:
    """The input side at which layer4 keeps 4 x 4 positions."""
    return 128 if reduction == 32 else 64


def _images(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check_ref(ref: np.ndarray, what) -> None:
    assert np.std(ref) > 1e-3 * np.abs(ref).mean() and np.count_nonzero(ref) > ref.size // 10, \
        f"{what}: degenerate reference"


def _hold_all(got: dict, jax_out: dict, exact: dict, dtype: str, what: tuple) -> None:
    for k, ref in exact.items():
        _check_ref(ref, (*what, k))
        _hold(rel(got[k], ref), rel(jax_out[k], ref), dtype, (*what, k))


# ---- the bottleneck and the attention pool ---------------------------------------------


def _module_vars(module, x, seed, train_shifts=False, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, x, **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = path[-1].key
        if name in ("scale", "var") or (train_shifts and name == "bias" and "BatchNorm_0" in str(path)):
            leaves.append(rng.uniform(0.5, 1.5, s.shape).astype(np.float32))
        else:
            std = float(np.prod(s.shape[:-1])) ** -0.5 if name == "kernel" else 0.1
            leaves.append(rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _bottleneck_state(params, stats) -> dict:
    sd = {}
    for c in (1, 2, 3):
        sd[f"conv{c}.weight"] = _conv(params[f"conv{c}"]["kernel"])
        _bn(sd, f"bn{c}", params[f"bn{c}"], stats[f"bn{c}"])
    if "down_conv" in params:
        sd["downsample.0.weight"] = _conv(params["down_conv"]["kernel"])
        _bn(sd, "downsample.1", params["down_bn"], stats["down_bn"])
    return sd


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("cin,planes,stride", [(64, 16, 1), (32, 16, 1), (64, 16, 2), (32, 8, 2)])
def test_clip_bottleneck_matches_jax(cin, planes, stride, mode):
    """An identity block, a widening block, and the anti-aliased strided
    block (pool after conv2, pool + 1x1 on the shortcut) on an odd 9 x 11
    grid, whose pools floor; fp32 2e-4, the statistics too."""
    x = _images((BATCH, 9, 11, cin))
    jm = jax_ie.ClipBottleneck(planes, stride=stride)
    v = _module_vars(jm, jnp.asarray(x), seed=cin + stride, train_shifts=mode == "train",
                     train=False)
    train = mode == "train"
    want, mut = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
    pm = ie.ClipBottleneck(cin, planes, stride).train(train)
    pm.load_state_dict(_bottleneck_state(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (BATCH, 9 // stride, 11 // stride, planes * 4)
    _check_ref(np.asarray(want), "bottleneck")
    assert rel(got, want) <= 2e-4
    if train:
        stats = _bottleneck_state(v["params"], jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
        for k, t in pm.state_dict().items():
            if "running_" in k:
                assert rel(t.numpy(), stats[k].numpy()) <= 2e-4, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [(4, 4), (3, 3)])
def test_attention_pool_matches_jax(grid, dtype):
    """The mean-token query over a 4 x 4 grid (the whole positional
    embedding) and a 3 x 3 one (sliced, not resized): fp32 2e-4, bf16
    2e-2 plus twice the JAX package's own error."""
    c, heads, out, spacial = 64, 4, 24, 16
    x = _images((BATCH, *grid, c), seed=7)
    outs = {}
    for dt in DTYPES:
        jm = jax_ie.AttentionPool2d(spacial, heads, out, dtype=getattr(jnp, dt))
        v = _module_vars(jm, jnp.asarray(x), seed=3)
        outs[dt] = np.asarray(jm.apply(v, jnp.asarray(x, getattr(jnp, dt))), np.float64)
    p = v["params"]
    pm = ie.AttentionPool2d(spacial, c, heads, out)
    sd = {"positional_embedding": _t(p["positional_embedding"])}
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, proj, p[proj])
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)))
    _check_ref(outs["float32"], "attnpool")
    _hold(rel(got.double().numpy(), outs["float32"]), rel(outs[dtype], outs["float32"]), dtype,
          ("attnpool", grid))


# ---- the trunks -----------------------------------------------------------------------


_TRUNKS: dict = {}


def _trunk_case(variant: str, reduction: int, pooled: bool = False) -> dict:
    """Eval features, train features and updated statistics of one trunk
    through both packages, fp32 and bf16 (one case cached at a time)."""
    key = (variant, reduction, pooled)
    if key in _TRUNKS:
        return _TRUNKS[key]
    _TRUNKS.clear()
    size = _size(reduction)
    x = _images((BATCH, size, size, 3))
    out = {}
    for dt in DTYPES:
        jm = jax_ie.ClipModifiedResNet(variant, reduction=reduction, features_only=not pooled,
                                       input_size=size, dtype=getattr(jnp, dt))
        if dt == "float32":
            v_eval = _module_vars(jm, jnp.asarray(x), seed=11, train=False)
            v_train = _train_variables(v_eval)

        def run(v_eval, v_train, x, jm=jm):
            ev = jm.apply(v_eval, x, train=False)
            tr, mut = jm.apply(v_train, x, train=True, mutable=["batch_stats"])
            return ev, tr, mut["batch_stats"]

        ev, tr, stats = jax.jit(run)(v_eval, v_train, jnp.asarray(x))
        out[f"jax_{dt}"] = {"eval": np.asarray(ev, np.float64), "train": np.asarray(tr, np.float64),
                            "stats": jax.tree_util.tree_map(np.asarray, stats)}
        pm = ie.ClipModifiedResNet(variant, reduction, features_only=not pooled, input_size=size)
        got = {}
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dt))
        for v, mode in ((v_eval, "eval"), (v_train, "train")):
            pm.load_state_dict(clip_resnet_state(v["params"], v["batch_stats"]), strict=True)
            with torch.no_grad():
                y = pm.train(mode == "train")(xt)
            got[mode] = (y if pooled else y.permute(0, 2, 3, 1)).double().numpy()
        got["state"] = pm.state_dict()
        out[f"port_{dt}"] = got
    out["v_train"] = v_train
    _TRUNKS[key] = out
    return out


def _running_stats(case: dict, stats) -> dict:
    sd = clip_resnet_state(case["v_train"]["params"], stats)
    return {k: v.numpy() for k, v in sd.items() if "running_" in k}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("variant,reduction", [("resnet50", 8), ("resnet101", 32),
                                               ("resnet50x4", 16), ("resnet50x16", 32),
                                               ("resnet50x64", 8)])
def test_clip_resnet_trunk_matches_jax(variant, reduction, mode, dtype):
    """Each configuration's trunk (layer4 at stride 1 for reduction <= 16,
    else 2), features in eval and train mode, and the running statistics
    a train-mode forward leaves."""
    case = _trunk_case(variant, reduction)
    exact, jax_out, port = case["jax_float32"], case[f"jax_{dtype}"], case[f"port_{dtype}"]
    width = jax_ie.RESNET_CONFIGS[variant][1]
    grid = 4
    assert port[mode].shape == (BATCH, grid, grid, width * 32)
    _hold_all({mode: port[mode]}, {mode: jax_out[mode]}, {mode: exact[mode]}, dtype,
              (variant, reduction))
    if mode == "train":
        want, own = _running_stats(case, exact["stats"]), _running_stats(case, jax_out["stats"])
        for k, ref in want.items():
            _hold(rel(port["state"][k].numpy(), ref), rel(own[k], ref), dtype, (variant, k))


@pytest.mark.parametrize("dtype", DTYPES)
def test_clip_resnet_attention_pool_head_matches_jax(dtype):
    """``features_only=False``: the trunk, then the attention pool over
    its 4 x 4 grid -> the (B, 1024) embedding, in eval and train mode."""
    case = _trunk_case("resnet50", 32, pooled=True)
    exact, jax_out, port = case["jax_float32"], case[f"jax_{dtype}"], case[f"port_{dtype}"]
    assert port["eval"].shape == (BATCH, 1024)
    _hold_all({k: port[k] for k in ("eval", "train")}, jax_out,
              {k: exact[k] for k in ("eval", "train")}, dtype, ("pooled",))


# ---- CLIP-EBC over clip_resnet50 --------------------------------------------------------


_EBC: dict = {}


def _text_feats(backbone: str) -> np.ndarray:
    embed = jax_ie.RESNET_CONFIGS[backbone][2]
    return np.random.default_rng(5).normal(size=(len(BINS), embed)).astype(np.float32)


def _ebc_case(reduction: int) -> dict:
    if reduction in _EBC:
        return _EBC[reduction]
    _EBC.clear()
    size = _size(reduction)
    x = _images((BATCH, size, size, 3), seed=2)
    text = _text_feats("resnet50")
    out = {}
    for dt in DTYPES:
        jm = jax_get_model("clip_resnet50", size, reduction, BINS, ANCHORS, dtype=getattr(jnp, dt))
        if dt == "float32":
            v_eval = _seeded_variables(jm, jnp.asarray(x))
            v_train = _train_variables(v_eval)

        def run(v_eval, v_train, x, t, jm=jm):
            ev = jm.apply(v_eval, x, train=False, text_feats=t)
            (lg, dens), mut = jm.apply(v_train, x, train=True, text_feats=t, mutable=["batch_stats"])
            return ev, lg, dens, mut["batch_stats"]

        ev, lg, dens, stats = jax.jit(run)(v_eval, v_train, jnp.asarray(x), jnp.asarray(text))
        out[f"jax_{dt}"] = {"eval": np.asarray(ev, np.float64),
                            "logits": np.asarray(lg.astype(jnp.float32), np.float64),
                            "density": np.asarray(dens, np.float64),
                            "stats": jax.tree_util.tree_map(np.asarray, stats)}
        pm = get_model("clip_resnet50", size, reduction, BINS, ANCHORS, dtype=getattr(torch, dt),
                       device="cpu", fused_head="off")
        got = {}
        tt = torch.from_numpy(text)
        for v, mode in ((v_eval, "eval"), (v_train, "train")):
            pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg),
                               strict=True)
            with torch.no_grad():
                y = pm.train(mode == "train")(torch.from_numpy(x), text_feats=tt)
            if mode == "eval":
                got["eval"] = y.double().numpy()
            else:
                got["logits"], got["density"] = (t.double().numpy() for t in y)
        got["state"] = pm.state_dict()
        out[f"port_{dt}"] = got
    out["v_train"], out["decoder_cfg"], out["size"] = v_train, pm.decoder_cfg, size
    _EBC[reduction] = out
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("reduction", [8, 16, 32])
def test_clip_ebc_resnet50_matches_jax(reduction, mode, dtype):
    """``clip_resnet50``: the trunk (encoder reduction 16 or 32), the
    bilinear rescale to the output reduction, the bottleneck decoder, the
    projection to 1024 and the head; eval density, train logits and
    density, and the running statistics of trunk and decoder."""
    case = _ebc_case(reduction)
    exact, jax_out, port = case["jax_float32"], case[f"jax_{dtype}"], case[f"port_{dtype}"]
    keys = ["eval"] if mode == "eval" else ["logits", "density"]
    size = case["size"]
    assert port[keys[-1]].shape[:3] == (BATCH, size // reduction, size // reduction)
    _hold_all({k: port[k] for k in keys}, jax_out, {k: exact[k] for k in keys}, dtype,
              ("clip_resnet50", reduction))
    if mode == "train":
        def stats(s):
            sd = from_jax_params(case["v_train"]["params"], s, case["decoder_cfg"])
            return {k: v.numpy() for k, v in sd.items() if "running_" in k}

        want, own = stats(exact["stats"]), stats(jax_out["stats"])
        assert any(k.startswith("image_encoder.") for k in want)
        assert any(k.startswith("image_decoder.") for k in want)
        for k, ref in want.items():
            _hold(rel(port["state"][k].numpy(), ref), rel(own[k], ref), dtype, ("stats", k))


def test_clip_resnet50_train_step_gradients_match_jax():
    """One fp32 train step's gradients (a seeded linear function of the
    logits and the density) against the JAX package's float64 gradient
    (``jax.grad`` with train-mode BatchNorm, under ``jax.enable_x64``):
    all trainable gradients together within 5e-3 relative L2, each
    tensor's within 2e-2 (the gradient of a BatchNorm's shift and scale
    is the small residue of per-channel sums that the next BatchNorm's
    backward makes cancel, so fp32 rounding in any summation order moves
    it by up to ~1e-2 relative, and the weight gradients after it by a
    few 1e-3: measured 8.1e-3 on the decoder's bn2 shift and 2.7e-3 over
    all, where the port run in float64 agrees with the JAX float64
    gradient to 1.2e-7), and the text tower, frozen in both packages,
    left with no gradient."""
    size = _size(8)
    x = _images((BATCH, size, size, 3), seed=4)
    text = _text_feats("resnet50")
    v = _train_variables(_seeded_variables(
        jax_get_model("clip_resnet50", size, 8, BINS, ANCHORS), jnp.asarray(x)))
    rng = np.random.default_rng(9)
    r_logits = rng.normal(size=(BATCH, size // 8, size // 8, len(BINS))).astype(np.float32)
    r_dens = rng.normal(size=(BATCH, size // 8, size // 8)).astype(np.float32)

    def jax_grads(dt):
        jm = jax_get_model("clip_resnet50", size, 8, BINS, ANCHORS, dtype=dt)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731

        def loss(params):
            (lg, dens), _ = jm.apply({"params": params, "batch_stats": cast(v["batch_stats"])},
                                     jnp.asarray(x, dt), train=True,
                                     text_feats=jnp.asarray(text, dt), mutable=["batch_stats"])
            return jnp.sum(lg * r_logits) + jnp.sum(dens * r_dens)

        g = jax.jit(jax.grad(loss))(cast(v["params"]))
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
        return {k: t.double().numpy() for k, t in from_jax_params(g, v["batch_stats"], (2048,)).items()}

    with jax.enable_x64():
        want = jax_grads(jnp.float64)

    pm = get_model("clip_resnet50", size, 8, BINS, ANCHORS, device="cpu")
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg), strict=True)
    pm.train()
    lg, dens = pm(torch.from_numpy(x), text_feats=torch.from_numpy(text))
    (torch.sum(lg * torch.from_numpy(r_logits)) + torch.sum(dens * torch.from_numpy(r_dens))).backward()
    got, ref = [], []
    for name, p in pm.named_parameters():
        if name.startswith("text_encoder."):
            assert not p.requires_grad and p.grad is None, name
            continue
        assert p.requires_grad and p.grad is not None, name
        got.append(p.grad.double().numpy().ravel())
        ref.append(want[name].ravel())
        assert rel(got[-1], ref[-1]) <= 2e-2, (name, rel(got[-1], ref[-1]))
    assert len(got) > 40
    assert rel(np.concatenate(got), np.concatenate(ref)) <= 5e-3


# ---- a whole image --------------------------------------------------------------------


@pytest.mark.parametrize("reduction", [8, 32])
def test_whole_image_off_the_32_grid_matches_jax(reduction):
    """A 76 x 100 image padded to multiples of 8 (80 x 104, neither a
    multiple of 32), whole, through both packages' Evaluators in fp32: the
    stem, the pools and the strided stages floor the odd grids (80 -> 40
    -> 20 -> 10 -> 5 -> 2 at reduction 32) as flax's VALID pooling does;
    the density maps agree in shape and within 2e-4 relative L2."""
    image = _images((76, 100, 3), seed=6)
    jm = jax_get_model("clip_resnet50", 64, reduction, BINS, ANCHORS)
    v = _seeded_variables(jm, jnp.zeros((1, 64, 64, 3)))
    v["params"]["logit_scale"] = np.float32(np.log(100.0))  # CLIP's trained scale: a varied density
    want = np.asarray(JaxEvaluator(jm, reduction=reduction, pad_to_multiple=8)
                      .predict_density(v, image), np.float64)
    pm = get_model("clip_resnet50", 64, reduction, BINS, ANCHORS, device="cpu")
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg), strict=True)
    got = Evaluator(pm, reduction=reduction, pad_to_multiple=8).predict_density(image)
    assert got.shape == want.shape
    _check_ref(want, "whole image")
    assert rel(got.double().numpy(), want) <= 2e-4


def test_every_clip_backbone_is_built():
    """All nine CLIP backbones build in the port (on the meta device) with
    the JAX model's encoder reduction, embedding width and text tower."""
    from clip_ebc_tpu.models.clip.model import TEXT_CONFIGS as JAX_TEXT
    from clip_ebc_tpu_torch.models import CLIP_BACKBONES
    from clip_ebc_tpu_torch.models.clip.model import ClipEBC

    assert set(TEXT_CONFIGS) == set(JAX_TEXT) == set(CLIP_BACKBONES)
    for name in CLIP_BACKBONES:
        for reduction in (8, 16, 32):
            want = jax_get_model(f"clip_{name}", 224, reduction, BINS, ANCHORS)
            with torch.device("meta"):  # the module's structure, no storage
                got = ClipEBC(name, BINS, ANCHORS, reduction)
            assert (got.encoder_reduction, got.out_reduction) == (
                want.encoder_reduction, want.out_reduction), name
            assert got.text_encoder.text_projection.shape[1] == want.clip_embed_dim, name
            assert got.text_encoder.positional_embedding.shape[1] == JAX_TEXT[name][0], name
            assert got.text_encoder.transformer.resblocks[0].attn.num_heads == JAX_TEXT[name][1]
