"""The port's ``--pretrained`` overlay (``models/pretrained.py``) against the
JAX package's ``apply_pretrained``, family by family.

The same seeded numpy-made checkpoint goes through both packages onto the
same fresh weights: the JAX variable tree filled with seeded numpy values
(``test_torch_models._seeded_variables``), carried into the port by
``from_jax_params`` / ``head_state_from_jax``. Every port tensor then
equals the bridge of the JAX result bit for bit, except a torchvision
ViT's resized positional embedding (1e-6: both resize bicubically with
torch's a = -0.75 kernel, in float32). The families:

- OpenAI CLIP ViT-B/16 and RN50 at full width and depth (``detect_clip_arch``
  knows real widths only), as fp16 tensors as OpenAI ships them, every
  tensor seeded random: a wrong transpose or split shows;
- a reference ``CLIP_EBC`` with deep VPT and its decoder, and the same
  overlay onto a dynamic-int8 model (its cached quantized weights remade);
- reference VGG ``Classifier`` and ``Regressor`` checkpoints;
- torchvision VGG19 into ``vgg19_ae``, a whole VGG16 into CSRNet (its
  trailing convs dropped), ResNet18 into ``resnet18_ae``, ViT-B/16 at 224
  px into ``vit_b_16`` at 64 px (the positional embedding resized),
  MobileNetV2 and DenseNet121.

The ViT-B/16 ``ClipEBC`` and ``vgg19_ae`` also run one forward in both
packages on the overlaid weights: fp32, relative L2 2e-4. Every refusal
of the JAX package is a refusal here: a CLIP checkpoint into a CNN, a
backbone mismatch, a tower-only ``.npz``, the byte-fallback tokenizer
without ``allow_byte_tokenizer``, an unrecognized family. The reference
CLIP_EBC and plain ViT cases cut the trunk to two blocks in both packages
(``VIT_CONFIGS`` / ``_VIT_CONFIGS`` patched; only OpenAI checkpoints are
sniffed for depth).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models import vit as jax_vit
from clip_ebc_tpu.models.clip import image_encoder as jax_ie
from clip_ebc_tpu.models.pretrained import apply_pretrained as jax_apply
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models import vit as port_vit
from clip_ebc_tpu_torch.models.clip import image_encoder as port_ie
from clip_ebc_tpu_torch.models.clip.model import ClipEBC
from clip_ebc_tpu_torch.models.convert import (from_jax_params, head_state_from_jax,
                                               save_prepared_tree)
from clip_ebc_tpu_torch.models.pretrained import apply_pretrained
from test_torch_models import _seeded_variables, rel

torch.set_num_threads(4)
BINS = [(0.0, 0.0), (1.0, 1.0), (2.0, float("inf"))]
ANCHORS = [0.0, 1.0, 2.5]
RED = 8


def _rand(rng, shape, std=0.02, dtype=np.float32):
    return torch.from_numpy(np.asarray(rng.standard_normal(shape, dtype=np.float32)
                                       * np.float32(std), dtype))


def _norm(rng, sd, prefix, c, dtype=np.float32):
    """A LayerNorm's weight and bias, or a BatchNorm's with its running
    statistics (``bn``)."""
    sd[f"{prefix}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(dtype))
    sd[f"{prefix}.bias"] = _rand(rng, (c,), 0.1, dtype)


def _bn(rng, sd, prefix, c):
    _norm(rng, sd, prefix, c)
    sd[f"{prefix}.running_mean"] = _rand(rng, (c,), 0.1)
    sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)


def _resblocks(rng, sd, prefix, width, layers, dtype):
    for i in range(layers):
        p = f"{prefix}.{i}"
        _norm(rng, sd, f"{p}.ln_1", width, dtype)
        _norm(rng, sd, f"{p}.ln_2", width, dtype)
        sd[f"{p}.attn.in_proj_weight"] = _rand(rng, (3 * width, width), width ** -0.5, dtype)
        sd[f"{p}.attn.in_proj_bias"] = _rand(rng, (3 * width,), 0.1, dtype)
        sd[f"{p}.attn.out_proj.weight"] = _rand(rng, (width, width), width ** -0.5, dtype)
        sd[f"{p}.attn.out_proj.bias"] = _rand(rng, (width,), 0.1, dtype)
        sd[f"{p}.mlp.c_fc.weight"] = _rand(rng, (4 * width, width), width ** -0.5, dtype)
        sd[f"{p}.mlp.c_fc.bias"] = _rand(rng, (4 * width,), 0.1, dtype)
        sd[f"{p}.mlp.c_proj.weight"] = _rand(rng, (width, 4 * width), (4 * width) ** -0.5, dtype)
        sd[f"{p}.mlp.c_proj.bias"] = _rand(rng, (width,), 0.1, dtype)


def openai_clip_sd(arch: str, seed: int = 0, dtype=np.float16) -> dict:
    """A full-size OpenAI CLIP state dict (``vit_b_16`` or ``resnet50``),
    every tensor seeded random, in ``dtype`` (OpenAI ships fp16)."""
    rng = np.random.default_rng(seed)
    sd = {}
    twidth, embed = (512, 512) if arch == "vit_b_16" else (512, 1024)
    if arch == "vit_b_16":
        width, patch = 768, 16
        sd["visual.conv1.weight"] = _rand(rng, (width, 3, patch, patch), 0.02, dtype)
        sd["visual.class_embedding"] = _rand(rng, (width,), 0.02, dtype)
        sd["visual.positional_embedding"] = _rand(rng, (197, width), 0.02, dtype)
        _norm(rng, sd, "visual.ln_pre", width, dtype)
        _norm(rng, sd, "visual.ln_post", width, dtype)
        sd["visual.proj"] = _rand(rng, (width, embed), width ** -0.5, dtype)
        _resblocks(rng, sd, "visual.transformer.resblocks", width, 12, dtype)
    else:  # ModifiedResNet-50: stem of 3 convs, layers (3, 4, 6, 3), attention pool
        def bn(prefix, c):
            _bn(rng, sd, prefix, c)
            for k in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{prefix}.{k}"] = sd[f"{prefix}.{k}"].to(getattr(torch, np.dtype(dtype).name))

        def conv(name, o, i, k):
            sd[name] = _rand(rng, (o, i, k, k), (i * k * k) ** -0.5, dtype)

        conv("visual.conv1.weight", 32, 3, 3), bn("visual.bn1", 32)
        conv("visual.conv2.weight", 32, 32, 3), bn("visual.bn2", 32)
        conv("visual.conv3.weight", 64, 32, 3), bn("visual.bn3", 64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), start=1):
            for bi in range(n):
                p = f"visual.layer{li}.{bi}"
                conv(f"{p}.conv1.weight", planes, inplanes, 1), bn(f"{p}.bn1", planes)
                conv(f"{p}.conv2.weight", planes, planes, 3), bn(f"{p}.bn2", planes)
                conv(f"{p}.conv3.weight", planes * 4, planes, 1), bn(f"{p}.bn3", planes * 4)
                if bi == 0:
                    conv(f"{p}.downsample.0.weight", planes * 4, inplanes, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                inplanes = planes * 4
        sd["visual.attnpool.positional_embedding"] = _rand(rng, (50, 2048), 0.02, dtype)
        for proj, o in (("q_proj", 2048), ("k_proj", 2048), ("v_proj", 2048), ("c_proj", embed)):
            sd[f"visual.attnpool.{proj}.weight"] = _rand(rng, (o, 2048), 2048 ** -0.5, dtype)
            sd[f"visual.attnpool.{proj}.bias"] = _rand(rng, (o,), 0.1, dtype)
    sd["token_embedding.weight"] = _rand(rng, (49408, twidth), 0.02, dtype)
    sd["positional_embedding"] = _rand(rng, (77, twidth), 0.01, dtype)
    _norm(rng, sd, "ln_final", twidth, dtype)
    sd["text_projection"] = _rand(rng, (twidth, embed), twidth ** -0.5, dtype)
    sd["logit_scale"] = torch.tensor(4.6052, dtype=getattr(torch, np.dtype(dtype).name))
    _resblocks(rng, sd, "transformer.resblocks", twidth, 12, dtype)
    return sd


def _assert_state_equal(model, want: dict, close=()) -> None:
    got = model.state_dict()
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k, v in got.items():
        if k in close:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        else:
            assert torch.equal(v, want[k].to(v.dtype)), k


def _clip_pair(arch: str, num_vpt: int = 2, seed: int = 3, **port_kw):
    """The JAX ClipEBC, its seeded variables and the port model loaded with
    them (built without the port's own init: the weights are loaded)."""
    jm = jax_get_model(f"clip_{arch}", 224, RED, bins=BINS, anchor_points=ANCHORS,
                       num_vpt=num_vpt, prompt_type="word")
    v = _seeded_variables(jm, jnp.zeros((1, 32, 32, 3)), seed=seed)
    pm = ClipEBC(arch, BINS, ANCHORS, reduction=RED, num_vpt=num_vpt, **port_kw).eval()
    pm.load_state_dict(from_jax_params(v["params"], v.get("batch_stats", {}), pm.decoder_cfg),
                       strict=True)
    return jm, v, pm


def _check_clip(jm, v, pm, ckpt):
    """The byte-fallback refusal in both packages, then the overlay with
    ``allow_byte_tokenizer``; returns the JAX result."""
    with pytest.raises(ValueError, match="BPE"):
        jax_apply(jm, dict(v), ckpt)
    with pytest.raises(ValueError, match="BPE"):
        apply_pretrained(pm, ckpt)
    out = jax_apply(jm, dict(v), ckpt, allow_byte_tokenizer=True)
    assert apply_pretrained(pm, ckpt, allow_byte_tokenizer=True) in ("clip", "reference_clip_ebc")
    _assert_state_equal(pm, from_jax_params(out["params"], out.get("batch_stats", {}),
                                            pm.decoder_cfg))
    return out


@pytest.fixture(scope="module")
def clip_vit():
    sd = openai_clip_sd("vit_b_16")
    jm, v, pm = _clip_pair("vit_b_16")
    untouched = {k: t.clone() for k, t in pm.state_dict().items()
                 if k.startswith(("vpt_", "image_decoder.", "projection."))}
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    evaluator = Evaluator(pm, reduction=RED)
    before = evaluator.text_features().clone()
    out = _check_clip(jm, v, pm, sd)
    return {"sd": sd, "jm": jm, "out": out, "pm": pm, "untouched": untouched,
            "evaluator": evaluator, "text_before": before}


def test_openai_clip_vit_b16_matches_jax(clip_vit):
    """Every tensor is the bridge of the JAX overlay; the towers are the
    checkpoint's values cast to fp32; VPT, decoder and projection keep
    their fresh values."""
    pm, sd = clip_vit["pm"], clip_vit["sd"]
    state = pm.state_dict()
    assert torch.equal(state["image_encoder.conv1.weight"], sd["visual.conv1.weight"].float())
    assert torch.equal(state["image_encoder.transformer.resblocks.3.attn.in_proj_weight"],
                       sd["visual.transformer.resblocks.3.attn.in_proj_weight"].float())
    assert torch.equal(state["text_encoder.text_projection"], sd["text_projection"].float())
    for k, t in clip_vit["untouched"].items():
        assert torch.equal(state[k], t), k


def test_openai_clip_vit_b16_forward_matches_jax(clip_vit):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(clip_vit["jm"].apply(clip_vit["out"], jnp.asarray(x), train=False))
    with torch.no_grad():
        got = clip_vit["pm"](torch.from_numpy(x)).double().numpy()
    assert np.isfinite(got).all() and rel(got, want) <= 2e-4


def test_overlay_refreshes_the_text_features(clip_vit):
    """The Evaluator cached the prompt features of the fresh weights; after
    the overlay it serves the checkpoint's."""
    ev, pm = clip_vit["evaluator"], clip_vit["pm"]
    with torch.no_grad():
        want = pm.encode_text()
    got = ev.text_features()
    assert torch.equal(got, want) and not torch.equal(got, clip_vit["text_before"])


def test_openai_clip_rn50_matches_jax():
    sd = openai_clip_sd("resnet50", seed=1)
    jm, v, pm = _clip_pair("resnet50")
    out = _check_clip(jm, v, pm, sd)
    assert torch.equal(pm.state_dict()["image_encoder.layer3.5.bn2.running_var"],
                       sd["visual.layer3.5.bn2.running_var"].float())
    assert "attnpool" not in out["params"]["image_encoder"]  # not a ClipEBC's


def _numpy_sd(model, seed: int) -> dict:
    """``model``'s state dict (the reference's torch names) refilled with
    seeded numpy values: a reference-trained checkpoint."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(3)
        elif k.endswith(("running_var", ".weight")) and t.ndim == 1:
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
        else:
            fan = max(int(np.prod(t.shape[1:])), 1) if t.ndim > 1 else 100
            sd[k] = _rand(rng, tuple(t.shape), fan ** -0.5)
    return sd


@pytest.fixture
def two_blocks(monkeypatch):
    for table in (jax_ie.VIT_CONFIGS, port_ie.VIT_CONFIGS):
        for name, (patch, width, _, heads, embed) in list(table.items()):
            monkeypatch.setitem(table, name, (patch, width, 2, heads, embed))
    for table in (jax_vit._VIT_CONFIGS, port_vit._VIT_CONFIGS):
        for name, (patch, _, heads, hidden, mlp) in list(table.items()):
            monkeypatch.setitem(table, name, (patch, 2, heads, hidden, mlp))


def test_reference_clip_ebc_matches_jax(two_blocks):
    """A trained reference CLIP_EBC (deep VPT-4, decoder, projection) onto
    the JAX model and the port's, float and W8A8: the int8 model's cached
    quantized weights are those of the checkpoint after the overlay."""
    jm, v, pm = _clip_pair("vit_b_16", num_vpt=4)
    ckpt = _numpy_sd(pm, seed=11)
    out = _check_clip(jm, v, pm, ckpt)
    assert out["params"]["image_encoder"]["vpt"].shape == (2, 4, 768)
    for k in ("vpt_1", "image_decoder.0.conv1.weight", "projection.weight", "logit_scale"):
        assert torch.equal(pm.state_dict()[k], ckpt[k]), k

    q = ClipEBC("vit_b_16", BINS, ANCHORS, reduction=RED, num_vpt=4, quant_int8=True).eval()
    q.load_state_dict(pm.state_dict(), strict=False)
    fc = q.image_encoder.transformer.resblocks[1].mlp.c_fc
    stale = fc.quantized_weight()[0].clone()
    q.load_state_dict(from_jax_params(v["params"], v.get("batch_stats", {}), q.decoder_cfg),
                      strict=False)
    assert not torch.equal(fc.quantized_weight()[0], stale)
    apply_pretrained(q, ckpt, allow_byte_tokenizer=True)
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    assert torch.equal(fc.quantized_weight()[0], stale)
    assert torch.equal(fc.quantized_weight()[0], quantize_weight(fc.weight)[0])


def _cnn_pair(name: str, size: int, head: str = "cls", seed: int = 5):
    bins, anchors = (BINS, ANCHORS) if head == "cls" else (None, None)
    jm = jax_get_model(name, size, RED, bins=bins, anchor_points=anchors)
    v = _seeded_variables(jm, jnp.zeros((1, size, size, 3)), seed=seed)
    pm = get_model(name, size, RED, bins, anchors, device="cpu")
    pm.load_state_dict(head_state_from_jax(pm, v["params"], v.get("batch_stats", {})), strict=True)
    return jm, v, pm


def _overlay_both(jm, v, pm, ckpt, close=()):
    out = jax_apply(jm, dict(v), ckpt)
    apply_pretrained(pm, ckpt)
    _assert_state_equal(pm, head_state_from_jax(pm, out["params"], out.get("batch_stats", {})),
                        close)
    return out


def _vgg_features_sd(rng, cfg, bn: bool = False) -> dict:
    """torchvision ``features.*`` of a VGG configuration (conv, [BN,] ReLU;
    M a max pool)."""
    sd, idx, cin = {}, 0, 3
    for c in cfg:
        if c == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = _rand(rng, (c, cin, 3, 3), (cin * 9) ** -0.5)
        sd[f"features.{idx}.bias"] = _rand(rng, (c,), 0.1)
        if bn:
            _bn(rng, sd, f"features.{idx + 1}", c)
        idx += 3 if bn else 2
        cin = c
    return sd


VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
         512, 512, 512, 512, "M"]


@pytest.mark.parametrize("head", ["cls", "reg"])
def test_reference_vgg_classifier_and_regressor_match_jax(head):
    jm, v, pm = _cnn_pair("vgg19_ae", 32, head)
    ckpt = _numpy_sd(pm, seed=13)
    _overlay_both(jm, v, pm, ckpt)
    for k, t in pm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, ckpt[k]), k  # the whole model is the checkpoint's


def test_torchvision_vgg19_into_vgg19_ae_matches_jax():
    """The features load, the decoder and head keep their fresh values, and
    one forward matches the JAX model on the overlaid weights."""
    jm, v, pm = _cnn_pair("vgg19_ae", 32)
    fresh = {k: t.clone() for k, t in pm.state_dict().items() if not k.startswith("backbone.features")}
    ckpt = _vgg_features_sd(np.random.default_rng(2), VGG19)
    out = _overlay_both(jm, v, pm, ckpt)
    state = pm.state_dict()
    assert torch.equal(state["backbone.features.34.weight"], ckpt["features.34.weight"])
    for k, t in fresh.items():
        assert torch.equal(state[k], t), k
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(out, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).double().numpy()
    assert rel(got, want) <= 2e-4


def test_torchvision_vgg16_into_csrnet_drops_the_tail():
    jm, v, pm = _cnn_pair("csrnet", 32)
    ckpt = _vgg_features_sd(np.random.default_rng(4), VGG16)
    out = _overlay_both(jm, v, pm, ckpt)
    feats = out["params"]["backbone"]["features"]
    assert "ConvBNAct_9" in feats and "ConvBNAct_10" not in feats
    short = {k: t for k, t in ckpt.items() if int(k.split(".")[1]) < 21}  # 9 of the 10 convs
    with pytest.raises(ValueError, match="lacks"):
        jax_apply(jm, dict(v), short)
    with pytest.raises(ValueError, match="lacks"):
        apply_pretrained(pm, short)


def _torchvision_resnet18_sd(rng) -> dict:
    sd = {"conv1.weight": _rand(rng, (64, 3, 7, 7), 147 ** -0.5)}
    _bn(rng, sd, "bn1", 64)
    inp = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            p, cin = f"layer{li}.{bi}", inp if bi == 0 else planes
            sd[f"{p}.conv1.weight"] = _rand(rng, (planes, cin, 3, 3), (cin * 9) ** -0.5)
            _bn(rng, sd, f"{p}.bn1", planes)
            sd[f"{p}.conv2.weight"] = _rand(rng, (planes, planes, 3, 3), (planes * 9) ** -0.5)
            _bn(rng, sd, f"{p}.bn2", planes)
            if bi == 0 and cin != planes:
                sd[f"{p}.downsample.0.weight"] = _rand(rng, (planes, cin, 1, 1), cin ** -0.5)
                _bn(rng, sd, f"{p}.downsample.1", planes)
        inp = planes
    sd["fc.weight"], sd["fc.bias"] = _rand(rng, (10, 512)), _rand(rng, (10,))
    return sd


def test_torchvision_resnet18_into_the_autoencoder_matches_jax():
    jm, v, pm = _cnn_pair("resnet18_ae", 32)
    ckpt = _torchvision_resnet18_sd(np.random.default_rng(6))
    _overlay_both(jm, v, pm, ckpt)
    state = pm.state_dict()
    assert torch.equal(state["backbone.encoder.layer2.0.downsample.1.running_mean"],
                       ckpt["layer2.0.downsample.1.running_mean"])
    assert state["backbone.encoder.bn1.num_batches_tracked"] == 0  # the model's own counter


def _torchvision_vit_sd(rng, layers: int = 2, width: int = 768, grid: int = 14) -> dict:
    sd = {"conv_proj.weight": _rand(rng, (width, 3, 16, 16), 768 ** -0.5),
          "conv_proj.bias": _rand(rng, (width,), 0.1),
          "class_token": _rand(rng, (1, 1, width)),
          "encoder.pos_embedding": _rand(rng, (1, grid * grid + 1, width))}
    _norm(rng, sd, "encoder.ln", width)
    for i in range(layers):
        p = f"encoder.layers.encoder_layer_{i}"
        _norm(rng, sd, f"{p}.ln_1", width)
        _norm(rng, sd, f"{p}.ln_2", width)
        sd[f"{p}.self_attention.in_proj_weight"] = _rand(rng, (3 * width, width), width ** -0.5)
        sd[f"{p}.self_attention.in_proj_bias"] = _rand(rng, (3 * width,), 0.1)
        sd[f"{p}.self_attention.out_proj.weight"] = _rand(rng, (width, width), width ** -0.5)
        sd[f"{p}.self_attention.out_proj.bias"] = _rand(rng, (width,), 0.1)
        sd[f"{p}.mlp.linear_1.weight"] = _rand(rng, (4 * width, width), width ** -0.5)
        sd[f"{p}.mlp.linear_1.bias"] = _rand(rng, (4 * width,), 0.1)
        sd[f"{p}.mlp.linear_2.weight"] = _rand(rng, (width, 4 * width), (4 * width) ** -0.5)
        sd[f"{p}.mlp.linear_2.bias"] = _rand(rng, (width,), 0.1)
    sd["heads.head.weight"], sd["heads.head.bias"] = _rand(rng, (10, width)), _rand(rng, (10,))
    return sd


def test_torchvision_vit_into_vit_b16_resizes_the_pos_embedding(two_blocks):
    """A 224 px checkpoint (14 x 14 grid) into a 64 px model (4 x 4): the
    table is resized within 1e-6 of the JAX package's."""
    jm, v, pm = _cnn_pair("vit_b_16", 64)
    ckpt = _torchvision_vit_sd(np.random.default_rng(8))
    _overlay_both(jm, v, pm, ckpt, close=("backbone.pos_embedding",))
    assert pm.backbone.pos_embedding.shape == (17, 768)
    assert torch.equal(pm.backbone.pos_embedding[0], ckpt["encoder.pos_embedding"][0, 0])


def _torchvision_mobilenet_v2_sd(rng) -> dict:
    sd = {"features.0.0.weight": _rand(rng, (32, 3, 3, 3), 27 ** -0.5)}
    _bn(rng, sd, "features.0.1", 32)
    cin, f = 32, 1
    for t, c, n, _ in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
                       (6, 160, 3, 2), (6, 320, 1, 1)):
        for _ in range(n):
            p, hid = f"features.{f}.conv", cin * t
            if t == 1:
                sd[f"{p}.0.0.weight"] = _rand(rng, (hid, 1, 3, 3), 9 ** -0.5)
                _bn(rng, sd, f"{p}.0.1", hid)
                sd[f"{p}.1.weight"] = _rand(rng, (c, hid, 1, 1), hid ** -0.5)
                _bn(rng, sd, f"{p}.2", c)
            else:
                sd[f"{p}.0.0.weight"] = _rand(rng, (hid, cin, 1, 1), cin ** -0.5)
                _bn(rng, sd, f"{p}.0.1", hid)
                sd[f"{p}.1.0.weight"] = _rand(rng, (hid, 1, 3, 3), 9 ** -0.5)
                _bn(rng, sd, f"{p}.1.1", hid)
                sd[f"{p}.2.weight"] = _rand(rng, (c, hid, 1, 1), hid ** -0.5)
                _bn(rng, sd, f"{p}.3", c)
            cin, f = c, f + 1
    sd["features.18.0.weight"] = _rand(rng, (1280, 320, 1, 1))  # not read: the stage taps 320
    _bn(rng, sd, "features.18.1", 1280)
    return sd


def _torchvision_densenet121_sd(rng) -> dict:
    sd = {"features.conv0.weight": _rand(rng, (64, 3, 7, 7), 147 ** -0.5)}
    _bn(rng, sd, "features.norm0", 64)
    c = 64
    for bi, n in enumerate((6, 12, 24, 16), start=1):
        for li in range(1, n + 1):
            p = f"features.denseblock{bi}.denselayer{li}"
            _bn(rng, sd, f"{p}.norm1", c)
            sd[f"{p}.conv1.weight"] = _rand(rng, (128, c, 1, 1), c ** -0.5)
            _bn(rng, sd, f"{p}.norm2", 128)
            sd[f"{p}.conv2.weight"] = _rand(rng, (32, 128, 3, 3), 1152 ** -0.5)
            c += 32
        if bi < 4:
            _bn(rng, sd, f"features.transition{bi}.norm", c)
            sd[f"features.transition{bi}.conv.weight"] = _rand(rng, (c // 2, c, 1, 1), c ** -0.5)
            c //= 2
    _bn(rng, sd, "features.norm5", c)
    return sd


@pytest.mark.parametrize("name", ["mobilenetv2", "densenet121"])
def test_torchvision_mobilenet_and_densenet_match_jax(name):
    jm, v, pm = _cnn_pair(name, 32)
    rng = np.random.default_rng(9)
    ckpt = (_torchvision_mobilenet_v2_sd if name == "mobilenetv2"
            else _torchvision_densenet121_sd)(rng)
    _overlay_both(jm, v, pm, ckpt)


def test_refusals_match_jax(tmp_path, clip_vit):
    """Each refusal of the JAX package is one of the port's."""
    sd = clip_vit["sd"]
    jv = jax_get_model("vgg11", 32, RED, bins=BINS, anchor_points=ANCHORS)
    pv = get_model("vgg11", 32, RED, BINS, ANCHORS, device="cpu")
    for fn, model in ((jax_apply, jv), (apply_pretrained, pv)):  # CLIP into a CNN
        args = (model, {"params": {}}, sd) if fn is jax_apply else (model, sd)
        with pytest.raises(ValueError, match="clip_"):
            fn(*args)
    with torch.device("meta"):
        p32 = ClipEBC("vit_b_32", BINS, ANCHORS, reduction=RED, num_vpt=2)
    j32 = jax_get_model("clip_vit_b_32", 224, RED, bins=BINS, anchor_points=ANCHORS, num_vpt=2)
    with pytest.raises(ValueError, match="vit_b_16"):  # backbone mismatch
        jax_apply(j32, {"params": {}}, sd)
    with pytest.raises(ValueError, match="vit_b_16"):
        apply_pretrained(p32, sd)

    tower = str(tmp_path / "clip_image_encoder_vit_b_16.npz")
    save_prepared_tree(tower, {"image_encoder": {"class_embedding": np.zeros(768, np.float32)}},
                       meta={"backbone": "vit_b_16", "split": "image"})
    full = str(tmp_path / "clip_vit_b_16.npz")
    jax_convert.save_prepared_tree(
        full, {"image_encoder": {"class_embedding": np.zeros(768, np.float32)},
               "text_encoder": {"positional_embedding": np.zeros((77, 512), np.float32)}},
        meta={"backbone": "vit_b_16", "split": "full"})
    for path, match in ((tower, "tower-only"), (full, "vit_b_16")):
        with pytest.raises(ValueError, match=match):
            jax_apply(j32, {"params": {}}, path, allow_byte_tokenizer=True)
        with pytest.raises(ValueError, match=match):
            apply_pretrained(p32, path, allow_byte_tokenizer=True)
    with pytest.raises(ValueError, match="requires a clip_"):
        apply_pretrained(pv, full, allow_byte_tokenizer=True)

    odd = {"foo.weight": torch.zeros(2)}
    with pytest.raises(ValueError, match="unrecognized checkpoint family"):
        jax_apply(jv, {"params": {}}, odd)
    with pytest.raises(ValueError, match="unrecognized checkpoint family"):
        apply_pretrained(pv, odd)
