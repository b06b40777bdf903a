"""Weight bridge from the JAX package's trees: counterpart of
``clip_ebc_tpu/models/convert.py``, in the other direction.

:func:`from_jax_params` turns a JAX ``ClipEBC`` variable tree (nested
dicts of numpy arrays: ``params`` and ``batch_stats``), over any of the
nine CLIP backbones, into this port's ``state_dict``, whose keys are the
reference's torch names. The JAX
package's ``convert_reference_clip_ebc`` maps such a state dict back, so
the two packages share weights without either importing the other.

Layout rules:
- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel HWIO -> OIHW; the ViT patchify kernel (p, p, c, F) -> (F, c, p, p);
- stacked VPT (depth, n, width) -> ``vpt_{i}``;
- LayerNorm ``<name>/LayerNorm_0/{scale,bias}`` -> ``<name>.{weight,bias}``;
- BatchNorm ``scale/bias`` + ``batch_stats`` ``mean/var`` -> ``weight/bias/running_mean/running_var``;
- the CLIP ResNet trunk ``stem_conv{i}``/``stem_bn{i}`` -> ``conv{i}``/``bn{i}``,
  ``layer{i}_{j}/{conv,bn}{1-3}`` -> ``layer{i}.{j}.{conv,bn}{1-3}``,
  ``down_conv``/``down_bn`` -> ``downsample.{0,1}``, ``attnpool`` as it is;
- decoder ``BasicBlock_{j}`` / ``BottleneckBlock_{j}`` -> the j-th block's
  index in the decoder Sequential.

:func:`head_state_from_jax` does the same for a JAX ``Classifier`` or
``Regressor`` (the non-CLIP models) into the port's model of that
backbone; its VGG and head names are the reference's torch names, so
``convert_reference_classifier`` of the JAX package reads them back.

:func:`quant_state_from_jax` and :func:`quant_state_to_jax` carry the W8A8
``quant`` collection (the calibrated ``act_amax`` / ``qkv_amax`` leaves)
between a JAX variable tree and the port's ``ops.quant.quant_state``
names, so both packages can be fed the same scales.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(sd: StateDict, dst: str, tree: Mapping[str, Any]) -> None:
    sd[f"{dst}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{dst}.bias"] = _t(tree["bias"])


def _conv(a) -> torch.Tensor:
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def _ln(sd: StateDict, dst: str, tree: Mapping[str, Any]) -> None:
    sd[f"{dst}.weight"] = _t(tree["LayerNorm_0"]["scale"])
    sd[f"{dst}.bias"] = _t(tree["LayerNorm_0"]["bias"])


def _bn(sd: StateDict, dst: str, params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    """``params``/``stats``: the subtrees of the JAX ``BatchNorm`` wrapper,
    which holds flax's ``nn.BatchNorm`` as ``BatchNorm_0``."""
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[f"{dst}.weight"] = _t(p["scale"])
    sd[f"{dst}.bias"] = _t(p["bias"])
    sd[f"{dst}.running_mean"] = _t(s["mean"])
    sd[f"{dst}.running_var"] = _t(s["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _resblocks(sd: StateDict, tree: Mapping[str, Any]) -> None:
    i = 0
    while f"resblock_{i}" in tree:
        src, out = tree[f"resblock_{i}"], f"transformer.resblocks.{i}"
        _ln(sd, f"{out}.ln_1", src["ln_1"])
        _ln(sd, f"{out}.ln_2", src["ln_2"])
        attn = src["attn"]
        sd[f"{out}.attn.in_proj_weight"] = _t(np.asarray(attn["in_proj"]["kernel"]).T)
        sd[f"{out}.attn.in_proj_bias"] = _t(attn["in_proj"]["bias"])
        _dense(sd, f"{out}.attn.out_proj", attn["out_proj"])
        _dense(sd, f"{out}.mlp.c_fc", src["mlp_fc"])
        _dense(sd, f"{out}.mlp.c_proj", src["mlp_proj"])
        i += 1


def clip_vit_state(tree: Mapping[str, Any]) -> StateDict:
    """JAX ``ClipViT`` params (without ``vpt``) -> ``ClipViT`` state dict."""
    sd: StateDict = {"conv1.weight": _conv(tree["conv1"]["kernel"])}
    sd["class_embedding"] = _t(tree["class_embedding"])
    sd["positional_embedding"] = _t(tree["positional_embedding"])
    _ln(sd, "ln_pre", tree["ln_pre"])
    _ln(sd, "ln_post", tree["ln_post"])
    _resblocks(sd, tree)
    return sd


def clip_text_state(tree: Mapping[str, Any]) -> StateDict:
    """JAX ``ClipTextEncoder`` params -> ``ClipTextEncoder`` state dict."""
    sd: StateDict = {"token_embedding.weight": _t(tree["token_embedding"]["embedding"])}
    sd["positional_embedding"] = _t(tree["positional_embedding"])
    _ln(sd, "ln_final", tree["ln_final"])
    sd["text_projection"] = _t(tree["text_projection"])
    _resblocks(sd, tree)
    return sd


def basic_block_state(params: Mapping[str, Any], stats: Mapping[str, Any],
                      n_convs: int = 2) -> StateDict:
    """JAX decoder ``BasicBlock`` (``n_convs`` 2) or ``BottleneckBlock``
    (3) params + batch_stats -> the port block's state dict
    (``ConvBNAct_{n_convs}``, the channel-changing shortcut, becomes
    ``downsample``)."""
    sd: StateDict = {}
    names = {f"ConvBNAct_{i}": (f"conv{i + 1}", f"bn{i + 1}") for i in range(n_convs)}
    names[f"ConvBNAct_{n_convs}"] = ("downsample.0", "downsample.1")
    for unit, (conv, bn) in names.items():
        if unit in params:
            sd[f"{conv}.weight"] = _conv(params[unit]["Conv_0"]["kernel"])
            _bn(sd, bn, params[unit]["BatchNorm_0"], stats[unit]["BatchNorm_0"])
    return sd


def clip_resnet_state(params: Mapping[str, Any], stats: Mapping[str, Any]) -> StateDict:
    """JAX ``ClipModifiedResNet`` params + batch_stats ->
    ``ClipModifiedResNet`` state dict (the attention pool where present)."""
    sd: StateDict = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = _conv(params[f"stem_conv{i}"]["kernel"])
        _bn(sd, f"bn{i}", params[f"stem_bn{i}"], stats[f"stem_bn{i}"])
    for li in range(1, 5):
        bi = 0
        while f"layer{li}_{bi}" in params:
            p, st, dst = params[f"layer{li}_{bi}"], stats[f"layer{li}_{bi}"], f"layer{li}.{bi}"
            for c in (1, 2, 3):
                sd[f"{dst}.conv{c}.weight"] = _conv(p[f"conv{c}"]["kernel"])
                _bn(sd, f"{dst}.bn{c}", p[f"bn{c}"], st[f"bn{c}"])
            if "down_conv" in p:
                sd[f"{dst}.downsample.0.weight"] = _conv(p["down_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", p["down_bn"], st["down_bn"])
            bi += 1
    if "attnpool" in params:
        ap = params["attnpool"]
        sd["attnpool.positional_embedding"] = _t(ap["positional_embedding"])
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            _dense(sd, f"attnpool.{proj}", ap[proj])
    return sd


def from_jax_params(
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any],
    decoder_cfg: Sequence[Union[int, str]] = (768,),
) -> StateDict:
    """JAX ``ClipEBC`` variables (a ViT or a ModifiedResNet backbone) ->
    this port's state dict. ``decoder_cfg`` places the decoder blocks at
    their Sequential indices (``"U"`` entries take an index but hold no
    weights)."""
    ie = params["image_encoder"]
    trunk = (clip_vit_state(ie) if "class_embedding" in ie
             else clip_resnet_state(ie, batch_stats["image_encoder"]))
    sd: StateDict = {f"image_encoder.{k}": v for k, v in trunk.items()}
    if "vpt" in ie:
        for i, v in enumerate(np.asarray(ie["vpt"])):
            sd[f"vpt_{i}"] = _t(v)
    sd.update({f"text_encoder.{k}": v for k, v in clip_text_state(params["text_encoder"]).items()})

    dec_p, dec_s = params["image_decoder"], batch_stats["image_decoder"]
    block_idx = [i for i, v in enumerate(decoder_cfg) if v != "U"]
    for j, idx in enumerate(block_idx):
        kind, n_convs = (("BottleneckBlock", 3) if f"BottleneckBlock_{j}" in dec_p
                         else ("BasicBlock", 2))
        block = basic_block_state(dec_p[f"{kind}_{j}"], dec_s[f"{kind}_{j}"], n_convs)
        sd.update({f"image_decoder.{idx}.{k}": v for k, v in block.items()})
    if "projection" in params:
        sd["projection.weight"] = _conv(params["projection"]["kernel"])
        sd["projection.bias"] = _t(params["projection"]["bias"])
    sd["logit_scale"] = _t(params["logit_scale"]).reshape(())
    return sd


# The decoder convolutions of each block kind: JAX ConvBNAct scope -> port
# module (a bottleneck's shortcut is its fourth ConvBNAct)
_DECODER_CONVS = {
    "BasicBlock": {"ConvBNAct_0": "conv1", "ConvBNAct_1": "conv2", "ConvBNAct_2": "downsample.0"},
    "BottleneckBlock": {"ConvBNAct_0": "conv1", "ConvBNAct_1": "conv2", "ConvBNAct_2": "conv3",
                        "ConvBNAct_3": "downsample.0"},
}


def _quant_names(n_blocks: int, decoder_cfg: Sequence[Union[int, str]],
                 kind: str = "BasicBlock") -> Dict[str, str]:
    """``{port buffer name: JAX quant-tree path}`` of a ``ClipEBC``: the
    ``n_blocks`` ViT blocks' (0 for a ModifiedResNet trunk, which stays
    float) and the decoder's, whose blocks are ``kind``."""
    names = {}
    for i in range(n_blocks):
        src, dst = f"image_encoder/resblock_{i}", f"image_encoder.transformer.resblocks.{i}"
        names[f"{dst}.attn.in_proj_act_amax"] = f"{src}/attn/in_proj/act_amax"
        names[f"{dst}.attn.qkv_amax"] = f"{src}/attn/qkv_amax"
        names[f"{dst}.attn.out_proj.act_amax"] = f"{src}/attn/out_proj/act_amax"
        names[f"{dst}.mlp.c_fc.act_amax"] = f"{src}/mlp_fc/act_amax"
        names[f"{dst}.mlp.c_proj.act_amax"] = f"{src}/mlp_proj/act_amax"
    block_idx = [i for i, v in enumerate(decoder_cfg) if v != "U"]
    for j, idx in enumerate(block_idx):
        for unit, conv in _DECODER_CONVS[kind].items():
            names[f"image_decoder.{idx}.{conv}.act_amax"] = (
                f"image_decoder/{kind}_{j}/{unit}/Conv_0/act_amax"
            )
    return names


def _flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def quant_state_from_jax(
    quant: Mapping[str, Any], decoder_cfg: Sequence[Union[int, str]] = (768,)
) -> StateDict:
    """A JAX ``variables["quant"]`` tree (nested dicts of numpy leaves) ->
    the port's quant state (``ops.quant.load_quant_state``); the decoder's
    block kind is read from the tree."""
    flat = _flatten_tree(quant)
    n_blocks = len({k.split("/")[1] for k in flat if k.startswith("image_encoder/")})
    kind = ("BottleneckBlock" if any(k.startswith("image_decoder/BottleneckBlock_") for k in flat)
            else "BasicBlock")
    names = _quant_names(n_blocks, decoder_cfg, kind)
    state = {dst: _t(flat[src]) for dst, src in names.items() if src in flat}
    if len(state) != len(flat):
        raise KeyError(f"unknown quant leaves: {sorted(set(flat) - set(names.values()))[:8]}")
    return state


def quant_state_to_jax(
    state: Mapping[str, torch.Tensor], decoder_cfg: Sequence[Union[int, str]] = (768,)
) -> Dict[str, Any]:
    """The port's quant state (``ops.quant.quant_state``) -> a JAX
    ``variables["quant"]`` tree of numpy leaves; a decoder with ``conv3``
    buffers is a bottleneck decoder."""
    n_blocks = len({k.split(".")[3] for k in state if k.startswith("image_encoder.")})
    kind = "BottleneckBlock" if any(".conv3." in k for k in state) else "BasicBlock"
    names = _quant_names(n_blocks, decoder_cfg, kind)
    unknown = sorted(set(state) - set(names))
    if unknown:
        raise KeyError(f"unknown quant buffers: {unknown[:8]}")
    return _unflatten_tree({names[k]: np.asarray(v, np.float32) for k, v in state.items()})


def _unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_prepared_tree(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, str]]:
    """Read a JAX prepared-tree ``.npz`` (keys ``params/...``,
    ``stats/...``, ``meta/...``, the format of ``save_prepared_tree``);
    returns ``(params, stats, meta)``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    stats = {k[len("stats/"):]: v for k, v in flat.items() if k.startswith("stats/")}
    meta = {k[len("meta/"):]: str(v) for k, v in flat.items() if k.startswith("meta/")}
    if not params:
        raise ValueError(f"{path} is not a prepared-tree artifact (no 'params/' entries)")
    return _unflatten_tree(params), _unflatten_tree(stats), meta


def _subtree(tree: Mapping[str, Any], path: str) -> Mapping[str, Any]:
    for k in path.split("/"):
        tree = tree.get(k, {})
    return tree


def _leaf_state(sd: StateDict, dst: str, m: nn.Module, p: Mapping[str, Any],
                s: Mapping[str, Any]) -> None:
    """One port module's tensors from its JAX subtree (``p`` params, ``s``
    batch_stats): a conv (HWIO kernel, the ViT patchify's (p, p, c, F)
    too), a JAX ``BatchNorm`` wrapper, a LayerNorm (flax's own or the
    ``LayerNormF32`` wrapper around one), a Dense, or a module's direct
    parameters under their own names."""
    from .blocks import BatchNorm
    from .transformer import Linear, PatchifyMatmul

    if isinstance(m, BatchNorm):
        _bn(sd, dst, p, s)
    elif isinstance(m, (nn.Conv2d, PatchifyMatmul)):
        sd[f"{dst}.weight"] = _conv(p["kernel"])
        if m.bias is not None:
            sd[f"{dst}.bias"] = _t(p["bias"])
    elif isinstance(m, nn.LayerNorm):
        _ln(sd, dst, p if "LayerNorm_0" in p else {"LayerNorm_0": p})
    elif isinstance(m, Linear):
        _dense(sd, dst, p)
    else:
        for name, _ in m.named_parameters(recurse=False):
            sd[f"{dst}.{name}"] = _t(p[name])


def _vgg_names(stage: nn.Sequential, src: str, dst: str) -> Dict[str, str]:
    """``VGGStage`` Sequential indices -> ``ConvBNAct_{j}`` scopes."""
    from .blocks import BatchNorm

    names, j = {}, 0
    for i, m in enumerate(stage):
        if isinstance(m, nn.Conv2d):
            names[f"{dst}.{i}"] = f"{src}/ConvBNAct_{j}/Conv_0"
            if i + 1 < len(stage) and isinstance(stage[i + 1], BatchNorm):
                names[f"{dst}.{i + 1}"] = f"{src}/ConvBNAct_{j}/BatchNorm_0"
            j += 1
    return names


def _block_names(block: nn.Module, src: str, dst: str, unit: str) -> Dict[str, str]:
    """A residual block's ``conv{n}``/``bn{n}``/``downsample.{0,1}``: the
    encoder's ``Conv_{n-1}``/``BatchNorm_{n-1}`` (``unit`` "") or the
    decoder's ``ConvBNAct_{n-1}/{Conv_0,BatchNorm_0}`` (``unit``
    "ConvBNAct")."""
    n_convs = 3 if hasattr(block, "conv3") else 2
    names = {}
    for n in range(1, n_convs + 2):
        conv, bn = (f"conv{n}", f"bn{n}") if n <= n_convs else ("downsample.0", "downsample.1")
        if n > n_convs and block.downsample is None:
            continue
        if unit:
            names[f"{dst}.{conv}"] = f"{src}/{unit}_{n - 1}/Conv_0"
            names[f"{dst}.{bn}"] = f"{src}/{unit}_{n - 1}/BatchNorm_0"
        else:
            names[f"{dst}.{conv}"] = f"{src}/Conv_{n - 1}"
            names[f"{dst}.{bn}"] = f"{src}/BatchNorm_{n - 1}"
    return names


def _backbone_names(bb: nn.Module) -> Dict[str, str]:
    """``{port module name: JAX scope}`` of every module of a backbone that
    holds tensors, relative to ``backbone``."""
    from .csrnet import CSRNet
    from .resnet import PlainResNetBackbone
    from .vgg import VGGAutoEncoder, VGGEncoder
    from .vit import ViTEncoder

    if isinstance(bb, VGGEncoder):
        names = _vgg_names(bb.features, "features", "features")
        if isinstance(bb, VGGAutoEncoder):
            names.update({"reg_layer.0": "reg0/Conv_0", "reg_layer.2": "reg1/Conv_0"})
        return names
    if isinstance(bb, PlainResNetBackbone):
        enc = bb.encoder
        names = {"encoder.conv1": "encoder/Conv_0", "encoder.bn1": "encoder/BatchNorm_0"}
        k = 0
        for li in range(1, 5):
            for j, block in enumerate(getattr(enc, f"layer{li}")):
                kind = "_TVBottleneck" if hasattr(block, "conv3") else "_TVBasicBlock"
                names.update(_block_names(block, f"encoder/{kind}_{k}",
                                          f"encoder.layer{li}.{j}", ""))
                k += 1
        if hasattr(bb, "decoder"):
            j = 0
            for i, block in enumerate(bb.decoder):
                if hasattr(block, "conv1"):
                    kind = "BottleneckBlock" if hasattr(block, "conv3") else "BasicBlock"
                    names.update(_block_names(block, f"decoder/{kind}_{j}", f"decoder.{i}",
                                              "ConvBNAct"))
                    j += 1
        return names
    if isinstance(bb, CSRNet):
        names = _vgg_names(bb.features, "features", "features")
        names.update(_vgg_names(bb.backend, "backend", "backend"))
        if bb.context is not None:
            names.update({f"context.{n}": f"context/{n}" for n, _ in bb.context.named_children()})
        return names
    if isinstance(bb, ViTEncoder):
        names = {"": "", "patchify": "patchify", "ln_final": "ln_final"}
        for i in range(len(bb.blocks)):
            src, dst = f"block_{i}", f"blocks.{i}"
            names.update({f"{dst}.ln_1": f"{src}/ln_1", f"{dst}.ln_2": f"{src}/ln_2",
                          f"{dst}.attn": f"{src}/attn",
                          f"{dst}.attn.out_proj": f"{src}/attn/out_proj",
                          f"{dst}.mlp.c_fc": f"{src}/mlp_fc",
                          f"{dst}.mlp.c_proj": f"{src}/mlp_proj"})
        return names
    # the JAX module's own names (MobileNetV2, DenseNet, ConvNeXt)
    return {n: n.replace(".", "/") for n, m in bb.named_modules()
            if n and (list(m.parameters(recurse=False)) or list(m.buffers(recurse=False)))}


def head_state_from_jax(model: nn.Module, params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]) -> StateDict:
    """JAX ``Classifier``/``Regressor`` variables (nested dicts of numpy
    arrays: ``params`` and ``batch_stats``) -> the state dict of the
    port's ``model`` of the same backbone and head."""
    from .heads import Classifier

    names = {f"backbone.{k}".rstrip("."): f"backbone/{v}".rstrip("/")
             for k, v in _backbone_names(model.backbone).items()}
    if isinstance(model, Classifier):
        if isinstance(model.classifier, nn.Sequential):
            names.update({"classifier.0": "cls_hidden", "classifier.2": "cls_out"})
        else:
            names["classifier"] = "cls_out"
    else:
        names["regressor.0"] = "Conv_0"
    modules = dict(model.named_modules())
    sd: StateDict = {}
    for dst, src in names.items():
        if dst.endswith(".attn"):  # the joint in-projection lives on the attention module
            proj = _subtree(params, f"{src}/in_proj")
            sd[f"{dst}.in_proj_weight"] = _t(np.asarray(proj["kernel"]).T)
            sd[f"{dst}.in_proj_bias"] = _t(proj["bias"])
            continue
        _leaf_state(sd, dst, modules[dst], _subtree(params, src), _subtree(batch_stats, src))
    return sd


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a port ``.pt`` state dict or a JAX prepared-tree ``.npz`` (a
    ``ClipEBC``, or a ``Classifier``/``Regressor``) into ``model`` (strict:
    every key must match)."""
    from .heads import Classifier, Regressor

    if path.endswith(".npz"):
        params, stats, _ = load_prepared_tree(path)
        if isinstance(model, (Classifier, Regressor)):
            sd = head_state_from_jax(model, params, stats)
        else:
            sd = from_jax_params(params, stats, getattr(model, "decoder_cfg", (768,)))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd, strict=True)
