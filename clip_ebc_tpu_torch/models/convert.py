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

The last section reads torch checkpoints: counterpart of the JAX
package's converters (``load_torch_state_dict``, ``detect_checkpoint_kind``,
``detect_clip_arch``, one ``convert_*`` per family, ``save_prepared_tree``).
They write the JAX tree layout as numpy, as the JAX converters do, so a
prepared artifact serves both packages; the bridge above then carries a
converted tree into the port's names (``models/pretrained.py``).
"""

from __future__ import annotations

import re
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
    weights). A top-level subtree the variables lack (a checkpoint's
    overlay: the towers alone) is left out of the state dict."""
    sd: StateDict = {}
    ie = params.get("image_encoder")
    if ie is not None:
        trunk = (clip_vit_state(ie) if "class_embedding" in ie
                 else clip_resnet_state(ie, batch_stats["image_encoder"]))
        sd.update({f"image_encoder.{k}": v for k, v in trunk.items()})
        if "vpt" in ie:
            for i, v in enumerate(np.asarray(ie["vpt"])):
                sd[f"vpt_{i}"] = _t(v)
    if "text_encoder" in params:
        sd.update({f"text_encoder.{k}": v
                   for k, v in clip_text_state(params["text_encoder"]).items()})
    if "image_decoder" in params:
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
    if "logit_scale" in params:
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
    port's ``model`` of the same backbone and head. A module whose JAX
    scope the variables lack (a checkpoint's overlay: the backbone alone)
    is left out of the state dict."""
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
            if proj:
                sd[f"{dst}.in_proj_weight"] = _t(np.asarray(proj["kernel"]).T)
                sd[f"{dst}.in_proj_bias"] = _t(proj["bias"])
            continue
        p, s = _subtree(params, src), _subtree(batch_stats, src)
        if p or s:
            _leaf_state(sd, dst, modules[dst], p, s)
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


# ---------------------------------------------------------------------------
# torch checkpoints -> JAX-layout trees (numpy): the JAX package's converters
# ---------------------------------------------------------------------------
#
# Conventions, as in the JAX package:
# - torch Conv2d weight (O, I, kH, kW) -> kernel (kH, kW, I, O);
# - torch Linear weight (O, I) -> Dense kernel (I, O);
# - nn.MultiheadAttention in_proj rows [q; k; v] -> kernel columns [q, k, v];
# - BatchNorm weight/bias -> scale/bias (params), running_mean/var ->
#   mean/var (stats); ``num_batches_tracked`` is not read.


def _np(t) -> np.ndarray:
    """fp32 numpy copy of a tensor or array (an OpenAI archive is fp16). A
    copy, never a view: a view of live storage changes with a later
    in-place update of the tensor."""
    if isinstance(t, torch.Tensor):
        return np.array(t.detach().cpu().float().numpy(), np.float32)
    return np.asarray(t, np.float32)


def conv_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def dense_kernel(w) -> np.ndarray:
    return _np(w).T


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A ``.pt``/``.pth`` file's state dict: a TorchScript archive (how
    OpenAI ships CLIP), a plain state dict, a dict wrapping one under
    ``state_dict``, ``model_state_dict`` or ``model``, or a pickled module."""
    try:
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        return dict(obj.state_dict())
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                return dict(obj[key])
        return dict(obj)
    raise ValueError(f"cannot extract a state dict from {path}")


class _TreeBuilder:
    def __init__(self) -> None:
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    @staticmethod
    def put(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def param(self, path: str, value) -> None:
        self.put(self.params, path, value)

    def stat(self, path: str, value) -> None:
        self.put(self.stats, path, value)

    def bn(self, dst: str, sd: Mapping[str, Any], src: str) -> None:
        """torch BN at ``src`` -> the JAX BatchNorm wrapper at ``dst``."""
        inner = f"{dst}/BatchNorm_0"
        self.param(f"{inner}/scale", _np(sd[f"{src}.weight"]))
        self.param(f"{inner}/bias", _np(sd[f"{src}.bias"]))
        self.stat(f"{inner}/mean", _np(sd[f"{src}.running_mean"]))
        self.stat(f"{inner}/var", _np(sd[f"{src}.running_var"]))

    def ln(self, dst: str, sd: Mapping[str, Any], src: str) -> None:
        self.param(f"{dst}/LayerNorm_0/scale", _np(sd[f"{src}.weight"]))
        self.param(f"{dst}/LayerNorm_0/bias", _np(sd[f"{src}.bias"]))

    def attn(self, dst: str, sd: Mapping[str, Any], src: str) -> None:
        """torch nn.MultiheadAttention -> MultiHeadAttention."""
        self.param(f"{dst}/in_proj/kernel", dense_kernel(sd[f"{src}.in_proj_weight"]))
        self.param(f"{dst}/in_proj/bias", _np(sd[f"{src}.in_proj_bias"]))
        self.param(f"{dst}/out_proj/kernel", dense_kernel(sd[f"{src}.out_proj.weight"]))
        self.param(f"{dst}/out_proj/bias", _np(sd[f"{src}.out_proj.bias"]))

    def resblock(self, dst: str, sd: Mapping[str, Any], src: str) -> None:
        """CLIP ResidualAttentionBlock (attn, ln_1/2, mlp c_fc/c_proj)."""
        self.ln(f"{dst}/ln_1", sd, f"{src}.ln_1")
        self.ln(f"{dst}/ln_2", sd, f"{src}.ln_2")
        self.attn(f"{dst}/attn", sd, f"{src}.attn")
        self.param(f"{dst}/mlp_fc/kernel", dense_kernel(sd[f"{src}.mlp.c_fc.weight"]))
        self.param(f"{dst}/mlp_fc/bias", _np(sd[f"{src}.mlp.c_fc.bias"]))
        self.param(f"{dst}/mlp_proj/kernel", dense_kernel(sd[f"{src}.mlp.c_proj.weight"]))
        self.param(f"{dst}/mlp_proj/bias", _np(sd[f"{src}.mlp.c_proj.bias"]))

    def out(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return self.params, self.stats


def convert_vgg_features(sd: Mapping[str, Any], use_bn: bool, prefix: str = "features"
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """torchvision ``features.*`` conv/BN weights -> the ``VGGStage`` tree
    (``ConvBNAct_{j}`` per conv; truncated configurations too)."""
    b = _TreeBuilder()
    conv_idx = sorted(
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(rf"{prefix}\.(\d+)\.weight", k)) and sd[k].ndim == 4
    )
    for j, idx in enumerate(conv_idx):
        b.param(f"ConvBNAct_{j}/Conv_0/kernel", conv_kernel(sd[f"{prefix}.{idx}.weight"]))
        b.param(f"ConvBNAct_{j}/Conv_0/bias", _np(sd[f"{prefix}.{idx}.bias"]))
        if use_bn:
            b.bn(f"ConvBNAct_{j}/BatchNorm_0", sd, f"{prefix}.{idx + 1}")
    return b.out()


def convert_clip_vit(sd: Mapping[str, Any], include_proj: bool = False
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``visual.*`` of a CLIP ViT checkpoint -> the ``ClipViT`` tree;
    ``include_proj`` adds the pooled head's projection (the prepared image
    tower)."""
    b = _TreeBuilder()
    b.param("conv1/kernel", conv_kernel(sd["visual.conv1.weight"]))
    b.param("class_embedding", _np(sd["visual.class_embedding"]))
    b.param("positional_embedding", _np(sd["visual.positional_embedding"]))
    b.ln("ln_pre", sd, "visual.ln_pre")
    b.ln("ln_post", sd, "visual.ln_post")
    if include_proj and "visual.proj" in sd:
        b.param("proj", _np(sd["visual.proj"]))  # already (width, embed)
    i = 0
    while f"visual.transformer.resblocks.{i}.ln_1.weight" in sd:
        b.resblock(f"resblock_{i}", sd, f"visual.transformer.resblocks.{i}")
        i += 1
    return b.out()


def convert_clip_resnet(sd: Mapping[str, Any], include_attnpool: bool = False
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``visual.*`` of a CLIP ModifiedResNet checkpoint; ``include_attnpool``
    adds the attention pool (the prepared image tower)."""
    b = _TreeBuilder()
    if include_attnpool and "visual.attnpool.positional_embedding" in sd:
        ap = "visual.attnpool"
        b.param("attnpool/positional_embedding", _np(sd[f"{ap}.positional_embedding"]))
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            b.param(f"attnpool/{proj}/kernel", dense_kernel(sd[f"{ap}.{proj}.weight"]))
            b.param(f"attnpool/{proj}/bias", _np(sd[f"{ap}.{proj}.bias"]))
    for i in (1, 2, 3):
        b.param(f"stem_conv{i}/kernel", conv_kernel(sd[f"visual.conv{i}.weight"]))
        b.bn(f"stem_bn{i}", sd, f"visual.bn{i}")
    for li in range(1, 5):
        bi = 0
        while f"visual.layer{li}.{bi}.conv1.weight" in sd:
            src, dst = f"visual.layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in (1, 2, 3):
                b.param(f"{dst}/conv{ci}/kernel", conv_kernel(sd[f"{src}.conv{ci}.weight"]))
                b.bn(f"{dst}/bn{ci}", sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                b.param(f"{dst}/down_conv/kernel", conv_kernel(sd[f"{src}.downsample.0.weight"]))
                b.bn(f"{dst}/down_bn", sd, f"{src}.downsample.1")
            bi += 1
    return b.out()


def convert_clip_text(sd: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    b = _TreeBuilder()
    b.param("token_embedding/embedding", _np(sd["token_embedding.weight"]))
    b.param("positional_embedding", _np(sd["positional_embedding"]))
    b.ln("ln_final", sd, "ln_final")
    b.param("text_projection", _np(sd["text_projection"]))  # already (width, embed)
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        b.resblock(f"resblock_{i}", sd, f"transformer.resblocks.{i}")
        i += 1
    return b.out()


def _towers(img: Tuple[Dict[str, Any], Dict[str, Any]], txt: Tuple[Dict[str, Any], Dict[str, Any]]
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    params: Dict[str, Any] = {"image_encoder": img[0], "text_encoder": txt[0]}
    stats: Dict[str, Any] = {}
    if img[1]:
        stats["image_encoder"] = img[1]
    if txt[1]:
        stats["text_encoder"] = txt[1]
    return params, stats


def convert_clip_ebc(sd: Mapping[str, Any], is_vit: bool) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A full OpenAI CLIP checkpoint -> the pretrained subtrees of a
    ``ClipEBC`` (``image_encoder``, ``text_encoder``, ``logit_scale``); the
    decoder, projection and prompts keep their fresh initialization."""
    params, stats = _towers((convert_clip_vit if is_vit else convert_clip_resnet)(sd),
                            convert_clip_text(sd))
    if "logit_scale" in sd:
        params["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    return params, stats


def convert_torchvision_vit(sd: Mapping[str, Any]) -> Dict[str, Any]:
    b = _TreeBuilder()
    b.param("patchify/kernel", conv_kernel(sd["conv_proj.weight"]))
    b.param("patchify/bias", _np(sd["conv_proj.bias"]))
    b.param("class_token", _np(sd["class_token"]))
    b.param("pos_embedding", _np(sd["encoder.pos_embedding"])[0])
    b.ln("ln_final", sd, "encoder.ln")
    i = 0
    while f"encoder.layers.encoder_layer_{i}.ln_1.weight" in sd:
        src, dst = f"encoder.layers.encoder_layer_{i}", f"block_{i}"
        b.ln(f"{dst}/ln_1", sd, f"{src}.ln_1")
        b.ln(f"{dst}/ln_2", sd, f"{src}.ln_2")
        b.attn(f"{dst}/attn", sd, f"{src}.self_attention")
        b.param(f"{dst}/mlp_fc/kernel", dense_kernel(sd[f"{src}.mlp.linear_1.weight"]))
        b.param(f"{dst}/mlp_fc/bias", _np(sd[f"{src}.mlp.linear_1.bias"]))
        b.param(f"{dst}/mlp_proj/kernel", dense_kernel(sd[f"{src}.mlp.linear_2.weight"]))
        b.param(f"{dst}/mlp_proj/bias", _np(sd[f"{src}.mlp.linear_2.bias"]))
        i += 1
    return b.params


def convert_torchvision_resnet(sd: Mapping[str, Any], prefix: str = ""
                               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """torchvision ResNet state dict -> the ``ResNetEncoder`` tree (stem
    ``Conv_0``/``BatchNorm_0``, then ``_TVBasicBlock_{j}`` or
    ``_TVBottleneck_{j}`` numbered across the four stages)."""
    b = _TreeBuilder()
    p = (prefix + ".") if prefix else ""
    b.param("Conv_0/kernel", conv_kernel(sd[f"{p}conv1.weight"]))
    b.bn("BatchNorm_0", sd, f"{p}bn1")
    is_bottleneck = f"{p}layer1.0.conv3.weight" in sd
    block = "_TVBottleneck" if is_bottleneck else "_TVBasicBlock"
    n_convs = 3 if is_bottleneck else 2
    j = 0
    for li in (1, 2, 3, 4):
        bi = 0
        while f"{p}layer{li}.{bi}.conv1.weight" in sd:
            src, dst = f"{p}layer{li}.{bi}", f"{block}_{j}"
            for ci in range(n_convs):
                b.param(f"{dst}/Conv_{ci}/kernel", conv_kernel(sd[f"{src}.conv{ci + 1}.weight"]))
                b.bn(f"{dst}/BatchNorm_{ci}", sd, f"{src}.bn{ci + 1}")
            if f"{src}.downsample.0.weight" in sd:
                b.param(f"{dst}/Conv_{n_convs}/kernel",
                        conv_kernel(sd[f"{src}.downsample.0.weight"]))
                b.bn(f"{dst}/BatchNorm_{n_convs}", sd, f"{src}.downsample.1")
            j += 1
            bi += 1
    return b.out()


# MobileNetV2's stage repeats; torchvision numbers the 17 inverted-residual
# blocks features.1..17 (features.18, the 1280-wide conv, is not read: the
# backbone taps the 320-channel stage)
_MOBILENET_REPEATS = (1, 2, 3, 4, 3, 3, 1)


def convert_torchvision_mobilenet_v2(sd: Mapping[str, Any]
                                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    b = _TreeBuilder()
    b.param("stem/kernel", conv_kernel(sd["features.0.0.weight"]))
    b.bn("stem_bn", sd, "features.0.1")
    f = 1
    for si, n in enumerate(_MOBILENET_REPEATS):
        for bi in range(n):
            src, dst = f"features.{f}.conv", f"stage{si}_{bi}"
            if f"{src}.2.weight" in sd and sd[f"{src}.2.weight"].ndim == 4:
                # expand -> depthwise -> project (expand_ratio > 1)
                b.param(f"{dst}/expand/kernel", conv_kernel(sd[f"{src}.0.0.weight"]))
                b.bn(f"{dst}/expand_bn", sd, f"{src}.0.1")
                b.param(f"{dst}/dw/kernel", conv_kernel(sd[f"{src}.1.0.weight"]))
                b.bn(f"{dst}/dw_bn", sd, f"{src}.1.1")
                b.param(f"{dst}/project/kernel", conv_kernel(sd[f"{src}.2.weight"]))
                b.bn(f"{dst}/project_bn", sd, f"{src}.3")
            else:  # expand_ratio == 1 (the first block): depthwise -> project
                b.param(f"{dst}/dw/kernel", conv_kernel(sd[f"{src}.0.0.weight"]))
                b.bn(f"{dst}/dw_bn", sd, f"{src}.0.1")
                b.param(f"{dst}/project/kernel", conv_kernel(sd[f"{src}.1.weight"]))
                b.bn(f"{dst}/project_bn", sd, f"{src}.2")
            f += 1
    return b.out()


def convert_torchvision_densenet(sd: Mapping[str, Any]
                                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """torchvision ``densenet121/161/169/201`` -> the ``DenseNetBackbone`` tree."""
    b = _TreeBuilder()
    b.param("stem/kernel", conv_kernel(sd["features.conv0.weight"]))
    b.bn("stem_bn", sd, "features.norm0")
    bi = 1
    while f"features.denseblock{bi}.denselayer1.norm1.weight" in sd:
        li = 1
        while f"features.denseblock{bi}.denselayer{li}.norm1.weight" in sd:
            src, dst = f"features.denseblock{bi}.denselayer{li}", f"block{bi}_layer{li}"
            b.bn(f"{dst}/bn1", sd, f"{src}.norm1")
            b.param(f"{dst}/conv1/kernel", conv_kernel(sd[f"{src}.conv1.weight"]))
            b.bn(f"{dst}/bn2", sd, f"{src}.norm2")
            b.param(f"{dst}/conv2/kernel", conv_kernel(sd[f"{src}.conv2.weight"]))
            li += 1
        if f"features.transition{bi}.norm.weight" in sd:
            b.bn(f"trans{bi}_bn", sd, f"features.transition{bi}.norm")
            b.param(f"trans{bi}_conv/kernel",
                    conv_kernel(sd[f"features.transition{bi}.conv.weight"]))
        bi += 1
    b.bn("final_bn", sd, "features.norm5")
    return b.out()


def convert_resnet_stage(sd: Mapping[str, Any], prefix: str
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The reference's ``make_resnet_layers`` Sequential -> the
    ``ResNetStage`` tree: Sequential indices skip the parameter-less
    Upsample entries, the per-kind block counter does not."""
    b = _TreeBuilder()
    idxs = sorted(
        int(m.group(1)) for k in sd
        if (m := re.fullmatch(rf"{re.escape(prefix)}\.(\d+)\.conv1\.weight", k))
    )
    for j, i in enumerate(idxs):
        src = f"{prefix}.{i}"
        is_bottleneck = f"{src}.conv3.weight" in sd
        dst = ("BottleneckBlock" if is_bottleneck else "BasicBlock") + f"_{j}"
        n_convs = 3 if is_bottleneck else 2
        for ci in range(n_convs):
            b.param(f"{dst}/ConvBNAct_{ci}/Conv_0/kernel",
                    conv_kernel(sd[f"{src}.conv{ci + 1}.weight"]))
            b.bn(f"{dst}/ConvBNAct_{ci}/BatchNorm_0", sd, f"{src}.bn{ci + 1}")
        if f"{src}.downsample.0.weight" in sd:
            b.param(f"{dst}/ConvBNAct_{n_convs}/Conv_0/kernel",
                    conv_kernel(sd[f"{src}.downsample.0.weight"]))
            b.bn(f"{dst}/ConvBNAct_{n_convs}/BatchNorm_0", sd, f"{src}.downsample.1")
    return b.out()


def convert_reference_clip_ebc(sd: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A trained reference ``CLIP_EBC`` state dict (``image_encoder.*``,
    ``vpt_{i}``, ``image_decoder.*``, ``projection.*``, ``text_encoder.*``,
    ``logit_scale``) -> the ``ClipEBC`` tree."""
    vis = {"visual." + k[len("image_encoder."):]: v for k, v in sd.items()
           if k.startswith("image_encoder.")}
    is_vit = "visual.class_embedding" in vis
    img_p, img_s = (convert_clip_vit if is_vit else convert_clip_resnet)(vis)
    vpt_idxs = sorted(int(m.group(1)) for k in sd if (m := re.fullmatch(r"vpt_(\d+)", k)))
    if vpt_idxs:
        if vpt_idxs != list(range(len(vpt_idxs))):
            raise ValueError(f"non-contiguous VPT layers in checkpoint: {vpt_idxs}")
        img_p["vpt"] = np.stack([_np(sd[f"vpt_{i}"]) for i in vpt_idxs])
    txt = {k[len("text_encoder."):]: v for k, v in sd.items() if k.startswith("text_encoder.")}
    params, stats = _towers((img_p, img_s), convert_clip_text(txt))
    dec_p, dec_s = convert_resnet_stage(sd, "image_decoder")
    if dec_p:
        params["image_decoder"] = dec_p
    if dec_s:
        stats["image_decoder"] = dec_s
    if "projection.weight" in sd:
        params["projection"] = {"kernel": conv_kernel(sd["projection.weight"]),
                                "bias": _np(sd["projection.bias"])}
    if "logit_scale" in sd:
        params["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    return params, stats


def convert_reference_classifier(sd: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A trained reference ``Classifier``/``Regressor`` over a VGG(-AE)
    backbone -> its tree (``backbone/features``, ``backbone/reg{j}``, the
    head)."""
    if not any(k.startswith("backbone.features.") for k in sd):
        raise ValueError(
            "unsupported reference backbone: only VGG features.* checkpoints "
            f"are convertible (got keys like {sorted(sd)[:3]})"
        )
    use_bn = any(re.fullmatch(r"backbone\.features\.\d+\.running_mean", k) for k in sd)
    f_p, f_s = convert_vgg_features(sd, use_bn, prefix="backbone.features")
    bb_params: Dict[str, Any] = {"features": f_p}
    regs = sorted(int(m.group(1)) for k in sd
                  if (m := re.fullmatch(r"backbone\.reg_layer\.(\d+)\.weight", k)))
    for j, i in enumerate(regs):  # reg_layer Sequential: convs at 0 and 2 -> reg0, reg1
        bb_params[f"reg{j}"] = {"Conv_0": {"kernel": conv_kernel(sd[f"backbone.reg_layer.{i}.weight"]),
                                           "bias": _np(sd[f"backbone.reg_layer.{i}.bias"])}}
    params: Dict[str, Any] = {"backbone": bb_params}
    stats: Dict[str, Any] = {"backbone": {"features": f_s}} if f_s else {}
    if "classifier.weight" in sd:  # one 1x1 conv head
        params["cls_out"] = {"kernel": conv_kernel(sd["classifier.weight"]),
                             "bias": _np(sd["classifier.bias"])}
    elif "classifier.0.weight" in sd:  # the 512-wide bottleneck head
        params["cls_hidden"] = {"kernel": conv_kernel(sd["classifier.0.weight"]),
                                "bias": _np(sd["classifier.0.bias"])}
        params["cls_out"] = {"kernel": conv_kernel(sd["classifier.2.weight"]),
                             "bias": _np(sd["classifier.2.bias"])}
    elif "regressor.0.weight" in sd:
        params["Conv_0"] = {"kernel": conv_kernel(sd["regressor.0.weight"]),
                            "bias": _np(sd["regressor.0.bias"])}
    return params, stats


def detect_checkpoint_kind(sd: Mapping[str, Any]) -> str:
    """Classify a torch state dict into one of the convertible families."""
    keys = set(sd)
    if any(k.startswith("visual.") for k in keys):
        return "clip"
    if (any(k.startswith("image_encoder.") for k in keys)
            and any(k.startswith("text_encoder.") for k in keys)):
        return "reference_clip_ebc"
    if any(k.startswith("backbone.") for k in keys):
        return "reference_classifier"
    if "conv_proj.weight" in keys:
        return "torchvision_vit"
    if "conv1.weight" in keys and "layer1.0.conv1.weight" in keys:
        return "torchvision_resnet"
    if "features.0.0.weight" in keys and "features.1.conv.0.0.weight" in keys:
        return "torchvision_mobilenet_v2"
    if "features.denseblock1.denselayer1.norm1.weight" in keys:
        return "torchvision_densenet"
    if any(re.fullmatch(r"features\.\d+\.weight", k) for k in keys):
        return "torchvision_vgg"
    raise ValueError(
        "unrecognized checkpoint family; expected an OpenAI CLIP, "
        "torchvision VGG/ViT/ResNet, or reference CLIP-EBC/Classifier "
        f"state dict (sample keys: {sorted(keys)[:5]})"
    )


def detect_clip_arch(sd: Mapping[str, Any]) -> str:
    """The CLIP backbone name of a full checkpoint's state dict (the
    reference's ``build_model`` sniffing)."""
    if "visual.conv1.weight" in sd and "visual.class_embedding" in sd:
        w = sd["visual.conv1.weight"]
        patch, width = int(w.shape[-1]), int(w.shape[0])
        n_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
        if width == 1024 and patch == 14:
            grid = int(round((int(sd["visual.positional_embedding"].shape[0]) - 1) ** 0.5))
            return "vit_l_14_336px" if grid * 14 == 336 else "vit_l_14"
        if width == 768 and n_layers == 12:
            return f"vit_b_{patch}"
        raise ValueError(f"unrecognized CLIP ViT (width={width}, patch={patch})")
    if "visual.layer1.0.conv1.weight" in sd:
        from .clip.image_encoder import RESNET_CONFIGS

        stem = int(sd["visual.conv1.weight"].shape[0])  # width // 2
        counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{i}.")})
                       for i in (1, 2, 3, 4))
        for name, (layers, width, _, _) in RESNET_CONFIGS.items():
            if counts == layers and stem == width // 2:
                return name
        raise ValueError(f"unrecognized CLIP ResNet (layers={counts}, stem={stem})")
    raise ValueError("state dict does not look like a CLIP checkpoint")


def save_prepared_tree(path: str, params: Mapping[str, Any],
                       stats: Mapping[str, Any] | None = None,
                       meta: Mapping[str, str] | None = None) -> None:
    """Write converted trees as one ``.npz``: keys are '/'-joined paths
    under ``params/`` and ``stats/``, and ``meta`` strings (the backbone
    name) under ``meta/``, the JAX package's keys; the inverse is
    :func:`load_prepared_tree` (of either package). Stored, not deflated
    as the JAX package's are: deflating the hundreds of MB of a CLIP
    tower's fp16-valued weights takes minutes on one core and barely
    shrinks them; ``np.load`` reads both."""
    flat = _flatten_tree(params, "params")
    if stats:
        flat.update(_flatten_tree(stats, "stats"))
    for k, v in (meta or {}).items():
        flat[f"meta/{k}"] = str(v)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def merge_params(model_sd: Mapping[str, torch.Tensor], overlay: Mapping[str, torch.Tensor]
                 ) -> None:
    """Check an overlay against a model's state dict: every overlay tensor
    must name a tensor of the model of the same shape (the JAX
    ``merge_params``'s checks, on the port's names)."""
    for k, v in overlay.items():
        if k not in model_sd:
            raise KeyError(f"converted param {k!r} does not exist in the model")
        if tuple(model_sd[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k!r}: model {tuple(model_sd[k].shape)} "
                             f"vs checkpoint {tuple(v.shape)}")
