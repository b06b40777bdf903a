"""Model factory: counterpart of ``clip_ebc_tpu/models/__init__.py``.

``get_model(name, ...)`` routes:
  - ``clip_*``          -> CLIP-EBC over any of the nine CLIP backbones
                           (``CLIP_BACKBONES``: the five ModifiedResNets
                           and the four ViTs)
  - bins/anchors given  -> ``Classifier(backbone)``
  - otherwise           -> ``Regressor(backbone)``

The backbones are the JAX factory's (``get_backbone``): VGG
``vgg{11,13,16,19}[_bn][_ae]``, ResNet ``resnet{18,34,50,101,152}[_ae]``,
``mobilenetv2``, ``densenet{121,161,169,201}``, ``csrnet[_bn]``,
``cannet[_bn]``, the plain ViTs ``vit_{b_16,b_32,l_16,l_32,h_14}`` and
whatever :func:`register_backbone` adds (``convnext_nano`` ships).

The port's backbone contract: a module taking an NCHW image (a
channels-last view in the compute dtype) and returning NCHW features at
stride ``reduction``, with attributes ``channels``, ``reduction`` and
``encoder_reduction``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from ..utils.platform import resolve_device
from .csrnet import CSRNet
from .densenet import _CONFIGS as _DENSENET_CONFIGS
from .densenet import DenseNetBackbone
from .heads import Classifier, Regressor, expectation_from_logits
from .mobilenet import MobileNetV2Backbone
from .resnet import PlainResNetBackbone, ResNetAutoEncoder, ResNetEncoder
from .vgg import VGGAutoEncoder, VGGEncoder, make_vgg
from .vit import _VIT_CONFIGS, ViTEncoder

CLIP_BACKBONES = (
    "resnet50",
    "resnet50x4",
    "resnet50x16",
    "resnet50x64",
    "resnet101",
    "vit_b_16",
    "vit_b_32",
    "vit_l_14",
    "vit_l_14_336px",
)

_VGG_NAMES = tuple(
    f"vgg{n}{bn}{ae}" for n in (11, 13, 16, 19) for bn in ("", "_bn") for ae in ("", "_ae")
)
_RESNET_AE_NAMES = tuple(f"resnet{n}_ae" for n in (18, 34, 50, 101, 152))
_RESNET_NAMES = tuple(f"resnet{n}" for n in (18, 34, 50, 101, 152))

# The options of the CLIP route, which a non-CLIP model takes and ignores,
# as the JAX factory does (the CLIs pass them for every model).
_CLIP_ONLY_KWARGS = ("prompt_type", "num_vpt", "deep_vpt", "vpt_drop", "fused_head",
                     "decoder_before_upsample", "quant_mode", "quant_attn")

# Custom backbone registry: any factory returning a module with the
# backbone contract above can be registered and used by name.
_BACKBONE_REGISTRY = {}


def register_backbone(name: str):
    """Decorator: register ``factory(input_size, reduction, dtype, axis_name)``."""

    def wrap(factory):
        _BACKBONE_REGISTRY[name.lower()] = factory
        return factory

    return wrap


def get_backbone(
    name: str,
    input_size: int,
    reduction: int,
    dtype: torch.dtype = torch.float32,
    axis_name: Optional[str] = None,
    attn_backend: str = "auto",
):
    """A backbone module by name (the JAX ``get_backbone``); ``input_size``
    sets the grid of a ViT's positional embedding, ``attn_backend`` a
    ViT's attention route, ``axis_name`` syncs every BatchNorm's training
    statistics over the ranks (``parallel.mesh.DATA_AXIS``)."""
    name = name.lower()
    if name in _VGG_NAMES:
        return make_vgg(name, reduction, axis_name)
    if name in _RESNET_AE_NAMES:
        return ResNetAutoEncoder(name[: -len("_ae")], reduction, axis_name)
    if name in _RESNET_NAMES:
        return PlainResNetBackbone(name, reduction, axis_name)
    if name in ("mobilenetv2", "mobilenet_v2"):
        return MobileNetV2Backbone(reduction, axis_name=axis_name)
    if name in _DENSENET_CONFIGS:
        return DenseNetBackbone(name, reduction, axis_name)
    if name in ("csrnet", "csrnet_bn", "cannet", "cannet_bn"):
        return CSRNet(use_bn=name.endswith("_bn"), reduction=reduction,
                      use_context=name.startswith("cannet"), axis_name=axis_name)
    if name in _VIT_CONFIGS:
        return ViTEncoder(name, image_size=input_size, reduction=reduction, dtype=dtype,
                          attn_backend=attn_backend)
    if name in _BACKBONE_REGISTRY:
        return _BACKBONE_REGISTRY[name](
            input_size=input_size, reduction=reduction, dtype=dtype, axis_name=axis_name
        )
    raise ValueError(f"unknown backbone {name!r}")


def get_model(
    backbone: str,
    input_size: int,
    reduction: int,
    bins: Optional[Sequence[Tuple[float, float]]] = None,
    anchor_points: Optional[Sequence[float]] = None,
    dtype: torch.dtype = torch.float32,
    axis_name: Optional[str] = None,
    seed: int = 0,
    device=None,
    attn_backend: str = "auto",
    quant_int8: bool = False,
    **kwargs: Any,
):
    """The JAX factory's signature, plus ``seed`` (the random weights) and
    ``device`` (default ``cuda``; raises without CUDA unless ``"cpu"``).
    The model is built in eval mode. For ``clip_*`` the other ``kwargs``
    go to :func:`build_clip_ebc` (``prompt_type``, ``num_vpt``,
    ``fused_head`` ...; ``input_size`` sets no weight shape of a CLIP ViT,
    whose positional embedding resizes to any window); a non-CLIP model
    ignores the CLIP route's options, every one of its parameters trains,
    and ``quant_int8`` (CLIP-only, as in the JAX CLIs) raises.
    ``axis_name`` (``parallel.mesh.DATA_AXIS``) takes every BatchNorm's
    training statistics over the global batch of all ranks; a model
    without batch statistics (a CLIP ViT's trunk, ConvNeXt) ignores it."""
    backbone = backbone.lower()
    if backbone.startswith("clip_"):
        name = backbone[len("clip_"):]
        if name not in CLIP_BACKBONES:
            raise ValueError(f"CLIP backbone must be one of {CLIP_BACKBONES}, got {name}")
        from .clip.model import build_clip_ebc

        return build_clip_ebc(
            backbone=name, bins=bins, anchor_points=anchor_points, reduction=reduction,
            dtype=dtype, seed=seed, device=device, attn_backend=attn_backend,
            quant_int8=quant_int8, axis_name=axis_name, **kwargs,
        )
    unknown = set(kwargs) - set(_CLIP_ONLY_KWARGS)
    if unknown:
        raise TypeError(f"get_model got unexpected keyword arguments {sorted(unknown)}")
    if quant_int8:
        raise ValueError(f"quant_int8 is only supported for clip_* models (got {backbone!r})")
    device = resolve_device(device)
    bb = get_backbone(backbone, input_size, reduction, dtype, axis_name, attn_backend)
    if bins is None and anchor_points is None:
        model = Regressor(bb, dtype)
    elif bins is None or anchor_points is None:
        raise ValueError("bins and anchor_points must both be given or both be None")
    else:
        model = Classifier(bb, bins, anchor_points, dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


__all__ = [
    "get_model",
    "get_backbone",
    "register_backbone",
    "Classifier",
    "Regressor",
    "expectation_from_logits",
    "VGGEncoder",
    "VGGAutoEncoder",
    "ResNetEncoder",
    "ResNetAutoEncoder",
    "PlainResNetBackbone",
    "MobileNetV2Backbone",
    "DenseNetBackbone",
    "CSRNet",
    "ViTEncoder",
    "CLIP_BACKBONES",
]

# The shipped registry example: a ConvNeXt-style backbone registered
# through the same hatch users get (models/convnext.py).
from .convnext import ConvNeXtBackbone  # noqa: E402
from .convnext import _register as _register_convnext  # noqa: E402

_register_convnext()
__all__.append("ConvNeXtBackbone")
