"""Pretrained weights for the entry points: counterpart of
``clip_ebc_tpu/models/pretrained.py``.

:func:`apply_pretrained` takes a local torch checkpoint (or a prepared
``.npz`` from ``cli/prepare.py``), sniffs its family, converts it into
the JAX tree layout with ``models.convert`` (one conversion per family,
the one ``cli/prepare.py`` writes), places it at the model's subtree,
carries it into the port's names with the JAX-to-port bridge and
overlays it onto the model in place:

- OpenAI CLIP (``visual.*``)          -> ClipEBC towers (+ logit_scale)
- reference trained CLIP_EBC          -> the whole ClipEBC (VPT, decoder)
- reference trained Classifier/Regr.  -> the whole Classifier/Regressor
- torchvision VGG  (``features.*``)   -> backbone.features (trailing convs dropped)
- torchvision ViT  (``conv_proj.*``)  -> backbone (pos-embed resized)
- torchvision ResNet (``layerN.*``)   -> backbone.encoder
- torchvision MobileNetV2 / DenseNet  -> backbone

Everything the checkpoint does not cover (decoder, projection, heads,
VPT prompts) keeps the model's fresh initialization. The overlay copies
into the model's tensors in place, so what caches on a tensor's
``data_ptr``/``_version`` (the Evaluator's text features, the int8
layers' quantized weights) is remade after it.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from . import convert as C

logger = logging.getLogger("clip_ebc_tpu_torch")

Trees = Tuple[Dict[str, Any], Dict[str, Any]]


def _as_state_dict(src: Union[str, Mapping[str, Any]]) -> Dict[str, Any]:
    if isinstance(src, str):
        return C.load_torch_state_dict(src)
    return dict(src)


def _trim_to(dst_keys, src: Dict[str, Any], what: str) -> Dict[str, Any]:
    """Drop the top-level entries of ``src`` the model lacks (a truncated
    front such as CSRNet's 10-conv VGG16); every one of ``dst_keys`` must
    be covered."""
    missing = [k for k in dst_keys if k not in src]
    if missing:
        raise ValueError(f"{what}: checkpoint lacks {missing[:4]} for the model")
    dropped = [k for k in src if k not in dst_keys]
    if dropped:
        logger.info("%s: dropping %d trailing checkpoint entries (%s...)",
                    what, len(dropped), dropped[0])
    return {k: v for k, v in src.items() if k in dst_keys}


def _interp_vit_pos_embed(params: Dict[str, Any], dst_rows: int) -> None:
    """Resize a torchvision ViT's ``pos_embedding`` bicubically (torch's
    a = -0.75 kernel) to the model's grid when the sizes differ."""
    from .transformer import interpolate_pos_embed

    src_rows = params["pos_embedding"].shape[0]
    if src_rows == dst_rows:
        return
    g_src, g_dst = int(round((src_rows - 1) ** 0.5)), int(round((dst_rows - 1) ** 0.5))
    if g_src * g_src + 1 != src_rows or g_dst * g_dst + 1 != dst_rows:
        raise ValueError(f"cannot interpolate pos embedding {src_rows} -> {dst_rows}")
    resized = interpolate_pos_embed(torch.from_numpy(params["pos_embedding"]),
                                    (g_src, g_src), (g_dst, g_dst))
    params["pos_embedding"] = resized.numpy().astype(np.float32)


def _backbone(model) -> torch.nn.Module:
    bb = getattr(model, "backbone", None)
    return bb if isinstance(bb, torch.nn.Module) else None


def convert_for_model(model, sd: Mapping[str, Any]) -> Trees:
    """Convert ``sd`` and place it at ``model``'s subtree: ``(params,
    stats)`` overlays in the JAX tree layout."""
    from .clip.model import ClipEBC

    kind = C.detect_checkpoint_kind(sd)
    if kind == "clip":
        if not isinstance(model, ClipEBC):
            raise ValueError("a CLIP checkpoint requires a clip_* model")
        arch = C.detect_clip_arch(sd)
        if arch != model.backbone:
            raise ValueError(f"checkpoint is CLIP {arch!r} but the model was built with "
                             f"backbone {model.backbone!r}")
        return C.convert_clip_ebc(sd, is_vit=model.is_vit)
    if kind == "reference_clip_ebc":
        if not isinstance(model, ClipEBC):
            raise ValueError("a reference CLIP_EBC checkpoint requires a clip_* model")
        return C.convert_reference_clip_ebc(sd)
    if kind == "reference_classifier":
        return C.convert_reference_classifier(sd)

    # torchvision backbone checkpoints land under the model's backbone
    bb = _backbone(model)
    if bb is None:
        raise ValueError(f"a {kind} checkpoint initializes a backbone, but this model has "
                         "no 'backbone' subtree")
    if kind == "torchvision_vgg":
        if not isinstance(getattr(bb, "features", None), torch.nn.Module):
            raise ValueError("model backbone has no 'features' stage for VGG weights")
        use_bn = any(re.fullmatch(r"features\.\d+\.running_mean", k) for k in sd)
        f_p, f_s = C.convert_vgg_features(sd, use_bn)
        convs = {v.split("/")[1] for v in C._vgg_names(bb.features, "features", "features").values()}
        stats = {"backbone": {"features": _trim_to(convs, f_s, "vgg bn stats")}} if f_s else {}
        return {"backbone": {"features": _trim_to(convs, f_p, "vgg features")}}, stats
    if kind == "torchvision_resnet":
        r_p, r_s = C.convert_torchvision_resnet(sd)
        if "encoder" in dict(bb.named_children()):  # ResNetEncoder under every ResNet backbone
            return {"backbone": {"encoder": r_p}}, {"backbone": {"encoder": r_s}}
        return {"backbone": r_p}, {"backbone": r_s}
    if kind == "torchvision_vit":
        v_p = C.convert_torchvision_vit(sd)
        if isinstance(getattr(bb, "pos_embedding", None), torch.Tensor):
            _interp_vit_pos_embed(v_p, bb.pos_embedding.shape[0])
        return {"backbone": v_p}, {}
    if kind == "torchvision_mobilenet_v2":
        m_p, m_s = C.convert_torchvision_mobilenet_v2(sd)
        return {"backbone": m_p}, {"backbone": m_s}
    if kind == "torchvision_densenet":
        d_p, d_s = C.convert_torchvision_densenet(sd)
        return {"backbone": d_p}, {"backbone": d_s}
    raise AssertionError(kind)


def _leaves(tree: Mapping[str, Any]):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def overlay_state(model, params: Mapping[str, Any], stats: Mapping[str, Any]
                  ) -> Dict[str, torch.Tensor]:
    """JAX-layout overlays -> the port tensors they cover, checked to name
    tensors of ``model`` of the same shape. Every converted number must
    land in the model: a leaf the bridge found no module for raises, as
    the JAX ``merge_params`` does. BatchNorm's ``num_batches_tracked`` is
    not a checkpoint's: the model keeps its own."""
    from .clip.model import ClipEBC

    if isinstance(model, ClipEBC):
        sd = C.from_jax_params(params, stats, model.decoder_cfg)
    else:
        sd = C.head_state_from_jax(model, params, stats)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    n_tree = sum(np.size(x) for x in _leaves(params)) + sum(np.size(x) for x in _leaves(stats))
    n_placed = sum(v.numel() for v in sd.values())
    if n_tree != n_placed:
        raise KeyError(f"{n_tree - n_placed} converted numbers have no place in the model "
                       f"(checkpoint subtrees {sorted(params)})")
    C.merge_params(model.state_dict(), sd)
    return sd


def apply_pretrained(model, checkpoint: Union[str, Mapping[str, Any]],
                     allow_byte_tokenizer: bool = False) -> str:
    """Overlay a torch checkpoint (a path or a state dict) or a prepared
    ``.npz`` onto ``model`` in place; returns the checkpoint's family.
    Shapes are checked strictly.

    Loading a pretrained CLIP text tower without the real BPE vocab is a
    hard error: byte-fallback token ids mean nothing to pretrained text
    embeddings, so every prompt feature, and every count, would be
    garbage. ``allow_byte_tokenizer=True`` (CLI: ``--allow_byte_tokenizer``)
    is for synthetic-weight tests only.

    A ``.npz`` path is a prepared artifact of ``cli/prepare.py``: the full
    ``clip_{name}.npz`` overlays a ClipEBC's towers exactly as the torch
    checkpoint it was prepared from; a tower-only artifact is refused."""
    from .clip.model import ClipEBC

    if isinstance(checkpoint, str) and checkpoint.endswith(".npz"):
        params, stats, meta = C.load_prepared_tree(checkpoint)
        if not ("image_encoder" in params and "text_encoder" in params):
            raise ValueError(
                f"{checkpoint} is a tower-only prepared artifact; pass the full "
                "clip_{name}.npz")
        if not isinstance(model, ClipEBC):
            raise ValueError("a prepared CLIP artifact requires a clip_* model")
        arch = meta.get("backbone")
        if arch and arch != model.backbone:
            raise ValueError(f"prepared artifact is CLIP {arch!r} but the model was built "
                             f"with backbone {model.backbone!r}")
        kind = "clip"
    else:
        sd = _as_state_dict(checkpoint)
        kind = C.detect_checkpoint_kind(sd)
        params, stats = convert_for_model(model, sd)
        del sd
    if kind in ("clip", "reference_clip_ebc"):
        from .clip.tokenizer import ByteFallbackTokenizer, get_tokenizer

        if isinstance(get_tokenizer(), ByteFallbackTokenizer):
            msg = ("Loading converted CLIP text-tower weights while the BPE vocab is "
                   "ABSENT: prompts are byte-fallback tokenized, which is incompatible "
                   "with pretrained text embeddings — text features would be garbage. "
                   "Set $CLIP_BPE_VOCAB to bpe_simple_vocab_16e6.txt.gz (ships with "
                   "OpenAI CLIP).")
            if not allow_byte_tokenizer:
                raise ValueError(msg + " Pass --allow_byte_tokenizer to override "
                                 "(synthetic-weight testing only).")
            logger.warning(msg)
    sd = overlay_state(model, params, stats)
    model.load_state_dict(sd, strict=False)
    logger.info("loaded pretrained %s checkpoint: %d tensors, %d numbers overlaid",
                kind, len(sd), sum(v.numel() for v in sd.values()))
    return kind
