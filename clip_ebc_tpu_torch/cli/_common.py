"""Helpers shared by the inference entry points: counterpart of
``clip_ebc_tpu/cli/_common.py`` (``check_quant_support``, ``load_weights``,
``calibrate_static_int8``), kept in one place for every inference CLI.
"""

from __future__ import annotations

import os
from typing import Iterable

# --quant_attn -> the models' quant_attn (the JAX CLIs' mapping)
QUANT_ATTN = {"kernel": True, "xla": "xla", None: False}


def check_quant_support(quant: str, model_name: str) -> None:
    """``--quant`` only quantizes the CLIP trunk and decoder: reject it for
    any other model instead of letting it turn into a no-op."""
    name = model_name.lower()
    if quant != "none" and not name.startswith("clip_"):
        raise SystemExit(
            f"--quant {quant} is only supported for clip_* models "
            f"(got --model {model_name}); the CNN backbones have no "
            "quantized path"
        )


def check_pretrained_path(args) -> None:
    """A ``--pretrained`` file that does not exist fails before the model
    is built."""
    if args.pretrained is not None and not os.path.exists(args.pretrained):
        raise FileNotFoundError(f"--pretrained {args.pretrained}: no such file")


def load_weights(args, model, required: bool = True) -> None:
    """Resolve ``--pretrained`` / ``--weight_path`` into ``model``'s
    weights, in place. ``--pretrained`` overlays a converted checkpoint
    (``models.pretrained.apply_pretrained``) onto the fresh weights; then
    ``--weight_path``, a complete trained state, replaces every weight: a
    trainer checkpoint directory (its ``latest.pt``), a port ``.pt`` state
    dict or a JAX prepared-tree ``.npz``. With ``required``, one of the
    two must be given."""
    if required and args.pretrained is None and args.weight_path is None:
        raise SystemExit("one of --weight_path / --pretrained is required")
    if args.pretrained:
        from ..models.pretrained import apply_pretrained

        apply_pretrained(model, args.pretrained, allow_byte_tokenizer=args.allow_byte_tokenizer)
    if args.weight_path is not None:
        import torch

        from ..models.convert import load_weights as load_file

        path = args.weight_path
        if os.path.isdir(path):
            latest = os.path.join(path, "latest.pt")
            if not os.path.exists(latest):
                raise SystemExit(f"{path} is a directory without latest.pt")
            state = torch.load(latest, map_location="cpu", weights_only=True)
            model.load_state_dict(state["model"], strict=True)
        else:
            load_file(model, path)


def calibrate_static_int8(args, model_kw, bins, anchors, model, images: Iterable) -> None:
    """Fill the quant state of ``model`` (built with ``quant_mode="static"``):
    run a dynamic-quant twin (``model_kw``, its ``quant_attn`` included,
    as the JAX CLI builds it) with the same weights over window batches
    cut from ``images`` (arrays, already normalized): the first 16
    stride-``win`` windows of each, recording every quantized layer's
    activation max-abs (``ops.quant.calibrate_int8``), then load the
    recorded state into ``model``."""
    import numpy as np
    import torch

    from ..models import get_model
    from ..ops.quant import calibrate_int8, load_quant_state
    from ..ops.sliding_window import window_grid

    dyn = get_model(
        args.model, args.input_size, args.reduction, bins, anchors,
        quant_mode="dynamic", **model_kw,
    )
    dyn.load_state_dict(model.state_dict())
    device = next(dyn.parameters()).device
    win = getattr(args, "window_size", None) or args.input_size
    batches = []
    for image in images:
        image = np.asarray(image)
        h, w = image.shape[:2]
        if h < win or w < win:  # pad tiny images up to one window
            pad = np.zeros((max(h, win), max(w, win), 3), image.dtype)
            pad[:h, :w] = image
            image, (h, w) = pad, pad.shape[:2]
        coords = window_grid((h, w), (win, win), (win, win))[:16]
        batch = np.stack([image[y: y + win, x: x + win] for y, x in coords])
        batches.append(torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device))
    with torch.no_grad():
        text = dyn.encode_text()
    state = calibrate_int8(dyn, batches, forward=lambda b: dyn(b, text_feats=text))
    load_quant_state(model, state)
    print(f"calibrated int8 scales on {len(batches)} image(s)")
