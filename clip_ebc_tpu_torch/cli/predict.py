"""Inference entry point: a directory (or list) of images -> per-image crowd
counts, optionally density maps. Counterpart of ``clip_ebc_tpu/cli/predict.py``
with the same flags and defaults, plus ``--device`` and ``--seed``.

    python -m clip_ebc_tpu_torch.cli.predict IMAGES --sliding_window \\
        --window_size 224 --stride 224 --amp --weight_path W.npz --out counts.csv

Without ``--sliding_window`` each image runs whole, as one sequence: on
the card the trunk's attention of a full image (L >= 1024 tokens; 24,609
on a 2048 x 3072 image) is the tiled flash kernel
(``ops/flash_attention.py``), and the windows' attention the fused kernel.
``--weight_path`` takes a port ``.pt`` state dict, a trainer checkpoint
directory or a JAX prepared-tree ``.npz``; ``--pretrained`` overlays a
converted checkpoint before it (``models/pretrained.py``: an OpenAI CLIP
``.pt``, a prepared ``clip_{name}.npz`` from ``cli/prepare.py``, a
reference or torchvision state dict; ``--allow_byte_tokenizer`` lets a
CLIP text tower load without the BPE vocab, for synthetic weights only).
With neither, the weights are random from ``--seed``. Runs on
``cuda`` unless ``--device cpu`` is given. ``--quant int8`` runs the trunk
and the decoder W8A8 with dynamic activation scales; ``--quant
int8_static`` first calibrates static scales on the first
``--calib_images`` images:

    python -m clip_ebc_tpu_torch.cli.predict IMAGES --sliding_window --amp \
        --quant int8_static --calib_images 2 [--quant_attn [kernel|xla]]

``--quant_attn`` (with ``--quant int8_static`` only) runs QK^T and PV in
int8 too, on the calibrated q, k and v scales: bare or ``kernel`` inside
the int8 attention kernel of each window block, ``xla`` as plain integer
products (``ops/int8_attention.py``) after the unfused int8 projection.

Every model the trainer CLI builds serves here too, e.g. the trainer's
default ``vgg19_ae`` whole, and ``--regression`` for a Regressor:

    python -m clip_ebc_tpu_torch.cli.predict IMAGES --model vgg19_ae --amp \
        --weight_path CKPT/best/1.pt

``--quant`` is for ``clip_*`` models only, as in the JAX CLI.

``--packed_eval`` (with ``--sliding_window``) packs the windows of
consecutive images into forward batches of ``--batch_windows`` (128):
every forward has the same batch however small the images are
(``ops/packed_eval.py``); the counts and density files are the per-image
path's, written as each image's last batch has run:

    python -m clip_ebc_tpu_torch.cli.predict IMAGES --sliding_window --stride 224 \
        --packed_eval --batch_windows 128 --amp
"""

from __future__ import annotations

import argparse
import glob
import os
import re

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict crowd counts for images.")
    p.add_argument("images", type=str, help="image file, directory, or glob pattern")
    p.add_argument("--model", type=str, default="clip_vit_b_16")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--reduction", type=int, default=8, choices=[8, 16, 32])
    p.add_argument("--regression", action="store_true")
    p.add_argument("--truncation", type=int, default=4)
    p.add_argument("--anchor_points", type=str, default="average", choices=["average", "middle"])
    p.add_argument("--prompt_type", type=str, default="word", choices=["word", "number"])
    p.add_argument("--granularity", type=str, default="fine", choices=["fine", "dynamic", "coarse"])
    p.add_argument("--bins_dataset", type=str, default="qnrf",
                   help="dataset whose bin table to use (the bins were derived per dataset)")
    p.add_argument("--num_vpt", type=int, default=32)
    p.add_argument("--shallow_vpt", action="store_true")
    p.add_argument("--weight_path", type=str, default=None,
                   help="port .pt state dict or JAX prepared-tree .npz; "
                   "default: random weights from --seed")
    p.add_argument("--pretrained", type=str, default=None,
                   help="torch checkpoint or prepared .npz overlaid before --weight_path "
                   "(models/pretrained.py)")
    p.add_argument("--allow_byte_tokenizer", action="store_true",
                   help="permit pretrained CLIP text towers without the real BPE vocab "
                   "(synthetic-weight testing only)")
    p.add_argument("--sliding_window", action="store_true")
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--strategy", type=str, default="average", choices=["average", "max"])
    p.add_argument("--pad_to_multiple", type=int, default=None,
                   help="pad images up to a multiple of this (counts cover the "
                   "valid region only). Default: the ViT patch size; 0 disables")
    p.add_argument("--amp", action="store_true", help="bf16 compute (fp32 parameters)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8", "int8_static"])
    p.add_argument("--calib_images", type=int, default=2,
                   help="with --quant int8_static: images to calibrate the scales on")
    p.add_argument("--quant_attn", nargs="?", const="kernel", default=None,
                   choices=["kernel", "xla"],
                   help="with --quant int8_static: int8 QK^T and PV, in the attention "
                   "kernel (bare or 'kernel') or as plain integer products ('xla')")
    p.add_argument("--packed_eval", action="store_true",
                   help="with --sliding_window: pack windows across images into "
                   "fixed-size forward batches (ops/packed_eval.py)")
    p.add_argument("--batch_windows", type=int, default=128,
                   help="forward batch size for --packed_eval")
    p.add_argument("--out", type=str, default="predictions.csv")
    p.add_argument("--save_density", type=str, default=None,
                   help="directory for per-image density .npy files")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return p


def _list_images(spec: str):
    if os.path.isdir(spec):
        paths = [
            p for p in sorted(glob.glob(os.path.join(spec, "*")))
            if os.path.splitext(p)[1].lower() in IMG_EXTS
        ]
    elif os.path.isfile(spec):
        paths = [spec]
    else:
        paths = sorted(glob.glob(spec))
    if not paths:
        raise SystemExit(f"no images found for {spec!r}")
    return paths


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.quant_attn and args.quant != "int8_static":
        raise SystemExit("--quant_attn requires --quant int8_static")
    if args.packed_eval and not args.sliding_window:
        raise SystemExit("--packed_eval requires --sliding_window")
    if args.sliding_window:
        args.window_size = args.input_size if args.window_size is None else args.window_size
        args.stride = args.window_size // 2 if args.stride is None else args.stride
    if args.pad_to_multiple is None:
        m = re.search(r"vit_[a-z]+_(\d+)$", args.model)
        args.pad_to_multiple = int(m.group(1)) if m else args.reduction

    import numpy as np
    import torch

    from ..config import get_bins_and_anchors
    from ..data.crowd import _load_image, normalize_image
    from ..models import get_model
    from ..training.evaluate import Evaluator
    from ..utils.platform import resolve_device
    from ._common import (QUANT_ATTN, calibrate_static_int8, check_pretrained_path,
                          check_quant_support, load_weights)

    check_quant_support(args.quant, args.model)
    check_pretrained_path(args)
    device = resolve_device(args.device)
    paths = _list_images(args.images)
    bins = anchors = None
    if not args.regression:
        bins, anchors = get_bins_and_anchors(
            args.reduction, args.truncation, args.bins_dataset, args.granularity,
            args.anchor_points,
        )
    model_kw = dict(
        dtype=torch.bfloat16 if args.amp else torch.float32,
        prompt_type=args.prompt_type, num_vpt=args.num_vpt, deep_vpt=not args.shallow_vpt,
        quant_int8=args.quant.startswith("int8"), seed=args.seed, device=device,
        quant_attn=QUANT_ATTN[args.quant_attn],
    )
    model = get_model(
        args.model, args.input_size, args.reduction, bins, anchors,
        quant_mode="static" if args.quant == "int8_static" else "dynamic", **model_kw,
    )
    load_weights(args, model, required=False)
    if args.quant == "int8_static":  # the scales of the loaded weights
        calibrate_static_int8(
            args, model_kw, bins, anchors, model,
            (normalize_image(_load_image(p)) for p in paths[: args.calib_images]),
        )

    evaluator = Evaluator(
        model, reduction=args.reduction, sliding_window=args.sliding_window,
        window_size=args.window_size, stride=args.stride, strategy=args.strategy,
        pad_to_multiple=args.pad_to_multiple,
    )
    if args.save_density:
        os.makedirs(args.save_density, exist_ok=True)

    def densities():
        images = (normalize_image(_load_image(p)) for p in paths)
        if args.packed_eval:
            yield from evaluator.predict_densities_packed(images, batch_windows=args.batch_windows)
        else:
            yield from map(evaluator.predict_density, images)

    # incremental write: one bad image must not lose prior results
    n = 0
    with open(args.out, "w") as f:
        f.write("image,count\n")
        for i, (path, density) in enumerate(zip(paths, densities())):
            density = density.cpu().numpy()
            f.write(f"{os.path.basename(path)},{float(density.sum()):.2f}\n")
            f.flush()
            n += 1
            if args.save_density:
                name = os.path.splitext(os.path.basename(path))[0] + ".npy"
                np.save(os.path.join(args.save_density, name), density)
            if (i + 1) % 50 == 0:
                print(f"{i + 1}/{len(paths)}")
    print(f"wrote {args.out} ({n} images)")


if __name__ == "__main__":
    main()
