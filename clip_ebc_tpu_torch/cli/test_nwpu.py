"""NWPU-Crowd test-set submission: counterpart of
``clip_ebc_tpu/cli/test_nwpu.py`` with the same flags and defaults, plus
``--device``.

    python -m clip_ebc_tpu_torch.cli.test_nwpu --weight_path CKPT/best/12.pt \\
        --data_root data --amp

Predicts the counts of the 1500 unlabeled test images
(``{data_root}/nwpu/test/images``), by default on the whole image (on the
card a full image's trunk runs through the tiled flash kernel), with
``--sliding_window`` by windows (stride defaults to window // 2), and
writes ``{result_dir}/{parent}_{tag}.txt``: one ``{image id} {count}``
line per image, no trailing newline (the crowdbenchmark.com format).
``--weight_path`` is a trainer checkpoint directory (its ``latest.pt``), a
weights file (a ``best/{epoch}.pt`` state dict) or a JAX prepared-tree
``.npz``; ``tag`` is its base name without the ``.pt`` / ``.npz``
extension, ``parent`` its directory's name, so ``CKPT/best/12.pt`` writes
``best_12.txt`` as the JAX CLI does for ``CKPT/best/12``. ``--pretrained``
overlays a converted checkpoint first (``models/pretrained.py``: an
OpenAI CLIP ``.pt``, a prepared ``.npz``, a reference or torchvision
state dict; ``--allow_byte_tokenizer`` for a CLIP text tower without the
BPE vocab), and ``--weight_path``, if given, then replaces every weight;
without ``--weight_path`` the file is named after the ``--pretrained``
path with its extension kept, as the JAX CLI names it
(``{parent}_ViT-B-16.pt.txt``). ``--quant int8``
and ``--quant int8_static`` (calibrated on the first ``--calib_images``
test images) run the trunk and the decoder W8A8; ``--quant_attn
[kernel|xla]`` with ``--quant int8_static`` runs the attention in int8 too
(see ``cli/predict.py``). Runs on ``cuda`` unless ``--device cpu`` is
given.

Every model the trainer CLI builds is accepted (``--model vgg19_ae``,
``--regression`` for a Regressor); ``--quant`` is for ``clip_*`` models
only, as in the JAX CLI.

``--sliding_window --packed_eval`` packs the windows of consecutive test
images into forward batches of ``--batch_windows`` (128;
``ops/packed_eval.py``); the submission file is the same.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate NWPU test predictions.")
    p.add_argument("--model", type=str, default="clip_vit_b_16")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--reduction", type=int, default=8, choices=[8, 16, 32])
    p.add_argument("--regression", action="store_true")
    p.add_argument("--truncation", type=int, default=4)
    p.add_argument("--anchor_points", type=str, default="average", choices=["average", "middle"])
    p.add_argument("--prompt_type", type=str, default="word", choices=["word", "number"])
    p.add_argument("--granularity", type=str, default="fine", choices=["fine", "dynamic", "coarse"])
    p.add_argument("--num_vpt", type=int, default=32)
    p.add_argument("--vpt_drop", type=float, default=0.0)
    p.add_argument("--shallow_vpt", action="store_true")
    p.add_argument("--weight_path", type=str, default=None,
                   help="trainer checkpoint dir (latest.pt), weights .pt (best/*) or JAX "
                   "prepared-tree .npz")
    p.add_argument("--pretrained", type=str, default=None,
                   help="torch checkpoint or prepared .npz overlaid before --weight_path "
                   "(models/pretrained.py)")
    p.add_argument("--allow_byte_tokenizer", action="store_true",
                   help="permit pretrained CLIP text towers without the real BPE vocab "
                   "(synthetic-weight testing only)")
    p.add_argument("--sliding_window", action="store_true")
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--stride", type=int, default=None, help="defaults to window_size//2")
    p.add_argument("--strategy", type=str, default="average", choices=["average", "max"])
    p.add_argument("--resize_to_multiple", action="store_true")
    p.add_argument("--zero_pad_to_multiple", action="store_true")
    p.add_argument("--pad_to_multiple", type=int, default=0,
                   help="zero-pad images up to this multiple; 0 disables")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--result_dir", type=str, default="nwpu_test_results")
    p.add_argument("--amp", action="store_true", help="bf16 compute (fp32 parameters)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8", "int8_static"])
    p.add_argument("--calib_images", type=int, default=2,
                   help="with --quant int8_static: test images to calibrate the scales on")
    p.add_argument("--quant_attn", nargs="?", const="kernel", default=None,
                   choices=["kernel", "xla"],
                   help="with --quant int8_static: int8 QK^T and PV, in the attention "
                   "kernel (bare or 'kernel') or as plain integer products ('xla')")
    p.add_argument("--packed_eval", action="store_true",
                   help="with --sliding_window: pack windows across images into "
                   "fixed-size forward batches (ops/packed_eval.py)")
    p.add_argument("--batch_windows", type=int, default=128,
                   help="forward batch size for --packed_eval")
    p.add_argument("--limit", type=int, default=None,
                   help="process only the first N images (smoke tests)")
    p.add_argument("--disable_size_check", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def result_path(result_dir: str, weight_path, pretrained=None) -> str:
    """``{result_dir}/{parent}_{tag}.txt`` of the JAX CLI, named after
    ``weight_path`` with its ``.pt`` / ``.npz`` extension dropped from the
    tag, or, without one, after ``pretrained`` as it is (the JAX CLI's
    name for either)."""
    src = os.path.normpath(weight_path if weight_path is not None else pretrained)
    tag = os.path.basename(src)
    root, ext = os.path.splitext(tag)
    if weight_path is not None and ext in (".pt", ".npz"):
        tag = root
    parent = os.path.basename(os.path.dirname(src))
    return os.path.join(result_dir, f"{parent}_{tag}.txt".lstrip("_"))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.sliding_window:
        args.window_size = args.input_size if args.window_size is None else args.window_size
        args.stride = args.window_size // 2 if args.stride is None else args.stride
    if args.quant_attn and args.quant != "int8_static":
        raise SystemExit("--quant_attn requires --quant int8_static")
    if args.packed_eval and not args.sliding_window:
        raise SystemExit("--packed_eval requires --sliding_window")

    import torch

    from ..config import get_bins_and_anchors
    from ..data.crowd import NWPUTestDataset
    from ..data.transforms import Resize2Multiple, ZeroPad2Multiple
    from ..models import get_model
    from ..training.evaluate import Evaluator
    from ..utils.platform import resolve_device
    from ._common import (QUANT_ATTN, calibrate_static_int8, check_pretrained_path,
                          check_quant_support, load_weights)

    check_quant_support(args.quant, args.model)
    if args.pretrained is None and args.weight_path is None:
        raise SystemExit("one of --weight_path / --pretrained is required")
    check_pretrained_path(args)
    device = resolve_device(args.device)
    bins = anchors = None
    if not args.regression:
        bins, anchors = get_bins_and_anchors(
            args.reduction, args.truncation, "nwpu", args.granularity, args.anchor_points
        )
    model_kw = dict(
        dtype=torch.bfloat16 if args.amp else torch.float32,
        prompt_type=args.prompt_type, num_vpt=args.num_vpt, deep_vpt=not args.shallow_vpt,
        vpt_drop=args.vpt_drop, quant_int8=args.quant.startswith("int8"), device=device,
        quant_attn=QUANT_ATTN[args.quant_attn],
    )
    model = get_model(
        args.model, args.input_size, args.reduction, bins, anchors,
        quant_mode="static" if args.quant == "int8_static" else "dynamic", **model_kw,
    )
    load_weights(args, model)

    if args.quant == "int8_static":
        calib = NWPUTestDataset(args.data_root, check_sizes=not args.disable_size_check)
        calibrate_static_int8(
            args, model_kw, bins, anchors, model,
            (calib[i][0] for i in range(min(args.calib_images, len(calib)))),
        )

    transforms = None
    if args.sliding_window and args.resize_to_multiple:
        transforms = Resize2Multiple(args.window_size, args.stride)
    elif args.sliding_window and args.zero_pad_to_multiple:
        transforms = ZeroPad2Multiple(args.window_size, args.stride)
    dataset = NWPUTestDataset(
        args.data_root, transforms=transforms, check_sizes=not args.disable_size_check,
    )
    evaluator = Evaluator(
        model, reduction=args.reduction, sliding_window=args.sliding_window,
        window_size=args.window_size, stride=args.stride, strategy=args.strategy,
        pad_to_multiple=args.pad_to_multiple,
    )

    n = len(dataset) if args.limit is None else min(args.limit, len(dataset))
    names = []

    def images():
        for i in range(n):
            image, name = dataset[i]
            names.append(name)
            yield image

    if args.packed_eval:
        densities = evaluator.predict_densities_packed(images(), batch_windows=args.batch_windows)
    else:
        densities = map(evaluator.predict_density, images())
    lines = []
    for i, density in enumerate(densities):
        lines.append(f"{os.path.splitext(names[i])[0]} {float(density.sum())}")
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{n}")

    os.makedirs(args.result_dir, exist_ok=True)
    out_path = result_path(args.result_dir, args.weight_path, args.pretrained)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))  # no trailing newline
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
