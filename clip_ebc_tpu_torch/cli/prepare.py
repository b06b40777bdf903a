"""CLIP weight preparation: counterpart of ``clip_ebc_tpu/cli/prepare.py``,
its local part.

Takes OpenAI CLIP ``.pt`` files already on disk (a file, or a directory
holding them under their release names, e.g. a mounted
``~/.cache/clip``), verifies each against the release sha256 manifest,
converts it with ``models.convert`` and writes the JAX CLI's six files,
keys and ``meta/`` strings, so one artifact serves both packages:

    <out>/weights/clip_{name}.npz                (full: image + text + logit_scale)
    <out>/weights/clip_image_encoder_{name}.npz
    <out>/weights/clip_text_encoder_{name}.npz
    <out>/configs/clip_{name}.json               (arch metadata)
    <out>/configs/clip_image_encoder_{name}.json
    <out>/configs/clip_text_encoder_{name}.json

The full ``clip_{name}.npz`` is what ``--pretrained`` of the three CLIs
takes in place of the ``.pt`` (``models/pretrained.py``), and what
``--weight_path`` cannot: it holds the towers only.

    python -m clip_ebc_tpu_torch.cli.prepare --src ~/.cache/clip --out prepared/
    python -m clip_ebc_tpu_torch.cli.prepare --src ViT-B-16.pt --models ViT-B/16

``--download`` is not ported (no machine of this project reaches the
network; ROADMAP Queue 1 item 3) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("clip_ebc_tpu_torch")

# The OpenAI release files; each file's sha256 is the penultimate path
# segment of its URL.
MODEL_URLS: Dict[str, str] = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "https://openaipublic.azureedge.net/clip/models/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "https://openaipublic.azureedge.net/clip/models/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}

# OpenAI name -> the backbone name of ``clip_{name}``
MODEL_NAME_MAP: Dict[str, str] = {
    "RN50": "resnet50",
    "RN101": "resnet101",
    "RN50x4": "resnet50x4",
    "RN50x16": "resnet50x16",
    "RN50x64": "resnet50x64",
    "ViT-B/32": "vit_b_32",
    "ViT-B/16": "vit_b_16",
    "ViT-L/14": "vit_l_14",
    "ViT-L/14@336px": "vit_l_14_336px",
}


def available_models() -> List[str]:
    return list(MODEL_URLS)


def expected_sha256(name: str) -> str:
    return MODEL_URLS[name].split("/")[-2]


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify_checkpoint(name: str, path: str) -> None:
    got, want = sha256_file(path), expected_sha256(name)
    if got != want:
        raise ValueError(
            f"{name}: sha256 mismatch for {path}\n  expected {want}\n  got      {got}\n"
            "(corrupt or wrong file; pass --no-verify only for non-release checkpoints)")


def _arch_configs(sd, arch: str) -> Tuple[dict, dict, dict]:
    """The (full, image, text) JSON arch configs of a state dict (the
    reference's ``build_model`` sniffing)."""
    embed_dim = int(sd["text_projection"].shape[1])
    context_length = int(sd["positional_embedding"].shape[0])
    vocab_size = int(sd["token_embedding.weight"].shape[0])
    transformer_width = int(sd["ln_final.weight"].shape[0])
    transformer_heads = transformer_width // 64
    transformer_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})

    if "visual.class_embedding" in sd:  # ViT tower
        vision_width = int(sd["visual.conv1.weight"].shape[0])
        vision_patch_size = int(sd["visual.conv1.weight"].shape[-1])
        vision_layers = len({k.split(".")[3] for k in sd
                             if k.startswith("visual.transformer.resblocks.")})
        grid = int(round((int(sd["visual.positional_embedding"].shape[0]) - 1) ** 0.5))
        image_resolution = grid * vision_patch_size
        vision_heads = vision_width // 64
    else:  # ModifiedResNet tower
        vision_patch_size = None
        vision_layers = [len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{i}.")})
                         for i in (1, 2, 3, 4)]
        vision_width = int(sd["visual.layer1.0.conv1.weight"].shape[0])
        spacial = int(round((int(sd["visual.attnpool.positional_embedding"].shape[0]) - 1) ** 0.5))
        image_resolution = spacial * 32
        vision_heads = vision_width * 32 // 64

    vision = {"embed_dim": embed_dim, "image_resolution": image_resolution,
              "vision_layers": vision_layers, "vision_width": vision_width,
              "vision_patch_size": vision_patch_size}
    text = {"context_length": context_length, "vocab_size": vocab_size,
            "transformer_width": transformer_width, "transformer_heads": transformer_heads,
            "transformer_layers": transformer_layers}
    full = {**vision, **text, "backbone": arch}
    image = {**vision, "vision_heads": vision_heads, "backbone": arch}
    return full, image, {"embed_dim": embed_dim, **text, "backbone": arch}


def prepare_one(ckpt_path: str, out_dir: str, name: Optional[str] = None,
                verify: bool = True) -> str:
    """Convert one OpenAI CLIP checkpoint into the prepared ``.npz`` and
    JSON artifacts; returns the detected backbone name. An unnamed file is
    named by its hash when it is a release file."""
    from ..models import convert as C

    if name is not None and verify:
        verify_checkpoint(name, ckpt_path)
    elif name is None and verify:
        got = sha256_file(ckpt_path)
        name = next((n for n in MODEL_URLS if expected_sha256(n) == got), None)
        if name is None:
            logger.warning("%s does not match any release checkpoint's sha256; "
                           "converting without manifest verification", ckpt_path)

    sd = C.load_torch_state_dict(ckpt_path)
    arch = C.detect_clip_arch(sd)
    if name is not None and MODEL_NAME_MAP[name] != arch:
        raise ValueError(f"{ckpt_path} was named {name} but its state dict is {arch}")
    is_vit = arch.startswith("vit")

    weight_dir, config_dir = os.path.join(out_dir, "weights"), os.path.join(out_dir, "configs")
    os.makedirs(weight_dir, exist_ok=True)
    os.makedirs(config_dir, exist_ok=True)

    meta = {"backbone": arch, "source_sha256": sha256_file(ckpt_path)}
    full_p, full_s = C.convert_clip_ebc(sd, is_vit=is_vit)
    C.save_prepared_tree(os.path.join(weight_dir, f"clip_{arch}.npz"), full_p, full_s,
                         {**meta, "split": "full"})
    del full_p, full_s
    # the image tower with the pooled head's projection, for standalone use
    img_p, img_s = (C.convert_clip_vit if is_vit else C.convert_clip_resnet)(sd, True)
    C.save_prepared_tree(os.path.join(weight_dir, f"clip_image_encoder_{arch}.npz"),
                         img_p, img_s, {**meta, "split": "image"})
    del img_p, img_s
    txt_p, txt_s = C.convert_clip_text(sd)
    C.save_prepared_tree(os.path.join(weight_dir, f"clip_text_encoder_{arch}.npz"),
                         txt_p, txt_s, {**meta, "split": "text"})

    for fname, cfg in zip((f"clip_{arch}.json", f"clip_image_encoder_{arch}.json",
                           f"clip_text_encoder_{arch}.json"), _arch_configs(sd, arch)):
        with open(os.path.join(config_dir, fname), "w") as f:
            json.dump(cfg, f, indent=4)
    logger.info("prepared %s -> %s/weights/clip_%s.npz", ckpt_path, out_dir, arch)
    return arch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Verify, split and convert OpenAI CLIP checkpoints into prepared artifacts")
    p.add_argument("--src", type=str, default=None,
                   help="a .pt checkpoint file, or a directory of them (e.g. a mounted "
                   "~/.cache/clip)")
    p.add_argument("--models", type=str, nargs="*", default=None,
                   help="OpenAI names to prepare (default: every manifest model found "
                   f"under --src); choices: {available_models()}")
    p.add_argument("--download", action="store_true",
                   help="download missing checkpoints: not ported (raises)")
    p.add_argument("--download_root", type=str, default=os.path.expanduser("~/.cache/clip"))
    p.add_argument("--out", type=str, default="prepared",
                   help="output directory (weights/ and configs/ are made inside)")
    p.add_argument("--no-verify", dest="verify", action="store_false",
                   help="skip the sha256 manifest verification")
    return p


def _unknown(name: str) -> None:
    if name not in MODEL_URLS:
        raise SystemExit(f"unknown model {name!r}; choices: {available_models()}")


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    if args.download:
        raise NotImplementedError(
            "--download is not ported (ROADMAP Queue 1 item 3): no machine of this "
            "project reaches the network; pass --src FILE|DIR of checkpoints on disk")

    jobs: List[Tuple[Optional[str], str]] = []  # (manifest name or None, path)
    if args.src and os.path.isfile(args.src):
        name = args.models[0] if args.models else None
        if name is not None:
            _unknown(name)
        jobs.append((name, args.src))
    elif args.src and os.path.isdir(args.src):
        for name in args.models or available_models():
            _unknown(name)
            path = os.path.join(args.src, os.path.basename(MODEL_URLS[name]))
            if os.path.isfile(path):
                jobs.append((name, path))
            elif args.models:  # asked for by name: a hard error
                raise SystemExit(f"{name}: {path} not found under --src")
        if not jobs:
            raise SystemExit(f"no manifest checkpoints found under {args.src}")
    else:
        raise SystemExit("pass --src FILE|DIR")

    for name, path in jobs:
        prepare_one(path, args.out, name=name, verify=args.verify)
    print(f"prepared {len(jobs)} checkpoint(s) -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
