"""Synthetic crowd-scene generator: the port's copy of
``clip_ebc_tpu/data/synthetic.py`` (the same scenes from the same seed).

Real crowd datasets (ShanghaiTech / QNRF / NWPU) cannot be redistributed
and are not mounted in every environment, but two jobs need *representative*
imagery rather than N(0,1) noise:

- convergence runs — training end-to-end and watching val MAE drop is the
  strongest accuracy signal available without the real data;
- int8 calibration / bf16-vs-int8 accuracy deltas — activation ranges on
  crowd-like images, not noise.

The renderer mimics the statistics that matter for counting: a textured
background (sky->ground gradient + low-frequency clutter), people drawn as
small head+body blob pairs whose size shrinks with image depth (top of the
image = far away, like a typical surveillance viewpoint), placed in
Gaussian clusters with heavy-tailed cluster sizes, with the GROUND-TRUTH
point at the head center — the same annotation convention as the real
datasets (reference preprocess.py parsers emit head xy points).

``make_synthetic_crowd_dataset`` writes the canonical layout
({root}/{name}/{split}/{images,labels}) that CrowdDataset reads, so the
full production pipeline — loader, transforms, rasterizer, trainer CLI —
runs unchanged on it (pass ``check_sizes=False`` / --*_disable_size_check).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def render_crowd_scene(
    rng: np.random.Generator,
    size: Tuple[int, int] = (512, 768),
    count: Optional[int] = None,
    max_count: int = 400,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one scene; returns (uint8 HWC image, (N, 2) float32 xy heads)."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    # background: vertical gradient + low-frequency clutter + fine noise
    base = rng.uniform(0.25, 0.75, 3).astype(np.float32)
    tilt = rng.uniform(-0.25, 0.25)
    img = base[None, None, :] + tilt * (yy / h)[:, :, None]
    for _ in range(3):  # clutter blobs (buildings/trees/ground patches)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sy, sx = rng.uniform(h / 8, h / 2), rng.uniform(w / 8, w / 2)
        blob = np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        img += blob[:, :, None] * rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    img += rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)

    if count is None:
        # heavy-tailed count distribution, like the real benchmarks
        count = int(min(np.exp(rng.uniform(0.0, np.log(max_count + 1))), max_count))

    # cluster centers, then people scattered around them
    n_clusters = max(1, int(rng.integers(1, 6)))
    centers = np.stack(
        [rng.uniform(0, w, n_clusters), rng.uniform(h * 0.15, h, n_clusters)], 1
    )
    which = rng.integers(0, n_clusters, count)
    spread = rng.uniform(w / 16, w / 4)
    pts = centers[which] + rng.normal(0, spread, (count, 2))
    pts[:, 0] = np.clip(pts[:, 0], 1, w - 2)
    pts[:, 1] = np.clip(pts[:, 1], h * 0.1, h - 2)

    # draw far->near so near (larger) people occlude far ones
    order = np.argsort(pts[:, 1])
    for x, y in pts[order]:
        depth = y / h  # 0 top (far) .. 1 bottom (near)
        r = 1.0 + 7.0 * depth * (min(h, w) / 512.0)  # head radius, px
        skin = np.asarray(
            [rng.uniform(0.4, 0.9), rng.uniform(0.3, 0.7), rng.uniform(0.25, 0.6)],
            np.float32,
        )
        shirt = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        y0, y1 = int(max(y - 2 * r, 0)), int(min(y + 6 * r, h))
        x0, x1 = int(max(x - 3 * r, 0)), int(min(x + 3 * r, w))
        if y1 <= y0 or x1 <= x0:
            continue
        ly, lx = yy[y0:y1, x0:x1], xx[y0:y1, x0:x1]
        head = np.exp(-(((ly - y) / r) ** 2 + ((lx - x) / r) ** 2) * 1.2)
        body = np.exp(
            -(((ly - (y + 2.8 * r)) / (2.2 * r)) ** 2 + ((lx - x) / (1.4 * r)) ** 2)
        )
        patch = img[y0:y1, x0:x1]
        patch += head[:, :, None] * (skin - patch) * 0.9
        patch += body[:, :, None] * (shirt - patch) * 0.8

    img = np.clip(img, 0.0, 1.0)
    return (img * 255).astype(np.uint8), pts.astype(np.float32)


def make_synthetic_crowd_dataset(
    root: str,
    name: str = "shb",
    n_train: int = 128,
    n_val: int = 32,
    size: Tuple[int, int] = (512, 768),
    max_count: int = 400,
    seed: int = 0,
) -> str:
    """Write a canonical-layout synthetic dataset; returns its data root."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, name, split, "images")
        lab_dir = os.path.join(root, name, split, "labels")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lab_dir, exist_ok=True)
        for i in range(1, n + 1):
            img, pts = render_crowd_scene(rng, size=size, max_count=max_count)
            Image.fromarray(img).save(os.path.join(img_dir, f"{i}.jpg"), quality=92)
            np.save(os.path.join(lab_dir, f"{i}.npy"), pts)
    return root


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Generate a synthetic crowd dataset.")
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--name", type=str, default="shb")
    p.add_argument("--n_train", type=int, default=128)
    p.add_argument("--n_val", type=int, default=32)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--max_count", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    make_synthetic_crowd_dataset(
        a.root, a.name, a.n_train, a.n_val, (a.height, a.width), a.max_count, a.seed
    )
    print(f"wrote synthetic {a.name} ({a.n_train} train / {a.n_val} val) under {a.root}")


if __name__ == "__main__":
    main()
