"""Crowd-counting datasets and image helpers: counterpart of
``clip_ebc_tpu/data/crowd.py`` (``CrowdDataset``, ``_load_image``,
``normalize_image``), numpy only.

Canonical layout (as the JAX package's preprocessing writes it):

    {root}/{dataset}/{split}/images/{id}.jpg|.npy
    {root}/{dataset}/{split}/labels/{id}.npy      # (N, 2) float xy points

``CrowdDataset.__getitem__`` returns ``num_crops`` augmented crops of one
image (float32 NHWC, ImageNet-normalized), their point lists and dot
density maps. ``NWPUTestDataset`` lists the 1500 unlabeled NWPU-Crowd test
images (``{root}/nwpu/test/images``) and returns one normalized image and
its file name.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..config import IMAGENET_MEAN, IMAGENET_STD, SPLIT_SIZES, standardize_dataset_name
from .density import rasterize_points

_MEAN = np.asarray(IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(IMAGENET_STD, dtype=np.float32)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a float32 [0, 1] HWC image."""
    return ((image - _MEAN) / _STD).astype(np.float32)


def _get_id(name: str) -> int:
    return int(os.path.basename(name).split(".")[0])


def _load_image(path: str) -> np.ndarray:
    """Load an image file (jpg/png/... or ``.npy``, HWC or CHW) as float32
    HWC in [0, 1]."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
        img = arr.astype(np.float32) / 255.0
    else:
        from PIL import Image

        with open(path, "rb") as f:
            img = np.asarray(Image.open(f).convert("RGB"), dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def _list_split(root: str, split: str) -> Tuple[List[str], List[str]]:
    image_dir = os.path.join(root, split, "images")
    npys = sorted(glob.glob(os.path.join(image_dir, "*.npy")), key=_get_id)
    images = npys if npys else sorted(glob.glob(os.path.join(image_dir, "*.jpg")), key=_get_id)
    labels = sorted(glob.glob(os.path.join(root, split, "labels", "*.npy")), key=_get_id)
    return images, labels


class CrowdDataset:
    """Labeled crowd dataset (train/val splits)."""

    def __init__(
        self,
        dataset: str,
        split: str,
        data_root: str = "data",
        transforms: Optional[Callable] = None,
        num_crops: int = 1,
        check_sizes: bool = True,
    ) -> None:
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split}")
        if num_crops < 1:
            raise ValueError(f"num_crops must be positive, got {num_crops}")
        self.dataset = standardize_dataset_name(dataset)
        self.split = split
        self.root = os.path.join(data_root, self.dataset)
        self.transforms = transforms
        self.num_crops = num_crops

        self.image_paths, self.label_paths = _list_split(self.root, split)
        image_ids = [_get_id(p) for p in self.image_paths]
        label_ids = [_get_id(p) for p in self.label_paths]
        if image_ids != label_ids:
            raise ValueError(f"image/label ids mismatch under {self.root}/{split}")
        if check_sizes:
            expected = SPLIT_SIZES[self.dataset].get(split)
            if expected is not None and len(self.image_paths) != expected:
                raise ValueError(
                    f"{self.dataset} {split} split should have {expected} images, "
                    f"found {len(self.image_paths)}"
                )
        self._max_point_count: Optional[int] = None

    def __len__(self) -> int:
        return len(self.image_paths)

    def max_point_count(self) -> int:
        """Max annotation count across the split, from the npy headers
        (``mmap_mode`` reads no data); sizes the OT point pad."""
        if self._max_point_count is None:
            self._max_point_count = max(
                (int(np.prod(np.load(p, mmap_mode="r").shape)) // 2 for p in self.label_paths),
                default=0,
            )
        return self._max_point_count

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        """Returns (images [K,H,W,3], points list of K (N,2), densities [K,H,W])."""
        rng = rng or np.random.default_rng()
        image = _load_image(self.image_paths[index])
        label = np.load(self.label_paths[index]).astype(np.float32).reshape(-1, 2)

        images, labels = [], []
        for _ in range(self.num_crops):
            img, lab = image, label
            if self.transforms is not None:
                img, lab = self.transforms(image.copy(), label.copy(), rng)
            images.append(normalize_image(img))
            labels.append(np.asarray(lab, dtype=np.float32).reshape(-1, 2))

        densities = np.stack(
            [rasterize_points(lab, img.shape[0], img.shape[1]) for img, lab in zip(images, labels)],
            axis=0,
        )
        return np.stack(images, axis=0), labels, densities


class NWPUTestDataset:
    """The 1500 unlabeled NWPU test images, ``.npy`` files if there are
    any, else ``.jpg``, sorted by id; ``check_sizes`` asserts the split's
    size."""

    def __init__(
        self,
        data_root: str = "data",
        transforms: Optional[Callable] = None,
        check_sizes: bool = True,
    ) -> None:
        self.root = os.path.join(data_root, "nwpu")
        image_dir = os.path.join(self.root, "test", "images")
        npys = sorted(glob.glob(os.path.join(image_dir, "*.npy")), key=_get_id)
        self.image_paths = npys if npys else sorted(
            glob.glob(os.path.join(image_dir, "*.jpg")), key=_get_id
        )
        expected = SPLIT_SIZES["nwpu"]["test"]
        if check_sizes and len(self.image_paths) != expected:
            raise ValueError(
                f"NWPU test split should have {expected} images, found {len(self.image_paths)}"
            )
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        """``(normalized (H, W, 3) image, file name)``; transforms see the
        image with an empty point list and a fixed generator."""
        path = self.image_paths[index]
        image = _load_image(path)
        if self.transforms is not None:
            image, _ = self.transforms(image, np.zeros((0, 2), np.float32), np.random.default_rng(0))
        return normalize_image(image), os.path.basename(path)
