"""Image loading and normalization: counterpart of ``_load_image`` and
``normalize_image`` in ``clip_ebc_tpu/data/crowd.py`` (numpy only; the
datasets and the training loader are a later slice)."""

from __future__ import annotations

import numpy as np

from ..config import IMAGENET_MEAN, IMAGENET_STD

_MEAN = np.asarray(IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(IMAGENET_STD, dtype=np.float32)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a float32 [0, 1] HWC image."""
    return ((image - _MEAN) / _STD).astype(np.float32)


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
