"""Paired image+point transforms on numpy arrays (host-side pipeline):
the port's copy of ``clip_ebc_tpu/data/transforms.py``, numpy and PIL only
(the JAX package's optional native resize is not carried over, so this is
its numpy path).

Images are float32 NHWC in [0, 1]; labels are float32 (N, 2) arrays of
(x, y) point coordinates in pixel space. Geometric ops update the points
with the same semantics as the reference's torch transforms
(reference datasets/transforms.py):

- crop: shift by (-left, -top), keep points with 0 <= x < w and 0 <= y < h
  (reference datasets/transforms.py:9-24)
- resize: scale by (w_new/w, h_new/h), clamp to [0, size-1]
  (reference datasets/transforms.py:27-41)
- hflip: x -> w - 1 - x (reference datasets/transforms.py:184-197)

Randomness is explicit: every random transform takes a
``numpy.random.Generator`` so the pipeline is seedable per-host and
reproducible, replacing torch's global RNG draws.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

Array = np.ndarray
PairTransform = Callable[[Array, Array, np.random.Generator], Tuple[Array, Array]]


def _empty_points() -> Array:
    return np.zeros((0, 2), dtype=np.float32)


def _as_points(label: Array) -> Array:
    label = np.asarray(label, dtype=np.float32)
    if label.size == 0:
        return _empty_points()
    if label.ndim != 2 or label.shape[1] != 2:
        raise ValueError(f"label must be (N, 2), got {label.shape}")
    return label


def crop(image: Array, label: Array, top: int, left: int, height: int, width: int) -> Tuple[Array, Array]:
    """Crop image (H, W, C) and shift/filter points accordingly."""
    ih, iw = image.shape[:2]
    if top < 0 or left < 0 or top + height > ih or left + width > iw:
        # torchvision pads out-of-bounds crops; our callers never request them.
        raise ValueError(
            f"crop ({top},{left},{height},{width}) out of bounds for image {ih}x{iw}"
        )
    image = image[top : top + height, left : left + width]
    label = _as_points(label)
    if len(label) > 0:
        label = label - np.array([left, top], dtype=np.float32)
        keep = (
            (label[:, 0] >= 0)
            & (label[:, 0] < width)
            & (label[:, 1] >= 0)
            & (label[:, 1] < height)
        )
        label = label[keep]
    return image, label


def _torch_cubic_taps(in_size: int, out_size: int, a: float = -0.75):
    """Per-output 4-tap indices/weights of torch's bicubic (a=-0.75,
    half-pixel centers, border replicate) — numpy twin of
    ops/interpolate._cubic_taps, for the host pipeline."""
    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(x)
    t = x - x0

    def kernel(s):
        s = np.abs(s)
        return np.where(
            s <= 1.0,
            ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0,
            np.where(s < 2.0, a * (((s - 5.0) * s + 8.0) * s - 4.0), 0.0),
        )

    offsets = np.array([-1.0, 0.0, 1.0, 2.0])
    idx = np.clip((x0[:, None] + offsets[None, :]).astype(np.int64), 0, in_size - 1)
    return idx, kernel(t[:, None] - offsets[None, :]).astype(np.float32)


def _pil_resize_axis(image: Array, axis: int, out_size: int) -> Array:
    """Antialiased bicubic resize of ONE axis via PIL (the other axis is
    identity: PIL's scale-1 bicubic weights are exactly [0, 1, 0, 0]).

    All channels go through ONE single-channel ("F") PIL call by packing
    them along the axis that is not being resized — per-row/column math is
    independent along that axis, so the values are identical to the
    per-channel loop at a third of the PIL/tobytes overhead."""
    from PIL import Image

    ih, iw, c = image.shape
    if axis == 0:
        # resize H; pack channels into the W axis: (H, W*C), C-minor
        packed = np.ascontiguousarray(image).reshape(ih, iw * c)
        im = Image.fromarray(packed, mode="F")
        out = np.asarray(im.resize((iw * c, out_size), Image.BICUBIC))
        return out.reshape(out_size, iw, c).astype(np.float32)
    # resize W; pack channels into the H axis: (C*H, W)
    packed = np.ascontiguousarray(image.transpose(2, 0, 1)).reshape(c * ih, iw)
    im = Image.fromarray(packed, mode="F")
    out = np.asarray(im.resize((out_size, c * ih), Image.BICUBIC))
    return np.ascontiguousarray(
        out.reshape(c, ih, out_size).transpose(1, 2, 0)
    ).astype(np.float32)


def _resize_image(image: Array, height: int, width: int) -> Array:
    """Bicubic resize with torchvision ``antialias=True`` semantics
    (the reference's eval/aug resize, reference datasets/transforms.py:34):
    per axis, downscale uses the PIL-style antialiased bicubic kernel
    (torchvision's antialiased float path was built to match PIL) and
    upscale uses torch's plain bicubic (a=-0.75, antialias is a no-op on
    upscale in torchvision)."""
    ih, iw = image.shape[:2]
    if (ih, iw) == (height, width):
        return image
    out = image.astype(np.float32)
    for axis, (in_size, out_size) in enumerate(((ih, height), (iw, width))):
        if out_size == in_size:
            continue
        if out_size < in_size:  # antialiased downscale
            out = _pil_resize_axis(out, axis, out_size)
        else:  # torch-parity upscale
            idx, wt = _torch_cubic_taps(in_size, out_size)
            # Per-tap accumulation: 4 gathered (O, W, C) slabs instead of
            # one (O, 4, W, C) materialization
            if axis == 0:
                acc = wt[:, 0, None, None] * out[idx[:, 0]]
                for t in range(1, 4):
                    acc += wt[:, t, None, None] * out[idx[:, t]]
            else:
                acc = wt[None, :, 0, None] * out[:, idx[:, 0]]
                for t in range(1, 4):
                    acc += wt[None, :, t, None] * out[:, idx[:, t]]
            out = acc.astype(np.float32)
    return out


def resize(image: Array, label: Array, height: int, width: int) -> Tuple[Array, Array]:
    """Resize image and rescale+clamp points (reference datasets/transforms.py:27-41)."""
    ih, iw = image.shape[:2]
    label = _as_points(label)
    if (ih, iw) == (height, width):
        return image, label
    image = _resize_image(image, height, width)
    if len(label) > 0:
        label = label * np.array([width / iw, height / ih], dtype=np.float32)
        label[:, 0] = np.clip(label[:, 0], 0, width - 1)
        label[:, 1] = np.clip(label[:, 1], 0, height - 1)
    return image, label


def hflip(image: Array, label: Array) -> Tuple[Array, Array]:
    image = image[:, ::-1].copy()
    label = _as_points(label)
    if len(label) > 0:
        w = image.shape[1]
        label = label.copy()
        label[:, 0] = np.clip(w - 1 - label[:, 0], 0, w - 1)
    return image, label


def _pair(window_size) -> Tuple[int, int]:
    if isinstance(window_size, (int, float)):
        return int(window_size), int(window_size)
    ws = tuple(int(w) for w in window_size)
    if len(ws) != 2:
        raise ValueError(f"expected (h, w) pair, got {window_size}")
    return ws


class Resize2Multiple:
    """Resize so H = window_h + stride_h * round((H - window_h)/stride_h), same for W.

    Makes the sliding-window grid tile exactly (reference
    datasets/transforms.py:69-102).
    """

    def __init__(self, window_size, stride) -> None:
        self.window_size = _pair(window_size)
        self.stride = _pair(stride)
        _check_window_stride(self.window_size, self.stride)

    def __call__(self, image: Array, label: Array, rng: Optional[np.random.Generator] = None) -> Tuple[Array, Array]:
        ih, iw = image.shape[:2]
        (wh, ww), (sh, sw) = self.window_size, self.stride
        nh = int(max(round((ih - wh) / sh), 0) * sh + wh)
        nw = int(max(round((iw - ww) / sw), 0) * sw + ww)
        if (nh, nw) == (ih, iw):
            return image, _as_points(label)
        return resize(image, label, nh, nw)


class ZeroPad2Multiple:
    """Bottom/right zero-pad up to the sliding-window grid (points unchanged;
    reference datasets/transforms.py:105-135)."""

    def __init__(self, window_size, stride) -> None:
        self.window_size = _pair(window_size)
        self.stride = _pair(stride)
        _check_window_stride(self.window_size, self.stride)

    def __call__(self, image: Array, label: Array, rng: Optional[np.random.Generator] = None) -> Tuple[Array, Array]:
        ih, iw = image.shape[:2]
        (wh, ww), (sh, sw) = self.window_size, self.stride
        nh = int(max(math.ceil((ih - wh) / sh), 0) * sh + wh)
        nw = int(max(math.ceil((iw - ww) / sw), 0) * sw + ww)
        if (nh, nw) == (ih, iw):
            return image, _as_points(label)
        out = np.zeros((nh, nw, image.shape[2]), dtype=image.dtype)
        out[:ih, :iw] = image
        return out, _as_points(label)


def _check_window_stride(window_size: Tuple[int, int], stride: Tuple[int, int]) -> None:
    if not all(s > 0 for s in window_size) or not all(s > 0 for s in stride):
        raise ValueError(f"window_size/stride must be positive, got {window_size}, {stride}")
    if stride[0] > window_size[0] or stride[1] > window_size[1]:
        raise ValueError(f"stride {stride} must be <= window_size {window_size}")


def _upscale_window(
    image: Array, rh: int, rw: int, top: int, left: int, ch: int, cw: int
) -> Array:
    """``_resize_image(image, rh, rw)[top:top+ch, left:left+cw]`` for the
    pure-upscale case (rh >= ih, rw >= iw), computing ONLY the cropped
    output region: the taps are those of the full (rh, rw) grid sliced to
    the window, so the work drops by the crop ratio (the scale-jitter aug
    crops right after upscaling — the rest of the upscaled image is
    waste). BITWISE the full-resize value."""
    idx_y, wy = _torch_cubic_taps(image.shape[0], rh)
    idx_x, wx = _torch_cubic_taps(image.shape[1], rw)
    idx_y, wy = idx_y[top : top + ch], wy[top : top + ch]
    idx_x, wx = idx_x[left : left + cw], wx[left : left + cw]
    out = image.astype(np.float32)
    for axis, (idx, wt) in enumerate(((idx_y, wy), (idx_x, wx))):
        if axis == 0:
            acc = wt[:, 0, None, None] * out[idx[:, 0]]
            for t in range(1, 4):
                acc += wt[:, t, None, None] * out[idx[:, t]]
        else:
            acc = wt[None, :, 0, None] * out[:, idx[:, 0]]
            for t in range(1, 4):
                acc += wt[None, :, t, None] * out[:, idx[:, t]]
        out = acc.astype(np.float32)
    return out


class RandomResizedCrop:
    """Scale-jittered crop: crop size = out_size * U(scale), resize-then-crop
    when the scaled crop exceeds the image (reference
    datasets/transforms.py:138-181)."""

    def __init__(self, size: Tuple[int, int], scale: Tuple[float, float] = (0.75, 1.25)) -> None:
        self.size = _pair(size)
        self.scale = tuple(scale)
        if not (0 < self.scale[0] <= self.scale[1]):
            raise ValueError(f"invalid scale range {self.scale}")

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        oh, ow = self.size
        s = float(rng.uniform(self.scale[0], self.scale[1]))
        ih, iw = image.shape[:2]
        ch, cw = int(oh * s), int(ow * s)
        if ch <= ih and cw <= iw:
            top = int(rng.integers(0, ih - ch + 1))
            left = int(rng.integers(0, iw - cw + 1))
            image, label = crop(image, label, top, left, ch, cw)
        else:
            ratio = max(ch / ih, cw / iw)
            rh, rw = int(ih * ratio) + 1, int(iw * ratio) + 1
            top = int(rng.integers(0, rh - ch + 1))
            left = int(rng.integers(0, rw - cw + 1))
            # Windowed upscale: same values as resize(rh, rw) then crop —
            # the point math goes through the SAME resize()/crop() label
            # code on a size-only stub so the semantics stay in one place.
            _, label = resize(
                np.empty((ih, iw, 0), np.float32), label, rh, rw
            )
            label = _as_points(label)
            if len(label) > 0:
                label = label - np.array([left, top], dtype=np.float32)
                keep = (
                    (label[:, 0] >= 0)
                    & (label[:, 0] < cw)
                    & (label[:, 1] >= 0)
                    & (label[:, 1] < ch)
                )
                label = label[keep]
            image = _upscale_window(image, rh, rw, top, left, ch, cw)
        return resize(image, label, oh, ow)


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5) -> None:
        if not 0 <= p <= 1:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = p

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        if rng.random() < self.p:
            return hflip(image, label)
        return image, _as_points(label)


# ---------------------------------------------------------------------------
# Photometric transforms (image-only).
# ---------------------------------------------------------------------------


def _rgb_to_gray(image: Array) -> Array:
    # ITU-R 601-2 luma, same weights torchvision uses.
    gray = image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114
    return gray[..., None]


def adjust_brightness(image: Array, factor: float) -> Array:
    return np.clip(image * factor, 0.0, 1.0)


def adjust_contrast(image: Array, factor: float) -> Array:
    mean = _rgb_to_gray(image).mean()
    return np.clip(mean + factor * (image - mean), 0.0, 1.0)


def adjust_saturation(image: Array, factor: float) -> Array:
    gray = _rgb_to_gray(image)
    return np.clip(gray + factor * (image - gray), 0.0, 1.0)


def adjust_hue(image: Array, factor: float) -> Array:
    """Shift hue by ``factor`` (in turns, [-0.5, 0.5]) via RGB<->HSV."""
    if factor == 0:
        return image
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    maxc = image.max(axis=-1)
    minc = image.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)

    h = (h + factor) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ],
    )
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class ColorJitter:
    """Random brightness/contrast/saturation/hue, each applied in random
    order with a uniformly sampled factor, like torchvision's ColorJitter
    (used at reference datasets/transforms.py:200-211)."""

    def __init__(
        self,
        brightness: float = 0.4,
        contrast: float = 0.4,
        saturation: float = 0.4,
        hue: float = 0.2,
    ) -> None:
        self.brightness = self._range(brightness, center=1.0)
        self.contrast = self._range(contrast, center=1.0)
        self.saturation = self._range(saturation, center=1.0)
        self.hue = self._range(hue, center=0.0, bound=0.5)

    @staticmethod
    def _range(value, center: float, bound: Optional[float] = None):
        if isinstance(value, (tuple, list)):
            lo, hi = float(value[0]), float(value[1])
        else:
            lo, hi = center - float(value), center + float(value)
            if center == 1.0:
                lo = max(lo, 0.0)
        if bound is not None:
            lo, hi = max(lo, -bound), min(hi, bound)
        if lo == hi == center:
            return None
        return (lo, hi)

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        ops: List[Callable[[Array], Array]] = []
        if self.brightness is not None:
            f = rng.uniform(*self.brightness)
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.contrast is not None:
            f = rng.uniform(*self.contrast)
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        if self.saturation is not None:
            f = rng.uniform(*self.saturation)
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.hue is not None:
            f = rng.uniform(*self.hue)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        order = rng.permutation(len(ops))
        for idx in order:
            image = ops[idx](image)
        return image.astype(np.float32), _as_points(label)


class GaussianBlur:
    def __init__(self, kernel_size: int) -> None:
        if kernel_size % 2 == 0 or kernel_size <= 0:
            raise ValueError(f"kernel_size must be odd positive, got {kernel_size}")
        self.kernel_size = kernel_size

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        # torchvision's sigma for a kernel size given alone
        sigma = 0.3 * ((self.kernel_size - 1) * 0.5 - 1) + 0.8
        half = self.kernel_size // 2
        x = np.arange(-half, half + 1, dtype=np.float32)
        k = np.exp(-0.5 * (x / sigma) ** 2)
        k /= k.sum()
        # Separable blur with edge replication (torchvision pads reflect;
        # difference only affects a half-kernel border band).
        pad = ((half, half), (0, 0), (0, 0))
        im = np.pad(image, pad, mode="edge")
        im = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 0, im)
        im = np.pad(im, ((0, 0), (half, half), (0, 0)), mode="edge")
        im = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 1, im)
        return im.astype(np.float32), _as_points(label)


class PepperSaltNoise:
    def __init__(self, saltiness: float = 1e-3, spiciness: float = 1e-3) -> None:
        self.saltiness = saltiness
        self.spiciness = spiciness

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        noise = rng.random(image.shape, dtype=np.float32)
        image = np.where(noise < self.saltiness, 1.0, image)
        image = np.where(noise > 1.0 - self.spiciness, 0.0, image)
        return image.astype(np.float32), _as_points(label)


class RandomApply:
    """Apply each transform independently with its own probability
    (reference datasets/transforms.py:235-248)."""

    def __init__(self, transforms: Sequence[PairTransform], p: Sequence[float]) -> None:
        self.transforms = list(transforms)
        probs = list(p)
        if len(probs) != len(self.transforms):
            raise ValueError("p must hold one probability per transform")
        if not all(0 <= q <= 1 for q in probs):
            raise ValueError(f"probabilities must be in [0, 1], got {probs}")
        self.p = probs

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        for t, p in zip(self.transforms, self.p):
            if rng.random() < p:
                image, label = t(image, label, rng)
        return image, label


class Compose:
    def __init__(self, transforms: Sequence[PairTransform]) -> None:
        self.transforms = list(transforms)

    def __call__(self, image: Array, label: Array, rng: np.random.Generator) -> Tuple[Array, Array]:
        for t in self.transforms:
            image, label = t(image, label, rng)
        return image, label
