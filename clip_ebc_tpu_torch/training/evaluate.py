"""Per-image count prediction and dataset evaluation: counterpart of
``clip_ebc_tpu/training/evaluate.py`` (``Evaluator``, ``evaluate``,
``evaluate_packed`` and the decode pool).

The model holds its own weights, so the methods take no variables
argument. A CLIP-EBC model's prompt features are constant per weight
set: they are encoded once and reused until a text-tower parameter
changes (a new tensor or an in-place load). A model without a text tower
(the Classifier and Regressor heads) is called as ``model(windows)``.
In a process group every rank evaluates the same image and the sliding
windows are split over the ranks (``ops.sliding_window``), as the JAX
Evaluator shards them on its mesh; a whole image runs on every rank.
Every rank must then evaluate, in the same order.
:meth:`Evaluator.predict_densities_packed` packs the windows of
consecutive images into fixed-size forward batches
(``ops/packed_eval.py``), each batch split over the ranks the same way.
``evaluate`` decodes ahead of the device on a thread, or across
``decode_procs`` spawned worker processes (a pool the Evaluator keeps
for repeated calls).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from ..data.loader import ordered_results, pool_dataset, spawn_pool
from ..ops.packed_eval import WindowPacker
from ..ops.sliding_window import sliding_window_predict
from ..parallel.mesh import gather_rows, get_world_size, shard_rows
from ..utils.metrics import CountErrorAccumulator


class Evaluator:
    """Wraps a model into per-image count prediction."""

    def __init__(
        self,
        model: torch.nn.Module,
        reduction: int,
        sliding_window: bool = False,
        window_size: Optional[int] = None,
        stride: Optional[int] = None,
        strategy: str = "average",
        pad_to_multiple: int = 0,
    ) -> None:
        self.model = model.eval()
        self.reduction = reduction
        self.sliding_window = sliding_window
        self.window = (window_size, window_size) if window_size else None
        self.stride = (stride, stride) if stride else None
        self.strategy = strategy
        self.pad_to_multiple = pad_to_multiple
        self.device = next(model.parameters()).device
        self._text_key = None
        self._text_feats = None
        # one decode pool per (dataset, procs), kept across evaluate() calls
        self._decode_pool: Optional[cf.ProcessPoolExecutor] = None
        self._decode_pool_key = None

    def text_features(self) -> Optional[torch.Tensor]:
        """The prompt features, re-encoded only when the text tower's
        parameters changed since the last call (None for a model without
        a text tower)."""
        if not hasattr(self.model, "encode_text"):
            return None
        key = tuple((p.data_ptr(), p._version) for p in self.model.text_encoder.parameters())
        if key != self._text_key:
            with torch.inference_mode():
                self._text_feats = self.model.encode_text()
            self._text_key = key
        return self._text_feats

    def _apply(self, windows: torch.Tensor, text: Optional[torch.Tensor]) -> torch.Tensor:
        out = self.model(windows) if text is None else self.model(windows, text_feats=text)
        return out.float()

    def _upload(self, image: np.ndarray) -> tuple:
        """The padded image on the model's device and the original (h, w)."""
        image, hw = self._pad_image(image)
        return torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device), hw

    def _crop(self, density: torch.Tensor, padded_hw, hw) -> torch.Tensor:
        """The density of the valid ``(h/r, w/r)`` region of a padded image."""
        if tuple(padded_hw) != tuple(hw):
            density = density[: hw[0] // self.reduction, : hw[1] // self.reduction]
        return density

    @torch.inference_mode()
    def predict_density(self, image: np.ndarray) -> torch.Tensor:
        """``(H, W, 3)`` normalized image -> ``(H/r, W/r)`` fp32 density on
        the model's device."""
        x, hw = self._upload(image)
        text = self.text_features()

        def forward(windows: torch.Tensor) -> torch.Tensor:
            return self._apply(windows, text)

        if self.sliding_window:
            density = sliding_window_predict(
                forward, x, self.window, self.stride, self.reduction, self.strategy
            )
        else:
            density = forward(x[None])[0]
        return self._crop(density, x.shape[:2], hw)

    def predict_count(self, image: np.ndarray) -> float:
        return float(self.predict_density(image).sum())

    @torch.inference_mode()
    def predict_densities_packed(
        self, images: Iterable[np.ndarray], batch_windows: int = 128, chunk: int = 16
    ) -> Iterator[torch.Tensor]:
        """``(H/r, W/r)`` fp32 densities of a stream of normalized images,
        in order, their windows packed across images into forward batches
        of ``batch_windows`` (``ops.packed_eval.WindowPacker``); each image
        padded as :meth:`predict_density` pads it and its density cropped
        back. The prompt features are encoded once for the stream. In a
        process group each batch is split over the ranks (``batch_windows``
        must divide evenly), so every rank must feed the same images in the
        same order."""
        if not self.sliding_window:
            raise ValueError("packed prediction requires sliding_window=True")
        world = get_world_size()
        if batch_windows % world:
            raise ValueError(
                f"batch_windows {batch_windows} must be divisible by the "
                f"mesh's {world} devices for packed eval under a mesh")
        self.model.eval()
        text = self.text_features()

        def forward(windows: torch.Tensor) -> torch.Tensor:
            if world == 1:
                return self._apply(windows, text)
            rows = shard_rows(windows.shape[0])
            return gather_rows(self._apply(windows[rows], text), rows, windows.shape[0])

        packer = WindowPacker(forward, self.window, self.stride, self.reduction, self.strategy,
                              batch_windows=batch_windows, chunk=chunk)
        valid = []  # each submitted image's original (h, w), in order

        def drain():
            for padded_hw, density in packer.ready():
                yield self._crop(density, padded_hw, valid.pop(0))

        for image in images:
            x, hw = self._upload(np.asarray(image))
            valid.append(hw)
            packer.add(x)
            yield from drain()
        packer.flush()
        yield from drain()

    def _pad_image(self, image: np.ndarray):
        """Pad up to one window and to ``pad_to_multiple`` with
        ImageNet-normalized black (-mean/std per channel, not 0); returns
        (padded image, original (h, w))."""
        h, w = image.shape[:2]
        nh, nw = h, w
        if self.sliding_window and self.window is not None:
            nh, nw = max(nh, self.window[0]), max(nw, self.window[1])
        pad = self.pad_to_multiple
        if pad:
            nh, nw = -(-nh // pad) * pad, -(-nw // pad) * pad
        if (nh, nw) != (h, w):
            black = -(np.asarray(IMAGENET_MEAN) / np.asarray(IMAGENET_STD))
            padded = np.broadcast_to(black.astype(image.dtype), (nh, nw, image.shape[2])).copy()
            padded[:h, :w] = image
            image = padded
        return image, (h, w)

    def decode_pool(self, dataset, decode_procs: int) -> cf.ProcessPoolExecutor:
        """The persistent decode pool of ``(dataset, decode_procs)``, made
        on first use and kept across :func:`evaluate` calls (a spawned
        worker pays the package's import once, not every epoch); a pool for
        another dataset or size is shut down first."""
        key = (id(dataset), decode_procs)
        if self._decode_pool is not None and self._decode_pool_key != key:
            self.close()
        if self._decode_pool is None:
            self._decode_pool = _make_decode_pool(dataset, decode_procs)
            self._decode_pool_key = key
        return self._decode_pool

    def close(self) -> None:
        """Shut down the decode pool, if there is one."""
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False, cancel_futures=True)
            self._decode_pool = None
            self._decode_pool_key = None


def _eval_pool_load(i: int) -> tuple:
    """In a decode worker: item i's image and ground-truth count."""
    images, labels, _ = pool_dataset()[i]
    return i, (images[0], float(len(labels[0])))


def _make_decode_pool(dataset, decode_procs: int) -> cf.ProcessPoolExecutor:
    return spawn_pool(dataset, decode_procs)


def _decoded_items(dataset, n: int, prefetch: int, decode_procs: int,
                   pool: Optional[cf.ProcessPoolExecutor] = None) -> Iterator[tuple]:
    """``(image, gt count)`` of items ``0..n-1`` in order, decoded ahead of
    the consumer: on a background thread (``decode_procs=0``), or across
    ``decode_procs`` worker processes with at most ``max(prefetch, 2 x
    decode_procs)`` items in flight, delivered in order. ``pool`` is a
    persistent pool (``Evaluator.decode_pool``); without one a pool is made
    and shut down here. A generator closed early cancels what is in
    flight."""
    if decode_procs > 0 and n > 0:
        owns_pool = pool is None
        if owns_pool:
            pool = _make_decode_pool(dataset, decode_procs)
        items = ordered_results(pool, _eval_pool_load, range(n), max(prefetch, 2 * decode_procs))
        try:
            yield from items
        finally:
            items.close()
            if owns_pool:
                pool.shutdown(wait=False, cancel_futures=True)
        return

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def producer():
        for i in range(n):
            if stop.is_set():
                return
            try:
                images, labels, _ = dataset[i]
                q.put((images[0], float(len(labels[0]))))
            except Exception as e:  # surfaced to the consumer below
                q.put(e)
                return

    threading.Thread(target=producer, daemon=True).start()
    try:
        for _ in range(n):
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()  # an abandoned evaluation: the producer takes no new item
        while not q.empty():  # a producer blocked on a full queue gets to see it
            q.get_nowait()


def evaluate(
    evaluator: Evaluator,
    dataset,
    progress: bool = False,
    prefetch: int = 2,
    decode_procs: int = 0,
) -> Dict[str, float]:
    """MAE and RMSE of the total counts over a labeled dataset (one crop,
    eval transforms), with the model in eval mode. Upcoming images are
    decoded ahead of the device (:func:`_decoded_items`: a thread, or
    ``decode_procs`` processes of the evaluator's persistent pool), and the
    count of image i is read on the host only after image i + 1 is
    dispatched. ``progress`` prints every 50 images."""
    evaluator.model.eval()
    acc = CountErrorAccumulator()
    n = len(dataset)
    pool = evaluator.decode_pool(dataset, decode_procs) if decode_procs > 0 and n > 0 else None
    items = _decoded_items(dataset, n, prefetch, decode_procs, pool=pool)
    pending = None  # (device count, ground truth)
    try:
        for i, (image, gt) in enumerate(items):
            count = evaluator.predict_density(image).sum()
            if pending is not None:
                acc.update(float(pending[0]), pending[1])
            pending = (count, gt)
            if progress and (i + 1) % 50 == 0:
                print(f"eval {i + 1}/{n}")
    finally:
        items.close()
    if pending is not None:
        acc.update(float(pending[0]), pending[1])
    return acc.result()


def evaluate_packed(
    evaluator: Evaluator,
    dataset,
    batch_windows: int = 128,
    chunk: int = 16,
    progress: bool = False,
) -> Dict[str, float]:
    """:func:`evaluate` with the windows of consecutive images packed into
    forward batches of ``batch_windows``
    (:meth:`Evaluator.predict_densities_packed`; a sliding-window
    Evaluator). The counts are :func:`evaluate`'s up to the batches'
    composition; the model runs in eval mode, so a window's density does
    not depend on its batch-mates."""
    evaluator.model.eval()
    acc = CountErrorAccumulator()
    n = len(dataset)
    items = _decoded_items(dataset, n, prefetch=4, decode_procs=0)
    gts = []

    def images():
        for image, gt in items:
            gts.append(gt)
            yield image

    done = 0
    try:
        for density in evaluator.predict_densities_packed(images(), batch_windows, chunk):
            acc.update(float(density.sum()), gts[done])
            done += 1
            if progress and done % 50 == 0:
                print(f"eval {done}/{n}")
    finally:
        items.close()
    if done != n:
        raise RuntimeError(f"packed eval produced {done} of {n} densities")
    return acc.result()
