"""Training batches: counterpart of ``clip_ebc_tpu/data/loader.py``
(``Batch``, ``pad_points``, ``make_train_transforms``,
``make_eval_transforms``, ``TrainLoader``).

Ragged point lists become a dense ``(B, P_max, 2)`` tensor plus a
``(B, P_max)`` validity mask, so every step has the same shapes; the
density map is block-summed to the output reduction on the host. Items
are decoded and augmented by a pool of threads, each from its own seed
drawn up front, so the batches do not depend on thread timing and equal
the JAX loader's from the same seed. Under data parallelism rank
``host_id`` of ``num_hosts`` loads its own shard of every epoch's
permutation, as each host of the JAX loader does. The JAX loader's process
pool (``num_workers > 0``) is not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, fields
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from . import transforms as T
from .density import block_sum


@dataclass
class Batch:
    """One training batch of CPU tensors (move it with :meth:`to`).

    images:  (B, H, W, 3) float32, ImageNet-normalized
    points:  (B, P_max, 2) float32, padded with zeros
    point_mask: (B, P_max) bool, True where the point is real
    density: (B, H/r, W/r) float32 block-summed dot map
    """

    images: torch.Tensor
    points: torch.Tensor
    point_mask: torch.Tensor
    density: torch.Tensor

    @property
    def gt_counts(self) -> torch.Tensor:
        return self.point_mask.sum(1).float()

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(**{f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
                        for f in fields(self)})


def pad_points(point_lists: Sequence[np.ndarray], max_points: int) -> tuple:
    """Pad a list of (N_i, 2) arrays to (B, max_points, 2) + mask; points
    beyond ``max_points`` are dropped (the first ones kept)."""
    batch = len(point_lists)
    out = np.zeros((batch, max_points, 2), dtype=np.float32)
    mask = np.zeros((batch, max_points), dtype=bool)
    for i, pts in enumerate(point_lists):
        pts = np.asarray(pts, dtype=np.float32).reshape(-1, 2)
        n = min(len(pts), max_points)
        out[i, :n] = pts[:n]
        mask[i, :n] = True
    return out, mask


def make_train_transforms(cfg) -> T.Compose:
    """The train augmentation stack: RandomResizedCrop -> HFlip ->
    RandomApply[ColorJitter, GaussianBlur, PepperSaltNoise]."""
    return T.Compose(
        [
            T.RandomResizedCrop(
                (cfg.input_size, cfg.input_size), scale=(cfg.min_scale, cfg.max_scale)
            ),
            T.RandomHorizontalFlip(0.5),
            T.RandomApply(
                [
                    T.ColorJitter(cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue),
                    T.GaussianBlur(cfg.kernel_size),
                    T.PepperSaltNoise(cfg.saltiness, cfg.spiciness),
                ],
                p=[cfg.jitter_prob, cfg.blur_prob, cfg.noise_prob],
            ),
        ]
    )


def make_eval_transforms(cfg):
    """Eval pre-shaping for sliding-window evaluation."""
    if not cfg.sliding_window:
        return None
    if cfg.resize_to_multiple:
        return T.Resize2Multiple(cfg.window_size, cfg.stride)
    if cfg.zero_pad_to_multiple:
        return T.ZeroPad2Multiple(cfg.window_size, cfg.stride)
    return None


class TrainLoader:
    """Shuffled, prefetching train loader: ``Batch``es of ``batch_size``
    crops, ``dataset.num_crops`` from each image, flattened into the batch
    dimension; the last partial batch of an epoch is dropped. With
    ``num_hosts`` > 1 the epoch's permutation is cut to a multiple of
    ``num_hosts`` and this rank takes every ``num_hosts``-th item from
    ``host_id`` on, its item seeds drawn from a stream offset by
    ``host_id`` (the JAX loader's shards); ``max_points`` is sized from the
    whole dataset, so every rank pads to the same shape."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        reduction: int,
        max_points: Optional[int] = None,
        seed: int = 0,
        num_threads: int = 4,
        host_id: int = 0,
        num_hosts: int = 1,
    ) -> None:
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} is outside [0, num_hosts={num_hosts})")
        if batch_size % max(dataset.num_crops, 1):
            raise ValueError(
                f"batch_size {batch_size} must be divisible by num_crops {dataset.num_crops}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.items_per_batch = batch_size // dataset.num_crops
        self.reduction = reduction
        if max_points is None:
            # the OT loss uses every point: pad to the split's largest
            # annotation count, rounded up to a power of two
            n = dataset.max_point_count() if hasattr(dataset, "max_point_count") else 0
            max_points = max(256, 1 << (int(n) - 1).bit_length()) if n else 256
        self.max_points = max_points
        self.seed = seed
        self.num_threads = num_threads
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.epoch = 0
        self._warned_epoch: Optional[int] = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.num_hosts // self.items_per_batch

    def _epoch_indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
        perm = rng.permutation(len(self.dataset))
        usable = len(perm) // self.num_hosts * self.num_hosts  # equal shards
        return perm[:usable][self.host_id::self.num_hosts]

    def __iter__(self) -> Iterator[Batch]:
        indices = self._epoch_indices()
        item_rng = np.random.default_rng(
            (self.seed + 1) * 7_777_777 + self.epoch * 131 + self.host_id)
        # one child seed per item, drawn up front: results do not depend
        # on which thread loads which item
        item_seeds = item_rng.integers(0, 2**63 - 1, size=len(indices))
        n_batches = len(self)
        n_items = min(n_batches * self.items_per_batch, len(indices))
        work: "queue.Queue[int]" = queue.Queue()
        for i in range(n_items):
            work.put(i)
        results: dict = {}
        ready = threading.Condition()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    rng = np.random.default_rng(item_seeds[i])
                    item = self.dataset.__getitem__(int(indices[i]), rng=rng)
                except Exception as e:  # surfaced to the consumer below
                    item = e
                with ready:
                    results[i] = item
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_threads, max(n_items, 1)))]
        for t in threads:
            t.start()
        try:
            for b in range(n_batches):
                items = []
                for i in range(b * self.items_per_batch, min((b + 1) * self.items_per_batch, n_items)):
                    with ready:
                        while i not in results:
                            ready.wait()
                        item = results.pop(i)
                    if isinstance(item, Exception):
                        raise item
                    items.append(item)
                yield self._collate(items)
        finally:
            stop.set()  # an abandoned epoch: the threads take no new item

    def _collate(self, items) -> Batch:
        images = np.concatenate([im for im, _, _ in items], axis=0)
        point_lists = [p for _, pts, _ in items for p in pts]
        dropped = sum(max(0, len(p) - self.max_points) for p in point_lists)
        if dropped and self._warned_epoch != self.epoch:
            self._warned_epoch = self.epoch
            logging.getLogger("clip_ebc_tpu_torch").warning(
                "OT point pad truncation: %d point(s) beyond max_points=%d dropped in a "
                "batch (epoch %d); raise --max_points to cover the densest crops.",
                dropped, self.max_points, self.epoch,
            )
        points, mask = pad_points(point_lists, self.max_points)
        densities = np.concatenate([d for _, _, d in items], axis=0)
        return Batch(
            images=torch.from_numpy(images.astype(np.float32)),
            points=torch.from_numpy(points),
            point_mask=torch.from_numpy(mask),
            density=torch.from_numpy(block_sum(densities, self.reduction).astype(np.float32)),
        )
