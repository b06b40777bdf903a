"""Cross-image window packing for sliding-window evaluation: counterpart of
``clip_ebc_tpu/ops/packed_eval.py`` (``WindowPacker``,
``packed_predict_densities``).

Windows of consecutive images share fixed-size forward batches. Each
image's window count is padded to a multiple of ``chunk`` by repeating
its last window; its windows are gathered straight into a staging buffer
of ``2 x batch_windows`` slots (``ops.sliding_window.gather_windows_at``),
and whenever the first ``batch_windows`` slots are full one forward runs
on them and the rest moves down. An image's density map is assembled
(``ops.sliding_window.assemble_windows``) from the forward outputs its
windows span once the batch holding its last window has run, and outputs
no pending image needs are dropped. So every forward has the same batch
whatever the images' sizes, and the padding is under ``chunk`` windows an
image, plus the unfilled tail of the batch a flush runs.

The JAX module keeps its jitted programs in module-level caches because
``jax.jit`` compiles per function object. Eager torch compiles nothing,
so this module has no program cache. On one CUDA stream the gather of the
next image into slots the running forward reads, and the shift of the
buffer, are ordered after that forward.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .sliding_window import _check_blocks, assemble_windows, gather_windows_at, window_grid


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class WindowPacker:
    """Streams images through a shared fixed-size window-batch forward.

    ``forward`` maps a ``(batch_windows, wh, ww, C)`` batch to
    ``(batch_windows, wh/r, ww/r)`` densities. Feed ``(H, W, C)`` images
    with :meth:`add`; :meth:`ready` yields ``(image_hw, density)`` in
    submission order for every image whose windows have all been through
    a forward. Call :meth:`flush` after the last image.
    """

    def __init__(
        self,
        forward: Callable[[torch.Tensor], torch.Tensor],
        window: Tuple[int, int],
        stride: Tuple[int, int],
        reduction: int,
        strategy: str = "average",
        batch_windows: int = 128,
        chunk: int = 16,
        dtype: Optional[torch.dtype] = None,  # None: the first image's dtype
    ) -> None:
        if batch_windows % chunk:
            raise ValueError("batch_windows must be a multiple of chunk")
        self.forward = forward
        self.window = tuple(window)
        self.stride = tuple(stride)
        self.reduction = reduction
        self.strategy = strategy
        self.W = batch_windows
        self.C = chunk
        self._dtype = dtype
        self._buf: Optional[torch.Tensor] = None  # (2W, wh, ww, C), from the first add()
        self._fill = 0  # filled slots, a multiple of C
        self._stream_pos = 0  # the stream's next slot
        self._outputs: dict = {}  # batch index -> its (W, bh, bw) densities
        self._batch_idx = 0  # batches run so far
        self._pending: deque = deque()  # (image_hw, first slot, windows), in order

    def _run_batch(self) -> None:
        preds = self.forward(self._buf[: self.W])
        _check_blocks(preds, self.window, self.reduction)
        self._outputs[self._batch_idx] = preds
        self._batch_idx += 1
        self._buf[: self.W] = self._buf[self.W:]
        self._fill = max(self._fill - self.W, 0)  # 0 after a flush's tail

    def add(self, image: torch.Tensor) -> None:
        """Queue one ``(H, W, C)`` image; its windows go into the staging
        buffer now, and every batch they fill runs."""
        h, w = int(image.shape[0]), int(image.shape[1])
        starts = window_grid((h, w), self.window, self.stride)
        n = starts.shape[0]
        n_pad = _round_up(n, self.C)
        if n_pad != n:  # repeat the last window; those slots are never collected
            starts = np.concatenate([starts, np.repeat(starts[-1:], n_pad - n, axis=0)])
        if self._buf is None:
            self._buf = torch.zeros((2 * self.W, *self.window, image.shape[2]),
                                    dtype=self._dtype or image.dtype, device=image.device)
        self._pending.append(((h, w), self._stream_pos, n))
        for j0 in range(0, n_pad, self.W):  # at most W slots at a time: they fit behind _fill
            n_seg = min(self.W, n_pad - j0)
            self._buf[self._fill:self._fill + n_seg] = gather_windows_at(
                image, starts[j0:j0 + n_seg], self.window)
            self._fill += n_seg
            while self._fill >= self.W:
                self._run_batch()
        self._stream_pos += n_pad

    def flush(self) -> None:
        """Run the partly filled batch (its stale tail slots are never
        collected). The stream realigns to the batch boundary, so
        :meth:`add` works after a flush."""
        if self._fill:
            self._run_batch()
        self._stream_pos = self._batch_idx * self.W

    def ready(self) -> Iterator[Tuple[Tuple[int, int], torch.Tensor]]:
        """Yield ``(image_hw, density)`` for every queued image whose
        windows have all been through a forward, in submission order."""
        while self._pending:
            image_hw, base, n = self._pending[0]
            if base + n > self._batch_idx * self.W:
                return
            self._pending.popleft()
            b0, b1 = base // self.W, (base + n - 1) // self.W
            batches = [self._outputs[b] for b in range(b0, b1 + 1)]
            stacked = batches[0] if len(batches) == 1 else torch.cat(batches)
            start = base - b0 * self.W
            density = assemble_windows(stacked[start:start + n], image_hw, self.window,
                                       self.stride, self.reduction, self.strategy)
            # images leave in order: a batch before the oldest pending
            # image's first one is needed by no one
            floor = self._pending[0][1] // self.W if self._pending else b1 + 1
            for b in [b for b in self._outputs if b < floor]:
                del self._outputs[b]
            yield image_hw, density


def packed_predict_densities(
    forward: Callable[[torch.Tensor], torch.Tensor],
    images: Iterable[torch.Tensor],
    window: Tuple[int, int],
    stride: Tuple[int, int],
    reduction: int,
    strategy: str = "average",
    batch_windows: int = 128,
    chunk: int = 16,
    dtype: Optional[torch.dtype] = None,
) -> Iterator[torch.Tensor]:
    """Density maps of ``(H, W, C)`` images, in order, their windows packed
    across images into ``batch_windows``-sized forward batches. With
    ``dtype=None`` each image's own dtype goes through the forward, as on
    the per-image path."""
    packer = WindowPacker(forward, window, stride, reduction, strategy, batch_windows, chunk,
                          dtype)
    for image in images:
        packer.add(image)
        for _, density in packer.ready():
            yield density
    packer.flush()
    for _, density in packer.ready():
        yield density
