"""Per-image count prediction and dataset evaluation: counterpart of
``clip_ebc_tpu/training/evaluate.py`` ``Evaluator`` (``predict_density``,
``predict_count``, ``_pad_image``) and ``evaluate``.

The model holds its own weights, so the methods take no variables
argument. A CLIP-EBC model's prompt features are constant per weight
set: they are encoded once and reused until a text-tower parameter
changes (a new tensor or an in-place load). A model without a text tower
(the Classifier and Regressor heads) is called as ``model(windows)``.
In a process group every rank evaluates the same image and the sliding
windows are split over the ranks (``ops.sliding_window``), as the JAX
Evaluator shards them on its mesh; a whole image runs on every rank.
Every rank must then evaluate, in the same order. Packed eval and the decode pool are later slices.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..config import IMAGENET_MEAN, IMAGENET_STD
from ..ops.sliding_window import sliding_window_predict


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

    @torch.inference_mode()
    def predict_density(self, image: np.ndarray) -> torch.Tensor:
        """``(H, W, 3)`` normalized image -> ``(H/r, W/r)`` fp32 density on
        the model's device."""
        image, (h, w) = self._pad_image(image)
        nh, nw = image.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device)
        text = self.text_features()

        def forward(windows: torch.Tensor) -> torch.Tensor:
            out = self.model(windows) if text is None else self.model(windows, text_feats=text)
            return out.float()

        if self.sliding_window:
            density = sliding_window_predict(
                forward, x, self.window, self.stride, self.reduction, self.strategy
            )
        else:
            density = forward(x[None])[0]
        if (nh, nw) != (h, w):
            density = density[: h // self.reduction, : w // self.reduction]
        return density

    def predict_count(self, image: np.ndarray) -> float:
        return float(self.predict_density(image).sum())

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


def evaluate(evaluator: Evaluator, dataset) -> Dict[str, float]:
    """MAE and RMSE of the total counts over a labeled dataset (one crop,
    eval transforms), with the model in eval mode. A background thread
    decodes up to two images ahead while the device works, and the count of image
    i is read on the host only after image i + 1 is dispatched."""
    evaluator.model.eval()
    n = len(dataset)
    q: "queue.Queue" = queue.Queue(maxsize=2)
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
    abs_sum = sq_sum = 0.0
    pending = None  # (device count, ground truth)
    try:
        for i in range(n + 1):
            item = q.get() if i < n else None
            if isinstance(item, Exception):
                raise item
            if pending is not None:
                diff = float(pending[0]) - pending[1]
                abs_sum += abs(diff)
                sq_sum += diff * diff
            pending = None if item is None else (evaluator.predict_density(item[0]).sum(), item[1])
    finally:
        stop.set()
    if n == 0:
        return {"mae": float("nan"), "rmse": float("nan")}
    return {"mae": abs_sum / n, "rmse": math.sqrt(sq_sum / n)}
