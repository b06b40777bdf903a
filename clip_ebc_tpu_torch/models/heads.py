"""Prediction-head math: counterpart of ``clip_ebc_tpu/models/heads.py``
(``expectation_from_logits``; the Classifier/Regressor heads of the
non-CLIP models are a later slice)."""

from __future__ import annotations

import torch


def expectation_from_logits(logits: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis . anchors, in fp32: ``(..., N) -> (...)``."""
    probs = torch.softmax(logits.float(), dim=-1)
    return (probs * anchor_points.float()).sum(-1)
