"""Count-bin tables and ImageNet constants.

Copies of ``clip_ebc_tpu/config.py``'s ``get_bins_and_anchors`` and
normalization constants; the bin tables are copies of the JSON assets
under ``clip_ebc_tpu_torch/configs/reduction_{8,16,32}.json``, keyed
``[truncation][dataset]{bins, anchor_points}[granularity]``. Bins whose
upper edge is the string ``"inf"`` are open-ended.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Tuple

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

_DATASET_ALIASES = {
    "sha": ("sha", "shanghaitech_a"),
    "shb": ("shb", "shanghaitech_b"),
    "qnrf": ("qnrf", "ucf_qnrf", "ucf-qnrf"),
    "nwpu": ("nwpu", "nwpu_crowd", "nwpu-crowd"),
    "jhu": ("jhu", "jhu_crowd", "jhu_crowd_v2"),
}

# ImageNet normalization applied to all inputs.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def standardize_dataset_name(dataset: str) -> str:
    """Map any accepted dataset alias to its canonical short name."""
    name = dataset.lower()
    for canonical, aliases in _DATASET_ALIASES.items():
        if name in aliases:
            return canonical
    known = tuple(a for aliases in _DATASET_ALIASES.values() for a in aliases)
    raise ValueError(f"Dataset {dataset!r} is not available; expected one of {known}")


def get_bins_and_anchors(
    reduction: int,
    truncation: int,
    dataset: str,
    granularity: str = "fine",
    anchor_points: str = "average",
) -> Tuple[List[Tuple[float, float]], List[float]]:
    """Load the count bins and per-bin anchor values for one configuration.

    Returns ``(bins, anchors)``: bins as ``(low, high)`` with
    ``high == math.inf`` for the open last bin, one anchor per bin.
    """
    path = os.path.join(_CONFIG_DIR, f"reduction_{reduction}.json")
    if not os.path.exists(path):
        raise ValueError(f"No bin table for reduction={reduction} (missing {path})")
    with open(path) as f:
        table = json.load(f)
    t_key = str(truncation)
    if t_key not in table:
        raise ValueError(
            f"truncation={truncation} not in reduction_{reduction}.json "
            f"(available: {sorted(table.keys())})"
        )
    ds = standardize_dataset_name(dataset)
    if ds not in table[t_key]:
        raise ValueError(
            f"dataset={ds} not available for reduction={reduction}, "
            f"truncation={truncation} (available: {sorted(table[t_key].keys())})"
        )
    entry = table[t_key][ds]
    if granularity not in entry["bins"]:
        raise ValueError(
            f"granularity={granularity!r} not available "
            f"(available: {sorted(entry['bins'].keys())})"
        )
    if anchor_points not in entry["anchor_points"][granularity]:
        raise ValueError(
            f"anchor_points={anchor_points!r} not available "
            f"(available: {sorted(entry['anchor_points'][granularity].keys())})"
        )
    anchors = [float(a) for a in entry["anchor_points"][granularity][anchor_points]]
    bins = [
        (float(lo), math.inf if hi == "inf" else float(hi))
        for lo, hi in entry["bins"][granularity]
    ]
    if len(bins) != len(anchors):
        raise ValueError(
            f"bins and anchor_points length mismatch: {len(bins)} vs {len(anchors)}"
        )
    for (lo, hi), a in zip(bins, anchors):
        if not (lo <= a <= hi):
            raise ValueError(f"anchor {a} outside its bin ({lo}, {hi})")
    return bins, anchors
