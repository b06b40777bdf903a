"""Count-bin tables, dataset names, ImageNet constants and the experiment
config.

Copies of ``clip_ebc_tpu/config.py``'s ``get_bins_and_anchors``,
``SPLIT_SIZES``, normalization constants and ``ExperimentConfig`` (less
its TPU mesh field); the bin tables are copies of the JSON assets under
``clip_ebc_tpu_torch/configs/reduction_{8,16,32}.json``, keyed
``[truncation][dataset]{bins, anchor_points}[granularity]``. Bins whose
upper edge is the string ``"inf"`` are open-ended.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Tuple

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

_DATASET_ALIASES = {
    "sha": ("sha", "shanghaitech_a"),
    "shb": ("shb", "shanghaitech_b"),
    "qnrf": ("qnrf", "ucf_qnrf", "ucf-qnrf"),
    "nwpu": ("nwpu", "nwpu_crowd", "nwpu-crowd"),
    "jhu": ("jhu", "jhu_crowd", "jhu_crowd_v2"),
}

# Split cardinalities, checked when a dataset is opened.
SPLIT_SIZES = {
    "sha": {"train": 300, "val": 182},
    "shb": {"train": 400, "val": 316},
    "qnrf": {"train": 1201, "val": 334},
    "nwpu": {"train": 3109, "val": 500, "test": 1500},
    "jhu": {"train": 2772, "val": 1600},
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


@dataclasses.dataclass
class ExperimentConfig:
    """Full training/eval configuration: the JAX package's field set and
    defaults (the reference's argparse flags)."""

    # Model
    model: str = "vgg19_ae"
    input_size: int = 448
    reduction: int = 8
    regression: bool = False
    truncation: Optional[int] = 4
    anchor_points: str = "average"  # "average" | "middle"
    prompt_type: str = "word"  # "word" | "number"
    granularity: str = "fine"
    num_vpt: int = 32
    vpt_drop: float = 0.0
    shallow_vpt: bool = False

    # Dataset
    dataset: str = "shb"
    batch_size: int = 8
    num_crops: int = 1
    min_scale: float = 1.0
    max_scale: float = 2.0
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.0
    kernel_size: int = 5
    saltiness: float = 1e-3
    spiciness: float = 1e-3
    jitter_prob: float = 0.2
    blur_prob: float = 0.2
    noise_prob: float = 0.5

    # Evaluation
    sliding_window: bool = False
    stride: Optional[int] = None
    window_size: Optional[int] = None
    resize_to_multiple: bool = False
    zero_pad_to_multiple: bool = False

    # Loss
    weight_count_loss: float = 1.0
    count_loss: str = "mae"  # "mae" | "mse" | "dmcount"

    # Optimizer (Adam)
    lr: float = 1e-4
    weight_decay: float = 1e-4

    # LR schedule
    warmup_epochs: int = 50
    warmup_lr: float = 1e-6
    T_0: int = 5
    T_mult: int = 2
    eta_min: float = 1e-7

    # Training
    total_epochs: int = 2600
    eval_start: int = 50
    eval_freq: int = 1
    save_freq: int = 5
    save_best_k: int = 3
    amp: bool = False  # bf16 compute, fp32 parameters
    num_workers: int = 4
    seed: int = 42

    # Paths
    data_root: str = "data"
    ckpt_dir: Optional[str] = None

    # Resolved at runtime (not CLI flags)
    bins: Optional[List[Tuple[float, float]]] = None
    bin_anchors: Optional[List[float]] = None

    def normalize(self) -> "ExperimentConfig":
        """The reference trainer's post-parse flag coupling: regression
        nulls the bins; sliding-window eval defaults window_size/stride to
        input_size; bins/anchors come from the JSON tables otherwise; the
        checkpoint directory name encodes the config."""
        cfg = dataclasses.replace(self)
        cfg.dataset = standardize_dataset_name(cfg.dataset)
        if cfg.regression:
            cfg.truncation = None
            cfg.bins = None
            cfg.bin_anchors = None
        else:
            if cfg.truncation is None:
                raise ValueError("truncation is required for classification models")
            cfg.bins, cfg.bin_anchors = get_bins_and_anchors(
                reduction=cfg.reduction,
                truncation=cfg.truncation,
                dataset=cfg.dataset,
                granularity=cfg.granularity,
                anchor_points=cfg.anchor_points,
            )
        if cfg.resize_to_multiple and cfg.zero_pad_to_multiple:
            raise ValueError("cannot use both resize_to_multiple and zero_pad_to_multiple")
        if cfg.sliding_window:
            if cfg.window_size is None:
                cfg.window_size = cfg.input_size
            if cfg.stride is None:
                cfg.stride = cfg.input_size
        if cfg.ckpt_dir is None:
            tag = (
                f"{cfg.model}_{cfg.input_size}_{cfg.reduction}_{cfg.truncation}"
                f"_{cfg.granularity}_{cfg.weight_count_loss}_{cfg.count_loss}"
            )
            cfg.ckpt_dir = os.path.join("checkpoints", cfg.dataset, tag)
        return cfg
