"""Logging: counterpart of ``clip_ebc_tpu/utils/logging.py``: the
trainer's text log and its scalar log.

``get_logger`` logs to stdout and a file, or nowhere (the ranks other
than 0). ``MetricWriter`` appends one ``step\\ttag\\tvalue`` line per
scalar to ``{log_dir}/scalars.tsv`` and, when a TensorBoard
``SummaryWriter`` (``torch.utils.tensorboard`` or ``tensorboardX``) is
importable, mirrors the scalars there.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys
from typing import Dict, Optional


def get_logger(log_file: Optional[str] = None, name: str = "clip_ebc_tpu_torch.trainer"
               ) -> logging.Logger:
    """The logger ``name``, writing to stdout and ``log_file``; silent
    without a file. Its handlers are replaced on every call (a process may
    run the trainer more than once)."""
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    log.propagate = False
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    fmt = logging.Formatter("%(asctime)s %(message)s")
    handlers = ((logging.StreamHandler(sys.stdout), logging.FileHandler(log_file))
                if log_file else (logging.NullHandler(),))
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


class MetricWriter:
    """Append-only scalar log: one ``step\\ttag\\tvalue`` line per scalar
    (the value as ``%.8g``), mirrored to TensorBoard when a writer is
    importable."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, "scalars.tsv"), "a")
        self._tb = None
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(log_dir)
                break
            except Exception:
                continue

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for tag, value in scalars.items():
            self._file.write(f"{step}\t{tag}\t{float(value):.8g}\n")
            if self._tb is not None:
                self._tb.add_scalar(tag, float(value), step)
        self._file.flush()

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
