#!/usr/bin/env python3
"""Times ``chip_smoke.py`` phase functions of several checkouts of the
PyTorch port in turns on one card, each tree in a process of its own.

    python3 scripts/torch_kernel_ab.py TREE [TREE ...] \\
        --phase qkv_attention:flagship:float32 --phase flash:tiled:bfloat16

Each TREE is a directory that holds ``chip_smoke.py`` and
``clip_ebc_tpu_torch/``: ``.`` for this checkout, or a ``git archive`` of
another commit unpacked under a git-ignored directory such as ``build/``.
The trees run in the order given, so ``parent . . parent`` times in turns.
A phase is ``NAME[:ARG...]`` for ``chip_smoke.phase_NAME(device, *args)``;
``float32`` and ``bfloat16`` are passed as those torch dtypes, digits as
ints, ``true`` and ``false`` as booleans, ``flagship``, ``long_windows``
and ``vit_l14`` as the launch shapes ``chip_smoke.FLAGSHIP``, ``LONG_WINDOWS``
and ``VIT_L14`` (the phases that run at both widths take one), and
``kernels`` as an
empty table of the kernels' launch counts (the path phases fill it in), so
``--phase main_path:kernels:false`` times a path without the profiler.
Each tree builds its own kernels into its own ``build/``.
Prints each run's phase output under a header; exits 1 if any run failed
or outlasted ``--timeout``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_CHILD = r"""
import collections
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from clip_ebc_tpu_torch.ops import _build

if not torch.cuda.is_available():
    sys.exit("CUDA is not available")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
dev = torch.device("cuda", 0)

def arg(a):
    if a in ("float32", "bfloat16"):  # not "short", which torch also names a dtype
        return getattr(torch, a)
    if a.isdigit():
        return int(a)
    if a in ("flagship", "long_windows", "vit_l14"):
        return getattr(chip_smoke, a.upper())
    return {"true": True, "false": False, "kernels": collections.defaultdict(dict)}.get(a, a)


for spec in sys.argv[1:]:
    name, *args = spec.split(":")
    getattr(chip_smoke, "phase_" + name)(dev, *map(arg, args))
"""


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--phase", action="append", required=True)
    parser.add_argument("--timeout", type=float, default=None, help="seconds a turn may take")
    args = parser.parse_args(argv)
    failed = 0
    for i, tree in enumerate(args.trees):
        print(f"=== turn {i + 1}: {os.path.abspath(tree)}", flush=True)
        try:
            rc = subprocess.run([sys.executable, "-c", _CHILD, *args.phase], cwd=tree,
                                timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            print(f"=== turn {i + 1} failed with exit code {rc}", flush=True)
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
