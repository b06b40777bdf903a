"""Build the CUDA kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` into ``build/kernels/<digest>/lib<name>.so`` next to the
package (``<digest>`` hashes the sources and flags, so an edited source
rebuilds), then loaded with ``ctypes``. All sources compile in parallel,
one ``nvcc`` process each. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = (
    "flash_attention", "fused_attention", "fused_attention_bwd", "fused_attention_int8",
    "fused_head", "fused_mlp_int8",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)
    ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_ROOT, _digest(), f"lib{name}.so")


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no library for the current digest,
    all ``nvcc`` processes at once; returns ``{name: compiler output}``
    for what was built. Raises with the compiler's output on failure."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    todo = [n for n in SOURCES if not os.path.exists(os.path.join(out_dir, f"lib{n}.so"))]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs: List[tuple] = []
    for name in todo:
        # write to a per-process temp name, then rename: a concurrent build
        # of the same digest never sees a half-written library
        tmp = os.path.join(out_dir, f"lib{name}.so.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, tmp, proc))
    logs: Dict[str, str] = {}
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, os.path.join(out_dir, f"lib{name}.so"))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def timed_build(ptxas_verbose: bool = False) -> tuple:
    """``build_all`` with its wall time in seconds: ``(seconds, logs)``."""
    t0 = time.perf_counter()
    logs = build_all(ptxas_verbose)
    return time.perf_counter() - t0, logs
