#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``clip_ebc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each a hard failure (a raised exception, exit code 1):

0. the card: ``nvidia-smi`` name and power limit; no CUDA -> exit 1;
1. build the CUDA kernels from ``clip_ebc_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print the build time and ptxas resource use;
2. every kernel of the flagship path against its plain PyTorch version on
   the card, at the flagship shapes, with inputs from a seed: max abs
   error within the stated tolerance; kernel and plain times (CUDA events,
   median of 20 after warm-up) beside the least time the card could take;
3. the flagship path through the user's entry point: the predict CLI on a
   seeded 2048 x 3072 image (140 windows of 224 px at stride 224), CLIP-EBC
   ViT-B/16 with deep VPT-32 at reduction 8, random weights from a seed,
   bf16 (``--amp``); then the CLI's default fp32 path on the same image.
   For each, the launch counters are zeroed just before and read just
   after: 12 attention launches and 1 head launch per forward. Then,
   through the Evaluator, the same weights with ``attn_backend="sdpa"``,
   ``fused_head="off"`` (no kernel) must give the count within 1e-2 in
   bf16 and 1e-3 in fp32; the time per image is measured for both paths
   and set beside the image's bound (its matmul and convolution FLOP,
   counted by ``FlopCounterMode`` on the plain path, over the card's peak).

The last lines are the card line, one JSON line describing every kernel
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX. With
``--profile`` it also prints the device time of one kernel-path forward by
CUDA kernel (torch.profiler).
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W):
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, HBM bytes/s.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12

B, L, D, H = 140, 229, 768, 12  # flagship trunk launch: 140 windows x (1 + 32 + 196) tokens
IMAGE_HW = (2048, 3072)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(flops: float, peak_flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build() -> None:
    from clip_ebc_tpu_torch.ops import _build

    secs, logs = _build.timed_build(ptxas_verbose=True)
    print(f"build: {secs:.1f} s for {len(logs)} source(s) -> {_build.BUILD_ROOT}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_attention(dev, dtype: torch.dtype) -> dict:
    """The attention kernel of one activation dtype against its plain
    version: bf16 (the tensor-core kernels, tolerance 2e-2: both round at
    the same points, summing in another order) or fp32 (the fp32 variant,
    tolerance 1e-4: fp32 throughout)."""
    from clip_ebc_tpu_torch.ops.fused_attention import fused_ln_qkv_attention, ln_qkv_attention_plain

    fp32 = dtype == torch.float32
    tol, peak, tag = (1e-4, PEAK_FP32, " fp32") if fp32 else (2e-2, PEAK_BF16, "")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, L, D, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(D, generator=g, device=dev)
    w = (torch.randn(3 * D, D, generator=g, device=dev) * D**-0.5).to(dtype)
    bias = 0.02 * torch.randn(3 * D, generator=g, device=dev)
    sm = (D // H) ** -0.5
    errs = {}
    for kv_len in (L, 200):
        got = fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, H, kv_len, sm)
        want = ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, H, kv_len, sm)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"attention kernel returned {got.dtype}, expected {dtype}")
        err = (got[:, :kv_len].float() - want[:, :kv_len].float()).abs().max().item()
        print(f"attention{tag} kernel vs plain, kv_len={kv_len}: max abs err {err:.3e} (tol {tol:g})")
        check(math.isfinite(err) and err <= tol,
              f"attention{tag} kernel disagrees (kv_len={kv_len})")
        errs[kv_len] = err
    ms = time_ms(lambda: fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, H, L, sm))
    plain = time_ms(lambda: ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, H, L, sm))
    m, es = B * L, x.element_size()
    flops = 2 * m * D * 3 * D + 2 * 2 * B * H * L * L * (D // H)
    nbytes = m * D * es * 2 + 3 * D * D * es + 2 * D * 4 + 3 * D * 4
    bnd, by = bound_ms(flops, peak, nbytes)
    print(f"attention{tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {
        "name": "fused_ln_qkv_attention" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541",
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def phase_head(dev) -> dict:
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.ops.fused_head import ebc_head_plain, fused_ebc_head

    _, anchors = get_bins_and_anchors(8, 4, "qnrf")
    n, c, k = B * 28 * 28, 512, len(anchors)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(n, c, generator=g, device=dev).to(torch.bfloat16)
    text = torch.randn(k, c, generator=g, device=dev)
    scale = torch.tensor(1 / 0.07, device=dev)
    anch = torch.tensor(anchors, device=dev)
    got = fused_ebc_head(feats, text, scale, anch)
    want = ebc_head_plain(feats, text, scale, anch)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    close = torch.allclose(got, want, rtol=1e-4, atol=1e-6)
    print(f"head kernel vs plain: max abs err {err:.3e} (rtol 1e-4, atol 1e-6): {close}")
    check(close, "head kernel disagrees with its plain version")
    ms = time_ms(lambda: fused_ebc_head(feats, text, scale, anch))
    plain = time_ms(lambda: ebc_head_plain(feats, text, scale, anch))
    flops = n * (3 * c + 2 * k * c + 6 * k)
    nbytes = n * c * 2 + k * c * 4 + k * 4 + 4 + n * 4
    bnd, by = bound_ms(flops, PEAK_FP32, nbytes)
    print(f"head: kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound {bnd * 1e3:.1f} us "
          f"({by}); {nbytes / ms / 1e6:.0f} GB/s")
    return {
        "name": "fused_ebc_head", "route": "cuda", "source": "clip_ebc_tpu_torch/csrc/fused_head.cu",
        "replaces": "clip_ebc_tpu/ops/fused_head.py:70", "max_abs_err": err, "ms": ms,
        "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def time_image(evaluator, image, reps: int = 5) -> float:
    """Median wall ms of one image (upload, windows, forward, assembly,
    count on the host) after one warm-up."""
    evaluator.predict_count(image)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.predict_count(image)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_cli(img_dir: str, out: str, amp: bool) -> tuple:
    """The predict CLI on ``img_dir`` (flagship flags; bf16 with ``amp``,
    else the CLI's default fp32), with the launch counters zeroed just
    before and read just after: ``(count, launches)``."""
    from clip_ebc_tpu_torch.cli import predict
    from clip_ebc_tpu_torch.ops.fused_attention import fused_ln_qkv_attention
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head

    argv = [img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
            "--num_vpt", "32", "--sliding_window", "--window_size", "224", "--stride", "224",
            "--seed", "0", "--out", out] + (["--amp"] if amp else [])
    fused_ln_qkv_attention.launches = 0
    fused_ebc_head.launches = 0
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"fused_ln_qkv_attention": fused_ln_qkv_attention.launches,
                "fused_ebc_head": fused_ebc_head.launches}
    mode = "bf16 (--amp)" if amp else "fp32 (default)"
    print(f"predict CLI, {mode}: {cli_s:.1f} s (model build, weights, one image); "
          f"launches {launches}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"CSV has {len(rows)} rows")
    count = float(rows[0]["count"])
    check(math.isfinite(count), f"CLI count {count} is not finite")
    check(launches["fused_ln_qkv_attention"] == 12,
          f"{mode}: expected 12 attention launches per forward")
    check(launches["fused_ebc_head"] == 1, f"{mode}: expected 1 head launch per forward")
    return count, launches


def image_flops(evaluator, image) -> tuple:
    """FLOP of one image's forward on the plain path (matmuls, convolutions:
    torch's FlopCounterMode; the text features are already cached): the
    total and ``{submodule of the model: FLOP}``."""
    from torch.utils.flop_counter import FlopCounterMode

    # the counter's module tracker hooks the autograd graph of every input
    # that requires grad, which an inference forward (no graph) has none of
    evaluator.model.requires_grad_(False)
    counter = FlopCounterMode(display=False)
    with counter:
        evaluator.predict_count(image)
    parts = {name: float(sum(ops.values())) for name, ops in counter.get_flop_counts().items()
             if name.count(".") == 1}
    return float(counter.get_total_flops()), parts


def phase_main_path(dev, kernels: dict, profile: bool) -> None:
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.ops.sliding_window import window_grid
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    n_win = len(window_grid(IMAGE_HW, (224, 224), (224, 224)))
    check(n_win == B, f"expected {B} windows, grid has {n_win}")
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        # the flagship path (bf16), then the CLI's default (fp32) path
        cli_count, launches = run_cli(img_dir, os.path.join(tmp, "counts.csv"), amp=True)
        kernels["fused_ln_qkv_attention"]["launches"] = launches["fused_ln_qkv_attention"]
        kernels["fused_ebc_head"]["launches"] = launches["fused_ebc_head"]
        cli32_count, launches32 = run_cli(img_dir, os.path.join(tmp, "counts32.csv"), amp=False)
        kernels["fused_ln_qkv_attention_fp32"]["launches"] = launches32["fused_ln_qkv_attention"]
        image = normalize_image(_load_image(path))

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")

    def evaluator(dtype=torch.bfloat16, **paths):
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=dtype,
                          num_vpt=32, seed=0, device=dev, **paths)
        return Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                         pad_to_multiple=16)

    fast = evaluator()
    density = fast.predict_density(image)
    check(tuple(density.shape) == (IMAGE_HW[0] // 8, IMAGE_HW[1] // 8),
          f"density shape {tuple(density.shape)}")
    check(bool(torch.isfinite(density).all()), "density has non-finite values")
    count = float(density.sum())
    plain = evaluator(attn_backend="sdpa", fused_head="off")
    plain_count = plain.predict_count(image)
    rel = abs(count - plain_count) / abs(plain_count)
    print(f"count: kernels {count:.4f}, plain path {plain_count:.4f}, CLI {cli_count:.2f}; "
          f"|diff|/count {rel:.2e} (tol 1e-2)")
    check(rel <= 1e-2, "kernel path and plain path disagree on the count")
    check(abs(cli_count - count) <= 1e-2 * abs(count), "CLI count differs from the Evaluator's")

    # fp32: the kernel path (the CLI's count) against the plain path, the
    # fp32 slice tolerance
    plain32 = evaluator(torch.float32, attn_backend="sdpa", fused_head="off")
    plain32_count = plain32.predict_count(image)
    rel32 = abs(cli32_count - plain32_count) / abs(plain32_count)
    print(f"fp32 count: kernels (CLI) {cli32_count:.2f}, plain path {plain32_count:.4f}; "
          f"|diff|/count {rel32:.2e} (tol 1e-3)")
    check(rel32 <= 1e-3, "fp32 kernel path and plain path disagree on the count")

    ms = time_image(fast, image)
    plain_ms = time_image(plain, image)
    flops, parts = image_flops(plain, image)
    bnd = flops / PEAK_BF16 * 1e3
    print(f"flagship image {IMAGE_HW[0]}x{IMAGE_HW[1]} ({B} windows): kernels {ms:.2f} ms/image "
          f"({B / ms * 1e3:.0f} windows/s); plain path {plain_ms:.2f} ms/image "
          f"({B / plain_ms * 1e3:.0f} windows/s); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    print(f"flagship image bound: {flops / 1e12:.3f} TFLOP of matmuls and convolutions "
          f"(FlopCounterMode, plain path) / {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 = {bnd:.2f} ms; "
          f"kernel path at {ms / bnd:.1f}x the bound; by part: "
          + ", ".join(f"{k} {v / 1e12:.3f}" for k, v in parts.items()))
    del plain32
    fast32 = evaluator(torch.float32)
    ms32 = time_image(fast32, image)
    print(f"flagship image, fp32 (no --amp): kernels {ms32:.2f} ms/image; bound "
          f"{flops / PEAK_FP32 * 1e3:.2f} ms at {PEAK_FP32 / 1e12:.0f} TFLOP/s fp32")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            fast.predict_count(image)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = [phase_attention(dev, torch.bfloat16), phase_attention(dev, torch.float32),
               phase_head(dev)]
    phase_main_path(dev, {k["name"]: k for k in kernels}, "--profile" in argv)
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path was never launched")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
