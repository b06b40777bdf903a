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
   median of 20 after warm-up; the attention kernels and their PyTorch
   yardsticks by device time, ``time_spread``, with the spread over 7
   groups of back-to-back calls) beside the least time the card could
   take; the LN + attention kernel's two launches also timed apart in
   both dtypes; the masked attention from a packed qkv held to its plain
   version at a window forward, a calibration batch with masked keys, one
   valid key, 320 and 77 tokens, and timed at a calibration batch (16) and
   at a window forward's batch (140), each beside the SDPA forward on the
   same views, in fp32 at 140 also beside the fp32 short flash kernel;
3. the flagship path through the user's entry point: the predict CLI on a
   seeded 2048 x 3072 image (140 windows of 224 px at stride 224), CLIP-EBC
   ViT-B/16 with deep VPT-32 at reduction 8, random weights from a seed,
   bf16 (``--amp``); then the CLI's default fp32 path on the same image.
   For each, the launch counters are zeroed just before and read just
   after: 12 attention launches and 1 head launch per forward, and in bf16
   12 launches of the LN + QKV projection kernel (phase 2 holds the head
   to its plain version with bf16 and fp32 features and times it beside a
   bare read of the same rows). Then,
   through the Evaluator, the same weights with ``attn_backend="sdpa"``,
   ``fused_head="off"`` (no kernel) must give the count within 1e-2 in
   bf16 and 1e-3 in fp32; the time per image is measured for both paths
   and set beside the image's bound (its matmul and convolution FLOP,
   counted by ``FlopCounterMode`` on the plain path, over the card's peak).
3b. the W8A8 path through the same entry point: the predict CLI with
   ``--amp --quant int8_static`` on the same image, in full (calibration
   on the image's first 16 windows through a dynamic twin, then static
   inference), then ``--amp --quant int8`` (dynamic), then ``--quant
   int8_static`` in fp32. Counters zeroed just before, read just after: 12
   launches of the int8 LN + projection + attention kernel per static
   forward, 12 of the qkv-attention kernel per calibration batch and per
   dynamic forward. Then, through the Evaluator with one set of calibrated
   scales, the kernel path against the plain path (``attn_backend="sdpa"``,
   ``fused_head="off"``) within 1e-2 of the count, no zero leaf in the
   quant state, and ms per image of int8_static and int8 beside the
   unquantized bf16 path, the calibration time and the count's distance
   from bf16 (a slower int8 path is printed, not failed). Before it, in
   phase 2: both new kernels against their plain versions (max abs error
   within 2e-2 and median within 1e-3 of the largest magnitude in bf16;
   tighter in fp32), the int8 decoder convolution's accumulators on the
   card equal to the plain int32 convolution's, and the times of its two
   routes and of the trunk's int8 products beside their bf16 twins. The
   int8 LN + QKV projection alone (the first launch of rows 2b and 2c) is
   held to its plain version with both epilogues (qkv in the activation
   dtype, int8 q, k, v) in bf16 and fp32 and timed by device time beside
   ``torch._int_mm`` on the bare int8 product (a yardstick: no PyTorch
   call computes the fused function); its launches are counted on the
   static int8 path (12 a forward). The bf16 LN + QKV projection alone
   (``ebc_ln_qkv_proj``, row 2's first launch and row 5's recompute) is
   held to ``ln_qkv_proj_plain`` at a window forward (140 x 229 rows) and a
   training step (16 x 229) and timed by device time beside ``F.linear``
   on the bare bf16 product (a yardstick); the int8 attention body alone
   (``ebc_int8_attention``, the attention launch of rows 2c and 2d) is
   held to its static and dynamic plain versions at 140 x 229 and 70 x 433
   tokens with bf16 and fp32 output, and timed beside its bound; its
   launches are counted on the ``--quant_attn kernel`` path (12 a forward).
4. the flagship training path through the user's entry point: the trainer
   CLI with the README's flagship flags (CLIP-EBC ViT-B/16, deep VPT-32,
   reduction 8, DACE + DMCount, 8 images x 2 crops = 16 windows of 224 px
   a step) on a synthetic ``qnrf`` dataset written from a seed (32 train
   images, so one epoch is 4 steps, and 2 val images of 512 x 768), one
   epoch and one sliding-window evaluation, random weights from a seed;
   bf16 (``--amp``), then fp32. Counters zeroed just before, read just
   after: 12 backward launches per step (``ln_qkv_bwd_frozen`` in bf16,
   the fp32 ``attention_bwd`` in fp32), and in bf16 one LN + QKV
   projection launch per forward and per frozen backward. The loss is finite, the trunk and
   text tower are bit-identical to the initial weights, the prompts and
   the decoder moved, and the best checkpoint loads into the predict CLI.
   Then, on one fixed batch, the step's VPT and decoder gradients against
   the plain path's (``attn_backend="sdpa"``): relative L2 <= 1e-3 in
   fp32, <= 5e-2 in bf16 (printed beside the plain path's own bf16-vs-fp32
   error). Phase 2 times the frozen backward's three launches apart
   (recompute, attention backward, dy + LayerNorm backward), and holds the
   last (``ebc_ln_bwd_dx``) alone to its plain version on unit rows and on
   rows of mean 50 +- 0.1, timed beside ``torch.mm(d_qkv, W)``; its
   launches are counted on this path (12 a step). Then ms per
   step, windows/s and peak memory
   (medians of 5 steps after 2 warm-up, in turns: plain, kernels,
   kernels, plain) beside the step's bound (forward
   + backward FLOP of the plain path by ``FlopCounterMode`` over the
   card's peak), the kernel path and the plain path of each dtype timed in
   the same call.
4b. the non-CLIP models through the same entry points: first row 2 at
   the plain ViT's LayerNorm eps 1e-6 (197 tokens, 140 and 8 windows; it
   must miss its eps-1e-5 plain version) and its split backward with a
   trainable LayerNorm, projection and bias against plain autograd (dx,
   dgamma, dbeta, dW, db within 2e-2 bf16 / 1e-4 fp32 of their largest
   magnitudes); then the trainer CLI for one epoch on a synthetic ``shb``
   dataset (32 images of 512 x 768): ``vgg19_ae`` with the README's
   first train command (448 px crops, batch 8) in bf16 and fp32,
   ``--regression`` in bf16, a plain ``vit_b_16`` Classifier at 224 px in
   bf16 and fp32 (12 launches of row 2 a forward, 12 of row 4 a step
   through the split backward, none of row 5); every parameter moves and
   each best checkpoint serves through the predict CLI. The predict CLI
   serves ``vgg19_ae`` whole on the 2048 x 3072 image and ``vit_b_16`` by
   140 windows of 197 tokens (12 launches of row 2), in bf16 and fp32,
   and the NWPU CLI two images with ``vgg19_ae``. Then ``vgg19_ae``'s ms
   per image and per training step (CUDA events around
   ``Trainer.train_step`` and the host clock beside, median of 5) with
   peak memory, beside the ``FlopCounterMode`` bound (and, with
   ``--profile``, the step's device idle share); and ``vit_b_16``'s count
   by windows and step gradients against its plain twin
   (``attn_backend="sdpa"``): 1e-2 / 1e-3 of the count, relative L2
   5e-2 / 1e-3 over every parameter's gradient (bf16 / fp32). The launches
   of rows 2 and 4 on these paths go into their rows of the kernels line
   as ``launches_vit_serve`` and ``launches_vit_train``.
4c. the other CLIP backbones through the same entry points: row 1 at C =
   640, 768 and 1024 against its plain version; CLIP-EBC ``clip_resnet50``
   by the predict CLI on the 2048 x 3072 image whole and by 224 px windows
   (bf16, fp32; one head launch, no trunk kernel), the NWPU CLI on two
   images, the trainer CLI at the reference's run.sh flags (448 px crops,
   batch 8, reduction 8, ``word`` prompts, SHA bins) on a synthetic ``sha``
   dataset in bf16 and fp32 (every parameter but the text tower's moves,
   the BatchNorm statistics too) with each best checkpoint served, and its
   ms per whole image and per step (CUDA events, the host clock beside;
   ``--profile``: the step's idle share) with peak memory beside the
   ``FlopCounterMode`` bound; RN101, RN50x4, RN50x16, RN50x64 and
   ViT-B/32 on one batch of 16 windows against their plain twins (ViT-B/32:
   12 launches of row 2), and a 4-step ViT-B/32 VPT epoch (12 launches of
   row 5 a step); ``clip_vit_l_14`` by the predict CLI by windows (140 x 289
   tokens at D = 1024: 24 launches of row 2 a forward, the rows
   ``fused_ln_qkv_attention_d1024`` of the kernels line, which phase 2
   holds to their plain versions at that shape) in bf16 and fp32 and whole
   in bf16 (24 tiled launches at 16 heads; row 8 alone at that shape), its
   count by windows against its plain twin (1e-2 bf16, 1e-3 fp32); and
   ``clip_vit_l_14_336px`` by 336 px windows (609 tokens: the plain route,
   as in the JAX package).
4d. ViT-L/14 trains and ViT-L and the CLIP ResNets serve W8A8
   (``phase_vit_l``): the trainer CLI with the flagship flags on
   ``clip_vit_l_14`` (16 windows of 224 px, 289 tokens, D = 1024, 16
   heads) for an epoch of ``VIT_L_STEPS`` steps in bf16 and fp32 (24
   launches of row 5 a bf16 step, ``ln_bwd_dx`` at D = 1024 among them; 24
   of row 4 a fp32 step); the step's gradients on one batch against the
   plain path (the same model switched in place, as ``_set_plain`` does),
   ms per step in turns and peak memory; the predict CLI on the flagship
   image by 140 windows under ``--quant int8_static`` (24 launches of the
   int8 projection a forward), ``--quant_attn kernel`` (24 of the int8
   attention) and ``xla``, ``--quant int8`` (24 of row 3) and
   unquantized, with their counts against each other (kernel vs xla 2e-2,
   each 8e-2 of bf16), one set of calibrated scales and the ``int8``
   model against their plain twins (1e-2) and ms per image;
   ``clip_resnet50`` by windows under ``--quant int8_static`` (its
   Bottleneck decoder in int8) beside bf16. Phase 2 holds every kernel
   widened to D = 1024 to its plain version at ViT-L's shapes by the same
   phase functions as at D = 768, each given the launch shape
   (``VIT_L14``; ``phase_kernels_d1024``: rows 5 dx, 5, 4 in both dtypes,
   the int8 projection, 2b, 2c also at 70 x 433 tokens, the int8 body, 2d,
   6 and its second launch, the scale pass, and row 3 at 140 and 16 x 289
   tokens in both dtypes), each row named with ``_d1024``.
4e. data parallel (``phase_data_parallel``): the flagship bf16 VPT step
   (16 windows) under ``DistributedDataParallel`` in a group of one rank
   over NCCL, joined through ``parallel/mesh.py`` (the CLI's
   ``initialize_distributed`` is a no-op for one process): 12 launches of
   rows 2, 4, 5 and 5 dx a step under DDP's hooks, ms per step and peak
   memory. Then two ranks sharing the card over gloo, spawned (this
   process holds a CUDA context), each loading the kernels phase 1 built
   and sending its counters and results back as one JSON line, against
   one process on the same global batches: the flagship VPT step at 16
   windows (8 a rank; 2 steps, bf16 and fp32: the prompt and decoder
   gradients within phase 4's 5e-2 / 1e-3 relative L2, the losses too,
   the same launches a rank), ``clip_resnet50`` at its run.sh flags (8
   crops of 448 px, 4 a rank; one fp32 step: every synced BatchNorm
   statistic within 1e-4 relative L2), and the flagship image by 140
   windows (70 a rank, gathered by one all-reduce; bf16 and fp32: the
   count within phase 3's 1e-2 / 1e-3, one head launch a rank). ms per
   step of one NCCL rank and of the two ranks, and each process's peak
   memory, are printed beside the card line. Two ranks on one card show
   that the path is right, not that it scales. A rank's failure, non-zero
   exit or silence past its time limit fails the run. The ranks also pack
   phase 4f's stream into batches of 128 windows (64 a rank, gathered by
   one all-reduce a batch), bf16 and fp32: the counts within phase 3's
   limits of one process's, three forwards and three head launches a
   rank, and a batch of 120 windows raises.
4f. cross-image window packing and the process pools
   (``phase_packing``): a stream of 8 seeded JPEGs (2048x3072, 768x1024,
   512x768, 1024x768, 384x512, 1536x2048, 640x896, 448x448: 284 windows
   of 224 px at stride 224, 352 slots in chunks of 16) through the predict
   CLI with ``--packed_eval --batch_windows 128`` (three forwards, the
   third a flush) and per image (eight), ViT-B/16 deep VPT-32, in bf16
   and fp32: counters zeroed just before and read just after, 12 launches
   of row 2 (and in bf16 of the LN + QKV projection) and 1 of the head a
   forward; each image's count from its saved density, packed against per
   image, within 1e-2 (bf16) and 1e-3 (fp32). The same stream under
   ``--quant int8_static --quant_attn`` in bf16: two calibration batches
   (24 launches of row 3), then 12 launches of the int8 attention a
   forward; counts within 2e-2. The NWPU CLI by windows (stride 112, 54
   windows an image) on phase 3d's tree with ``--packed_eval
   --batch_windows 48`` (three forwards of 48) against its per-image run:
   the submission lines within 1e-2. Then, through the Evaluator, the
   stream packed with no host read between images (the host runs ahead of
   the forwards) against per image, and images/s of both by CUDA events
   around the whole stream (the host clock beside; in turns per image,
   packed, packed, per image) with peak device memory, in both dtypes.
   Then the loader pool on phase 4's synthetic dataset at the flagship
   flags: epoch 1's first batch from 2 worker processes bit-equal to 4
   threads'; items/s of the loader alone with 4 threads and 2, 4 and 8
   processes beside the host's core count; the device idle share of a
   profiled 4-step bf16 epoch with the threads and with 2 processes; and
   the trainer CLI for one epoch with ``--loader_procs 2`` (12 launches
   of row 5 a step). No speed-up is claimed.

4g. pretrained checkpoints (``phase_pretrained``): a seeded full-width
   OpenAI-layout CLIP ViT-B/16 (149.6 M numbers, fp16, as a TorchScript
   archive) through ``python -m clip_ebc_tpu_torch.cli.prepare --src ...
   --no-verify`` (its six files); the predict CLI on the flagship image by
   windows in bf16 with ``--pretrained`` of the archive and of the
   prepared ``clip_vit_b_16.npz`` (``--allow_byte_tokenizer``: no BPE
   vocab here), deterministic algorithms on for the two runs (the
   windows' overlap-average is an ``index_add_``): densities bit-equal, 12
   launches of row 2 and 1 of row 1 each; the same weights loaded here
   into a model on the plain path and one on the kernel path, each
   tower tensor the file's cast to fp32, the counts within phase 3's 1e-2,
   ms per image of both; the NWPU CLI with ``--pretrained`` on phase 3d's
   images (the JAX CLI's file name, ``clip_ViT-B-16.pt.txt``; 24 tiled
   launches); the trainer CLI at the flagship flags from the ``.npz`` for 2
   epochs of 2 steps with ``--profile_dir`` (rows 1, 2, 4, 5 launched; the
   trunk and text tower still the file's; ``scalars.tsv`` with ``train/*``
   at steps 1 and 2; one trace, of epoch 2); a torchvision VGG19 with its
   FC layers into ``vgg19_ae`` and one step at 448 px; the times of each,
   with the card line.

Phase 2 also holds rows 1, 2 (bf16 and fp32), 2b and 2c at the packed
path's launches, 128 and 48 windows of 229 tokens (``phase_packed_shapes``:
the same phase functions and tolerances as at 140, the results under
``at_b`` in the row of the 140-window launch, the packed path's launches
under ``launches_packed`` and ``launches_packed_b48``).

Phase 2 also holds both flash-attention kernels against their plain
versions, in bf16 and fp32: the tiled kernel at the flagship full image
(1, 12, 24609, 64) and on a ragged causal sequence, the short kernel at
the windows' shape (140, 12, 229, 64), at the text tower's, causal, and
at 320, 321 and 512 keys; limits 2e-2 x max|want| in bf16 and 1e-4 in
fp32; times beside the SDPA forward and the bound.
3c. full-image inference through the same entry point: the predict CLI
   without ``--sliding_window`` on the same 2048 x 3072 image (one
   sequence of 1 + 32 + 128 x 192 = 24,609 tokens), bf16 (``--amp``) and
   fp32. Counters zeroed just before, read just after: 12 tiled flash
   launches per image, none of the fused kernel, 1 head launch. Then ms per
   image (median of 5 in bf16, of 2 in fp32) and peak device memory beside
   the image's bound (matmul and convolution FLOP by ``FlopCounterMode`` on
   the kernel path plus the attention's 4 L^2 64 per head and layer); the
   kernel path against the plain path (``attn_backend="sdpa"``) at 1024 x
   1536, where the plain path's (L, L) scores fit, within 1e-2 (bf16) and
   1e-3 (fp32) of the count; and the flagship windows and the text tower
   through ``attn_backend="flash"`` (12 short launches each), whose count
   agrees with the fused kernel path within the same limits, with ms per
   image of both paths in both dtypes.
3d. the NWPU entry point: ``cli/test_nwpu.py`` on a synthetic 2-image
   ``nwpu/test/images`` tree it writes (768 x 1024 and 1024 x 768 JPEGs),
   bf16, with a weights file of the seeded model: 24 tiled launches, the
   submission file's format, and counts equal to the predict CLI's on the
   same images and weights.
3e. the fully int8 attention through the same entry point: the predict CLI
   on the flagship image by windows with ``--quant int8_static
   --quant_attn`` in bf16 and fp32 (12 launches of the int8 attention
   kernel per forward, none of the float one) and ``--quant_attn xla`` in
   bf16 (no attention kernel on the static forward). Then, through the
   Evaluator on one set of calibrated scales, ms per image of both modes
   beside ``int8_static`` without ``--quant_attn`` and the unquantized
   bf16 path, all in this call; the kernel and xla counts within 2e-2 of
   each other (the JAX package's tolerance between the two modes) and each
   count within 8e-2 of the bf16 count (its int8 tolerance). Then the
   predict CLI with ``--window_size 320 --stride 320 --quant int8_static
   --quant_attn`` and ``--quant_attn xla`` in bf16 (70 windows of 433
   tokens, past the float kernels' 320): 12 launches of the int8 attention
   kernel per forward, and the two counts within 2e-2 of each other. Before
   it, in phase 2: the int8 attention on calibrated scales (static; also at
   70 windows of 433 tokens) and on
   dynamic per-tile scales, and the W8A8 MLP (QuickGELU in bf16 and fp32,
   the tanh GELU once), each against its plain version at the flagship
   shapes (max 2e-2 and median 1e-3 of the largest output; the MLP's
   median 1e-4 in fp32), timed beside the bound and the plain version; the
   MLP's two launches also apart (launch 1, the LN + int8 fc + GELU +
   quantize; launch 2, ``int8_gemm_residual``, held bit-equal to its plain
   version and timed beside ``torch._int_mm`` on the bare product), and
   the dynamic scale pass alone (``qkv_quant_dynamic``, bit-equal to its
   plain version, beside its byte bound). The dynamic branch and the MLP
   are on no path of the package (the JAX package calls them from its
   tests only): every CLI run of phases 3-4 zeroes their counters with its
   own and fails if one moved; their rows carry the sum over those runs, 0.

5. the kernels behind the PyTorch yardsticks of the redesigned rows (the
   SDPA forward at the windows' shape, in fp32 at a calibration batch and
   in bf16 at the whole image; the SDPA backward at the training shape),
   named by torch.profiler after every timing, in a spawned process of
   its own: after phase 4f's (or ``--profile``'s) traces, a trace in this
   process records no device time.

``phase_path_ms`` is run by ``scripts/torch_kernel_ab.py`` only: ms per
image of the flagship windows in bf16 and under ``--quant int8``, and of
the bf16 training step's forward, for a tree beside its parent.

The last lines are the card line, one JSON line describing every kernel
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX. With
``--profile`` it also prints the device time of one kernel-path forward
and of one training step (bf16 and fp32, on the kernel path and on the
plain path) by CUDA kernel (torch.profiler), with the step's device idle
share.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W):
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, HBM bytes/s.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_INT8 = 1979e12  # int8 tensor-core OP/s, dense



class Shape(NamedTuple):
    """A trunk launch: b windows of l tokens, width d, h heads of 64."""

    b: int
    l: int  # noqa: E741 - the token count, as in every formula here
    d: int
    h: int


# the flagship trunk launch: 140 windows x (1 + 32 + 196) tokens
FLAGSHIP = Shape(140, 229, 768, 12)
# a ViT-L/14 window forward: 140 windows x (1 + 32 + 256) tokens, D = 1024, 16 heads
VIT_L14 = Shape(140, 289, 1024, 16)
# the flagship's, read by the phases that run at it only; a phase that runs
# at both widths takes its Shape as an argument
B, L, D, H = FLAGSHIP
IMAGE_HW = (2048, 3072)
# flagship training step: 8 images x 2 crops of 224 px; a synthetic dataset
# of 32 train images (4 steps an epoch) and 2 val images of 512 x 768
TRAIN_SIZE, TRAIN_B, TRAIN_IMAGES, DATA_HW = 224, 16, 32, (512, 768)
CALIB_B = 16  # windows of one calibration batch (the first 16 of an image)
# the flagship image run whole: 1 CLS + 32 prompts + its 128 x 192 patch grid
FULL_L = 1 + 32 + (IMAGE_HW[0] // 16) * (IMAGE_HW[1] // 16)
PLAIN_HW = (1024, 1536)  # the largest image whose plain-path (L, L) scores fit in fp32
# --window_size 320 --stride 320 on the flagship image: 7 x 10 windows of
# 1 + 32 + 20 x 20 tokens, past the float kernels' 320 keys
LONG_WINDOW = 320
LONG_L = 1 + 32 + (LONG_WINDOW // 16) ** 2
LONG_B = math.ceil((IMAGE_HW[0] - LONG_WINDOW) / LONG_WINDOW + 1) * math.ceil(
    (IMAGE_HW[1] - LONG_WINDOW) / LONG_WINDOW + 1)
LONG_WINDOWS = FLAGSHIP._replace(b=LONG_B, l=LONG_L)
# the packed path's launches (--batch_windows 128, the default, and 48): rows
# 1, 2, 2b and 2c are held to their plain versions at these window counts too
PACKED_B = (128, 48)
# kernels on no path of the package (the JAX package calls these TPU kernels
# from its tests only): checked and timed in phase 2, launched 0 times
OFF_PATH = ("int8_attention_dynamic", "int8_attention_dynamic_fp32", "fused_ln_mlp_int8",
            "fused_ln_mlp_int8_fp32", "int8_gemm_residual", "int8_gemm_residual_fp32",
            "qkv_quant_dynamic", "qkv_quant_dynamic_fp32")
# their launches over every CLI run of phases 3-4 (both dtypes), by name
# without "_fp32": read into their rows of the kernels line
OFF_PATH_LAUNCHES: dict = {}


def _off_path_counters(reset: bool = False) -> dict:
    """The launch counters of the ``OFF_PATH`` kernels, zeroed with
    ``reset``; every CLI run zeroes them with its own counters."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    names = {"int8_attention_dynamic": (fa.fused_ln_qkv_attention_int8, "launches_dynamic"),
             "fused_ln_mlp_int8": (fa.fused_ln_mlp_int8, "launches"),
             "int8_gemm_residual": (fa.int8_gemm_residual, "launches"),
             "qkv_quant_dynamic": (fa.qkv_quant_dynamic, "launches")}
    if reset:
        for f, attr in names.values():
            setattr(f, attr, 0)
    return {k: getattr(f, attr) for k, (f, attr) in names.items()}


def _tally_off_path(tag: str) -> None:
    """Adds the ``OFF_PATH`` kernels' launches of the CLI run just ended
    to ``OFF_PATH_LAUNCHES``; no CLI path runs them, so each must be 0."""
    n = _off_path_counters()
    for k, v in n.items():
        OFF_PATH_LAUNCHES[k] = OFF_PATH_LAUNCHES.get(k, 0) + v
    check(not any(n.values()), f"{tag}: a kernel of no path was launched: {n}")


def train_flags() -> list:
    """The README's flagship training flags."""
    size = str(TRAIN_SIZE)
    return ["--model", "clip_vit_b_16", "--dataset", "qnrf", "--input_size", size,
            "--reduction", "8", "--truncation", "4", "--num_vpt", "32", "--prompt_type", "word",
            "--count_loss", "dmcount", "--batch_size", str(TRAIN_B), "--num_crops", "2",
            "--sliding_window", "--window_size", size, "--stride", size, "--warmup_lr", "1e-3"]


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


def time_spread(fn, reps: int = 7) -> tuple:
    """Device ms of one ``fn()`` as ``(median, lo, hi)`` over ``reps`` groups
    of back-to-back calls (CUDA events around each group, divided by its
    size; a group takes about 5 ms of device time, 10 to 400 calls).
    ``torch.cuda._sleep`` holds the card before each group for twice the
    host's time to queue it, so the host's launch overhead (tens of us a
    call through Python, as much as a call at a calibration batch) stays
    out of the time and only the device's remains."""
    est = time_ms(fn, iters=5, warmup=2)
    host = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
    n = max(10, min(400, math.ceil(5.0 / max(est, 1e-3))))
    per_call = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(n * host * 4e9))  # cycles: twice the queueing time at ~2 GHz
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call), min(per_call), max(per_call)


def spread_str(t: tuple) -> str:
    return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"


def bound_ms(flops: float, peak_flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build() -> None:
    from clip_ebc_tpu_torch.ops import _build

    secs, logs = _build.timed_build(ptxas_verbose=True)
    print(f"build: {secs:.1f} s for {len(logs)} source(s) -> {_build.BUILD_ROOT}")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "arning")):
                print(f"  ptxas {name}: {line.strip()}")


def phase_attention(dev, dtype: torch.dtype, s: Shape = FLAGSHIP) -> dict:
    """The attention kernel of one activation dtype at the launch ``s``
    against its plain version: bf16 (the tensor-core kernels, tolerance
    2e-2: both round at the same points, summing in another order) or fp32
    (the fp32 variant, tolerance 1e-4: fp32 throughout)."""
    from clip_ebc_tpu_torch.ops.fused_attention import fused_ln_qkv_attention, ln_qkv_attention_plain

    fp32 = dtype == torch.float32
    b, l, d, h = s  # noqa: E741
    tol, peak = (1e-4, PEAK_FP32) if fp32 else (2e-2, PEAK_BF16)
    tag = (" fp32" if fp32 else "") + (f" at B = {b}" if s != FLAGSHIP else "")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, l, d, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(d, generator=g, device=dev)
    w = (torch.randn(3 * d, d, generator=g, device=dev) * d**-0.5).to(dtype)
    bias = 0.02 * torch.randn(3 * d, generator=g, device=dev)
    sm = (d // h) ** -0.5
    errs = {}
    for kv_len in (l, 200):
        got = fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, h, kv_len, sm)
        want = ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, h, kv_len, sm)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"attention kernel returned {got.dtype}, expected {dtype}")
        err = (got[:, :kv_len].float() - want[:, :kv_len].float()).abs().max().item()
        print(f"attention{tag} kernel vs plain, kv_len={kv_len}: max abs err {err:.3e} (tol {tol:g})")
        check(math.isfinite(err) and err <= tol,
              f"attention{tag} kernel disagrees (kv_len={kv_len})")
        errs[kv_len] = err
    ms = time_ms(lambda: fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, h, l, sm))
    plain = time_ms(lambda: ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, h, l, sm))
    m, es = b * l, x.element_size()
    flops = 2 * m * d * 3 * d + 2 * 2 * b * h * l * l * (d // h)
    nbytes = m * d * es * 2 + 3 * d * d * es + 2 * d * 4 + 3 * d * 4
    bnd, by = bound_ms(flops, peak, nbytes)
    print(f"attention{tag}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    _time_launches(x, ln_w, ln_b, w, bias, sm, h)
    return {
        "name": "fused_ln_qkv_attention" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541",
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def _time_launches(x, ln_w, ln_b, w, bias, sm, h: int) -> tuple:
    """Row 2's two launches apart (device time, ``time_spread``): the
    LayerNorm + projection (``ebc_ln_qkv_proj`` in bf16,
    ``ebc_ln_qkv_proj_f32`` in fp32) and the attention body on its qkv
    (``fused_qkv_attention``, the same launch)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    b, l, d = x.shape
    qkv = torch.empty(b, l, 3 * d, dtype=x.dtype, device=x.device)
    name = "ebc_ln_qkv_proj_f32" if x.dtype == torch.float32 else "ebc_ln_qkv_proj"
    proj = fa._entry("fused_attention", name)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run_proj():
        fa._run(name, proj(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
                           bias.data_ptr(), qkv.data_ptr(), b * l, d, 1e-5, stream))

    run_proj()
    proj_ms = time_spread(run_proj)
    attn_ms = time_spread(lambda: fa.fused_qkv_attention(qkv, h, l, sm))
    proj_flops, attn_flops = 2 * b * l * d * 3 * d, 2 * 2 * b * h * l * l * (d // h)
    tag = "fp32" if x.dtype == torch.float32 else "bf16"
    print(f"attention {tag} by launch at B = {b}, L = {l}, D = {d}: {name} {spread_str(proj_ms)} "
          f"({proj_flops / proj_ms[0] / 1e9:.1f} TFLOP/s), attention body {spread_str(attn_ms)} "
          f"({attn_flops / attn_ms[0] / 1e9:.1f} TFLOP/s)")
    return proj_ms[0], attn_ms[0]


def phase_attention_vit_l(dev, dtype: torch.dtype) -> dict:
    """Row 2 at ViT-L's width and heads (K1 / K2: the bf16 / fp32 LN + QKV
    projection at D = 1024; K3: the attention body at 16 heads and a row
    pitch of 3 x 1024) at a ViT-L window forward (140 x 289 tokens),
    against its plain version at kv_len 289 and 250: max abs error 2e-2
    (bf16) or 1e-4 (fp32), as ``phase_attention``. Then each launch alone:
    the projection through its C entry against ``ln_qkv_proj_plain`` (max
    2e-2 and median 1e-3 of the largest output in bf16, as
    ``phase_ln_qkv_proj``; 1e-4 and 1e-5 in fp32), the body through
    ``fused_qkv_attention`` against ``qkv_attention_plain`` (2e-2 / 1e-4);
    device times beside the bounds of this shape and, for the body, the
    SDPA forward on the same head views (a yardstick, timed here only)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    fp32 = dtype == torch.float32
    b, l, d, h = VIT_L14
    tol, peak, tag = (1e-4, PEAK_FP32, " fp32") if fp32 else (2e-2, PEAK_BF16, "")
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(b, l, d, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(d, generator=g, device=dev)
    w = (torch.randn(3 * d, d, generator=g, device=dev) * d**-0.5).to(dtype)
    bias = 0.02 * torch.randn(3 * d, generator=g, device=dev)
    sm = 64**-0.5
    errs = []
    for kv_len in (l, 250):
        got = fa.fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, h, kv_len, sm)
        want = fa.ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, h, kv_len, sm)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"D = 1024 attention returned {got.dtype}, expected {dtype}")
        err = (got[:, :kv_len].float() - want[:, :kv_len].float()).abs().max().item()
        print(f"attention{tag} at D = {d}, {h} heads, {b} x {l} tokens, kv_len={kv_len}: kernel vs "
              f"plain max abs err {err:.3e} (tol {tol:g})")
        check(math.isfinite(err) and err <= tol, f"attention{tag} at D = {d} disagrees (kv_len={kv_len})")
        errs.append(err)
        del got, want
    qkv = torch.empty(b, l, 3 * d, dtype=dtype, device=dev)
    name = "ebc_ln_qkv_proj_f32" if fp32 else "ebc_ln_qkv_proj"
    entry = fa._entry("fused_attention", name)
    fa._run(name, entry(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
                        bias.data_ptr(), qkv.data_ptr(), b * l, d, 1e-5, fa._stream(dev)))
    torch.cuda.synchronize()
    errs.append(_check_max_median(f"{name} at D = {d}, M = {b} x {l}, kernel vs plain", qkv,
                                  fa.ln_qkv_proj_plain(x, ln_w, ln_b, w, bias),
                                  1e-4 if fp32 else 2e-2, 1e-5 if fp32 else 1e-3))
    body = fa.fused_qkv_attention(qkv, h, l, sm)
    want = fa.qkv_attention_plain(qkv, h, l, sm)
    torch.cuda.synchronize()
    err = (body.float() - want.float()).abs().max().item()
    print(f"attention body{tag} alone at {h} heads, pitch {3 * d}: max abs err {err:.3e} (tol {tol:g})")
    check(math.isfinite(err) and err <= tol, f"attention body{tag} at {h} heads disagrees")
    errs.append(err)
    del body, want
    ms = time_ms(lambda: fa.fused_ln_qkv_attention(x, ln_w, ln_b, w, bias, h, l, sm))
    plain = time_ms(lambda: fa.ln_qkv_attention_plain(x, ln_w, ln_b, w, bias, h, l, sm),
                    iters=5, warmup=1)
    proj_ms, attn_ms = _time_launches(x, ln_w, ln_b, w, bias, sm, h)
    q, k, v = (t.reshape(b, l, h, 64).transpose(1, 2) for t in qkv.split(d, dim=-1))
    sdpa = time_spread(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=sm))
    m, es = b * l, x.element_size()
    proj_flops, attn_flops = 2 * m * d * 3 * d, 2 * 2 * b * h * l * l * 64
    nbytes = m * d * es * 2 + 3 * d * d * es + 2 * d * 4 + 3 * d * 4
    bnd, by = bound_ms(proj_flops + attn_flops, peak, nbytes)
    proj_bnd = bound_ms(proj_flops, peak, m * d * es + 3 * d * d * es + m * 3 * d * es)
    attn_bnd = bound_ms(attn_flops, peak, m * 3 * d * es + m * d * es)
    print(f"attention{tag} at D = {d}: kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.3f} ms "
          f"({by}); {(proj_flops + attn_flops) / ms / 1e9:.1f} TFLOP/s; the projection alone "
          f"{proj_ms:.4f} ms against {proj_bnd[0]:.4f} ({proj_bnd[1]}), the body alone "
          f"{attn_ms:.4f} ms against {attn_bnd[0]:.4f} ({attn_bnd[1]}), the SDPA forward on its "
          f"views {spread_str(sdpa)}")
    return {
        "name": "fused_ln_qkv_attention_d1024" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541",
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "proj_ms": proj_ms, "proj_bound_ms": proj_bnd[0], "attn_ms": attn_ms,
        "attn_bound_ms": attn_bnd[0], "sdpa_ms": sdpa[0],
    }


def phase_head(dev, b: int = B) -> dict:
    """The fused head at ``b`` windows x 28 x 28 feature rows (the flagship
    image's 140 by default), C = 512, the QNRF bins' K = 5, with bf16
    (``--amp``) and fp32 features (the CLIs' default), each against its
    plain version (rtol 1e-4, atol 1e-6: all math in fp32 on both sides)
    and timed by device time beside its byte bound and the rate it
    reaches: the wrapper's call (what the path pays) and the C entry
    alone."""
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.ops.fused_head import _lib, ebc_head_plain, fused_ebc_head

    _, anchors = get_bins_and_anchors(8, 4, "qnrf")
    n, c, k = b * 28 * 28, 512, len(anchors)
    g = torch.Generator(device=dev).manual_seed(1)
    text = torch.randn(k, c, generator=g, device=dev)
    scale = torch.tensor(1 / 0.07, device=dev)
    anch = torch.tensor(anchors, device=dev)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:] + (f" at B = {b}" if b != B else "")
        feats = torch.randn(n, c, generator=g, device=dev).to(dtype)
        got = fused_ebc_head(feats, text, scale, anch)
        want = ebc_head_plain(feats, text, scale, anch)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        close = torch.allclose(got, want, rtol=1e-4, atol=1e-6)
        print(f"head {tag} kernel vs plain: max abs err {err:.3e} (rtol 1e-4, atol 1e-6): {close}")
        check(close, f"head kernel ({tag}) disagrees with its plain version")
        ms = time_spread(lambda: fused_ebc_head(feats, text, scale, anch))
        out = torch.empty(n, device=dev)
        entry = _lib().ebc_fused_head
        stream = torch.cuda.current_stream(dev).cuda_stream
        alone = time_spread(lambda: entry(feats.data_ptr(), int(dtype == torch.bfloat16),
                                          text.data_ptr(), anch.data_ptr(), scale.data_ptr(),
                                          out.data_ptr(), n, c, k, stream))
        plain = time_ms(lambda: ebc_head_plain(feats, text, scale, anch))
        norms = time_spread(lambda: torch.linalg.vector_norm(feats, dim=-1))
        flops = n * (3 * c + 2 * k * c + 6 * k)
        nbytes = n * c * feats.element_size() + k * c * 4 + k * 4 + 4 + n * 4
        bnd, by = bound_ms(flops, PEAK_FP32, nbytes)
        print(f"head {tag} ({n} x {c}, K = {k}): the wrapper's call {spread_str(ms)}, "
              f"{nbytes / ms[0] / 1e6:.0f} GB/s; the C entry alone {spread_str(alone)}, "
              f"{nbytes / alone[0] / 1e6:.0f} GB/s; the rows' norms alone "
              f"(torch.linalg.vector_norm, a read of the same bytes) {spread_str(norms)}, "
              f"{nbytes / norms[0] / 1e6:.0f} GB/s; plain {plain:.4f} ms; bound {bnd:.4f} ms "
              f"({by}), the call at {bnd / ms[0]:.0%} of it")
        res[dtype] = dict(err=err, ms=ms[0], alone=alone[0], norms=norms[0], plain=plain,
                          bound=(bnd, by))
        del feats
    r, r32 = res[torch.bfloat16], res[torch.float32]
    return {
        "name": "fused_ebc_head", "route": "cuda", "source": "clip_ebc_tpu_torch/csrc/fused_head.cu",
        "replaces": "clip_ebc_tpu/ops/fused_head.py:70", "max_abs_err": max(r["err"], r32["err"]),
        "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None, "entry_ms": r["alone"], "norms_ms": r["norms"], "ms_fp32": r32["ms"],
        "entry_ms_fp32": r32["alone"], "plain_ms_fp32": r32["plain"],
        "bound_ms_fp32": r32["bound"][0],
    }


def phase_packed_shapes(dev, kernels: dict) -> None:
    """Rows 1, 2 (bf16 and fp32), 2b and 2c (bf16) at the packed path's
    launches, ``PACKED_B`` windows (``--batch_windows`` 128, the default,
    and 48) of 229 tokens, by the same phase functions as at 140 windows:
    each against its plain version at that phase's tolerance and timed
    beside its bound. The results go into the row of the 140-window launch
    as ``at_b``: ``{B: {max_abs_err, ms, plain_ms, bound_ms, bound_by}}``."""
    for b in PACKED_B:
        s = FLAGSHIP._replace(b=b)
        for row in (phase_attention(dev, torch.bfloat16, s), phase_attention(dev, torch.float32, s),
                    phase_head(dev, b), phase_attention_int8(dev, s, torch.bfloat16),
                    phase_int8_attention_q(dev, s, torch.bfloat16, "static")):
            kernels[row["name"]].setdefault("at_b", {})[str(b)] = {
                k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}


def _bwd_inputs(dev, s: Shape, dtype, seed):
    """qkv at the trunk's scale (unit variance after the LN and the
    projection, so the softmax is peaked) and a unit cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(TRAIN_B, s.l, 3 * s.d, generator=g, device=dev).to(dtype)
    gout = torch.randn(TRAIN_B, s.l, s.d, generator=g, device=dev).to(dtype)
    return qkv, gout


def _check_scaled(who: str, got, want, tol: float) -> float:
    """Max abs error of ``got`` against ``want`` within ``tol`` x the
    largest magnitude of ``want``, printed beside that limit."""
    err = (got.float() - want.float()).abs().max().item()
    limit = tol * want.float().abs().max().item()
    print(f"{who}: max abs err {err:.3e} (limit {limit:.3e} = {tol:g} x max|want|)")
    check(math.isfinite(err) and err <= limit, f"{who}: kernel disagrees with its plain version")
    return err


def phase_attention_bwd(dev, s: Shape, dtype: torch.dtype) -> dict:
    """The attention backward at a training step of ``s`` (TRAIN_B windows
    of its tokens) against its plain version: dQ, dK and dV each within 2e-2 (bf16) or 1e-4 (fp32)
    of its own largest magnitude, as in the GPU tests; library yardstick:
    the backward of ``F.scaled_dot_product_attention`` on the same q, k, v
    and g (timed here only)."""
    from clip_ebc_tpu_torch.ops.fused_attention import attention_bwd, attention_bwd_plain

    fp32 = dtype == torch.float32
    tol, peak, tag = (1e-4, PEAK_FP32, " fp32") if fp32 else (2e-2, PEAK_BF16, "")
    qkv, gout = _bwd_inputs(dev, s, dtype, 2)
    sm = (s.d // s.h) ** -0.5
    errs = []
    for kv_len in (s.l, 200):
        got = attention_bwd(qkv, gout, s.h, kv_len, sm)
        want = attention_bwd_plain(qkv, gout, s.h, kv_len, sm)
        torch.cuda.synchronize()
        for i, part in enumerate(("dQ", "dK", "dV")):
            cols = slice(i * s.d, (i + 1) * s.d)
            errs.append(_check_scaled(f"attention_bwd{tag} {part} kernel vs plain, kv_len={kv_len}",
                                      got[..., cols], want[..., cols], tol))
        check(got[:, kv_len:, s.d:].float().abs().sum().item() == 0,
              f"attention_bwd{tag}: masked keys got a gradient")
    ms = time_spread(lambda: attention_bwd(qkv, gout, s.h, s.l, sm))
    plain = time_ms(lambda: attention_bwd_plain(qkv, gout, s.h, s.l, sm))
    q, k, v = (t.reshape(TRAIN_B, s.l, s.h, s.d // s.h).transpose(1, 2).detach().requires_grad_(True)
               for t in qkv.split(s.d, dim=-1))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = gout.reshape(TRAIN_B, s.l, s.h, s.d // s.h).transpose(1, 2)
    library = time_spread(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True))
    es = qkv.element_size()
    flops = 5 * 2 * TRAIN_B * s.h * s.l * s.l * (s.d // s.h)  # S, dP, dQ, dK, dV
    nbytes = TRAIN_B * s.l * (3 * s.d + s.d + 3 * s.d) * es
    bnd, by = bound_ms(flops, peak, nbytes)
    print(f"attention_bwd{tag}: kernel {spread_str(ms)}, plain {plain:.3f} ms, SDPA backward "
          f"{spread_str(library)}, bound {bnd:.4f} ms ({by})")
    ms, library = ms[0], library[0]
    return {
        "name": "attention_bwd" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:360", "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": library,
    }


def phase_ln_qkv_bwd_frozen(dev, s: Shape) -> dict:
    """The frozen LN + QKV + attention backward (bf16) at a training step
    of ``s`` (TRAIN_B windows) against its plain version, tolerance 2e-2 of the
    largest magnitude of dx."""
    from clip_ebc_tpu_torch.ops.fused_attention import ln_qkv_bwd_frozen, ln_qkv_bwd_frozen_plain

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(TRAIN_B, s.l, s.d, generator=g, device=dev).to(torch.bfloat16)
    gout = torch.randn(TRAIN_B, s.l, s.d, generator=g, device=dev).to(torch.bfloat16)
    ln_w = 1.0 + 0.1 * torch.randn(s.d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(s.d, generator=g, device=dev)
    w = (torch.randn(3 * s.d, s.d, generator=g, device=dev) * s.d**-0.5).to(torch.bfloat16)
    bias = 0.02 * torch.randn(3 * s.d, generator=g, device=dev)
    sm = (s.d // s.h) ** -0.5
    args = (x, gout, ln_w, ln_b, w, bias, s.h)
    errs = []
    for kv_len in (s.l, 200):
        got = ln_qkv_bwd_frozen(*args, kv_len, sm)
        want = ln_qkv_bwd_frozen_plain(*args, kv_len, sm)
        torch.cuda.synchronize()
        errs.append(_check_scaled(f"ln_qkv_bwd_frozen kernel vs plain, kv_len={kv_len}",
                                  got, want, 2e-2))
    ms = time_spread(lambda: ln_qkv_bwd_frozen(*args, s.l, sm))
    plain = time_ms(lambda: ln_qkv_bwd_frozen_plain(*args, s.l, sm))
    m = TRAIN_B * s.l
    flops = 2 * (2 * m * s.d * 3 * s.d) + 5 * 2 * TRAIN_B * s.h * s.l * s.l * (s.d // s.h)
    nbytes = 3 * m * s.d * 2 + 3 * s.d * s.d * 2 + (2 * s.d + 3 * s.d) * 4
    bnd, by = bound_ms(flops, PEAK_BF16, nbytes)
    print(f"ln_qkv_bwd_frozen: kernel {spread_str(ms)}, plain {plain:.3f} ms, bound {bnd:.4f} ms "
          f"({by}); {flops / ms[0] / 1e9:.1f} TFLOP/s")
    _time_frozen_launches(s, x, gout, ln_w, ln_b, w, bias, sm)
    ms = ms[0]
    return {
        "name": "ln_qkv_bwd_frozen", "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:627", "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def _time_frozen_launches(s: Shape, x, gout, ln_w, ln_b, w, bias, sm) -> None:
    """Row 5's three launches apart (device time, ``time_spread``): the
    LN + projection recompute, the attention backward and the dy = d_qkv W
    + LayerNorm-backward launch."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    dev, m = x.device, TRAIN_B * s.l
    qkv = torch.empty(TRAIN_B, s.l, 3 * s.d, dtype=torch.bfloat16, device=dev)

    def recompute():
        fa._run("ebc_ln_qkv_proj", fa._entry("fused_attention", "ebc_ln_qkv_proj")(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(), bias.data_ptr(),
            qkv.data_ptr(), m, s.d, 1e-5, fa._stream(dev)))

    recompute()
    dqkv = fa.attention_bwd(qkv, gout, s.h, s.l, sm)
    t = {"recompute (ebc_ln_qkv_proj)": time_spread(recompute),
         "attention backward": time_spread(lambda: fa.attention_bwd(qkv, gout, s.h, s.l, sm)),
         "ebc_ln_bwd_dx": time_spread(lambda: fa.ln_bwd_dx(x, dqkv, ln_w, w))}
    print("ln_qkv_bwd_frozen by launch: " + ", ".join(f"{k} {spread_str(v)}" for k, v in t.items()))


def phase_ln_bwd_dx(dev, s: Shape) -> dict:
    """The frozen backward's last launch alone (``ebc_ln_bwd_dx``: dy =
    d_qkv W, then the LayerNorm backward for dx) at a training step of
    ``s`` (M = 16 x 229 rows, D = 768 at the flagship), on the d_qkv of the attention
    backward at the trunk's scale, against ``ln_bwd_dx_plain`` (the tail of
    ``ln_qkv_bwd_frozen_plain``) within 2e-2 of the largest magnitude of
    dx, as the whole frozen backward is held; also on x with a large row
    mean (50 +- 0.1: a one-pass variance would cancel there). Timed by
    device time beside ``torch.mm(d_qkv, W)``, the bare product (a
    yardstick: no PyTorch call computes the fused function)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(15)
    m = TRAIN_B * s.l
    ln_w = 1.0 + 0.1 * torch.randn(s.d, generator=g, device=dev)
    w = (torch.randn(3 * s.d, s.d, generator=g, device=dev) * s.d**-0.5).to(torch.bfloat16)
    qkv, gout = _bwd_inputs(dev, s, torch.bfloat16, 16)
    dqkv = fa.attention_bwd_plain(qkv, gout, s.h, s.l, (s.d // s.h) ** -0.5).reshape(m, 3 * s.d)
    errs = []
    for tag, x in (("unit rows", torch.randn(m, s.d, generator=g, device=dev)),
                   ("rows of mean 50 +- 0.1", 50 + 0.1 * torch.randn(m, s.d, generator=g, device=dev))):
        x = x.to(torch.bfloat16)
        got = fa.ln_bwd_dx(x, dqkv, ln_w, w)
        torch.cuda.synchronize()
        errs.append(_check_scaled(f"ln_bwd_dx kernel vs plain, {tag}", got,
                                  fa.ln_bwd_dx_plain(x, dqkv, ln_w, w), 2e-2))
    ms = time_spread(lambda: fa.ln_bwd_dx(x, dqkv, ln_w, w))
    library = time_spread(lambda: torch.mm(dqkv, w))
    plain = time_ms(lambda: fa.ln_bwd_dx_plain(x, dqkv, ln_w, w), iters=5, warmup=1)
    flops = 2 * m * 3 * s.d * s.d
    nbytes = m * 3 * s.d * 2 + 3 * s.d * s.d * 2 + 2 * m * s.d * 2 + s.d * 4
    bnd, by = bound_ms(flops, PEAK_BF16, nbytes)
    print(f"ln_bwd_dx at M = {TRAIN_B} x {s.l}: kernel {spread_str(ms)} "
          f"({flops / ms[0] / 1e9:.1f} TFLOP/s), torch.mm(d_qkv, W) {spread_str(library)} "
          f"({flops / library[0] / 1e9:.1f} TFLOP/s), kernel / torch.mm {ms[0] / library[0]:.2f}x; "
          f"plain {plain:.3f} ms; bound {bnd:.4f} ms ({by}), kernel at {bnd / ms[0]:.0%} of it")
    return {
        "name": "ln_bwd_dx", "route": "cuda", "source": "clip_ebc_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:627", "max_abs_err": max(errs),
        "ms": ms[0], "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "mm_ms": library[0],
    }


def _check_max_median(who: str, got, want, max_tol: float, med_tol: float) -> float:
    """Max and median abs error of ``got`` against ``want`` within
    ``max_tol`` / ``med_tol`` x the largest magnitude of ``want``: int8
    rounding turns a last-place difference upstream into a rare one-step
    flip (the max), while a wrong scale or fold moves every entry (the
    median)."""
    diff = (got.float() - want.float()).abs()
    err, med = diff.max().item(), diff.median().item()
    top = want.float().abs().max().item()
    print(f"{who}: max abs err {err:.3e} (limit {max_tol * top:.3e}), median {med:.3e} "
          f"(limit {med_tol * top:.3e})")
    check(math.isfinite(err) and err <= max_tol * top and med <= med_tol * top,
          f"{who}: kernel disagrees with its plain version")
    return err


def phase_attention_int8(dev, s: Shape, dtype: torch.dtype) -> dict:
    """The W8A8 LN + projection + attention kernel at the launch ``s``
    against its plain version, with the static scale a calibration would
    record (the LN output's max-abs). bf16: max 2e-2, median 1e-3 of the
    largest magnitude; fp32: max 2e-3, median 1e-4 (a flipped int8 step of
    the LN output moves qkv by about 5e-5)."""
    from clip_ebc_tpu_torch.ops.fused_attention import (
        fused_ln_qkv_attention_int8, ln_qkv_attention_int8_plain)
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    fp32 = dtype == torch.float32
    max_tol, med_tol, attn_peak, tag = (2e-3, 1e-4, PEAK_FP32, " fp32") if fp32 else (2e-2, 1e-3, PEAK_BF16, "")
    tag += f" at B = {s.b}" if s.b in PACKED_B else ""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(s.b, s.l, s.d, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(s.d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(s.d, generator=g, device=dev)
    w = torch.randn(3 * s.d, s.d, generator=g, device=dev) * s.d**-0.5  # the fp32 master weight
    bias = 0.02 * torch.randn(3 * s.d, generator=g, device=dev)
    y = torch.nn.functional.layer_norm(x.float(), (s.d,), ln_w, ln_b)
    act_scale = y.abs().amax() / 127.0
    del y
    wq = quantize_weight(w)
    sm = (s.d // s.h) ** -0.5
    errs = []
    for kv_len in (s.l, 200):
        got = fused_ln_qkv_attention_int8(x, ln_w, ln_b, w, bias, act_scale, s.h, kv_len, sm)
        want = ln_qkv_attention_int8_plain(x, ln_w, ln_b, *wq, bias, act_scale, s.h, kv_len, sm)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"int8 attention kernel returned {got.dtype}, expected {dtype}")
        errs.append(_check_max_median(f"int8 attention{tag} kernel vs plain, kv_len={kv_len}",
                                      got[:, :kv_len], want[:, :kv_len], max_tol, med_tol))
    ms = time_spread(lambda: fused_ln_qkv_attention_int8(x, ln_w, ln_b, w, bias, act_scale, s.h, s.l, sm,
                                                         quantized=wq))
    plain = time_ms(lambda: ln_qkv_attention_int8_plain(x, ln_w, ln_b, *wq, bias, act_scale, s.h, s.l, sm))
    m, es = s.b * s.l, x.element_size()
    proj_ops, attn_flops = 2 * m * s.d * 3 * s.d, 2 * 2 * s.b * s.h * s.l * s.l * (s.d // s.h)
    nbytes = m * s.d * es * 2 + 3 * s.d * s.d + 2 * s.d * 4 + 2 * 3 * s.d * 4 + 4
    t_ops = (proj_ops / PEAK_INT8 + attn_flops / attn_peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bnd, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    print(f"int8 attention{tag}: kernel {spread_str(ms)}, plain {plain:.3f} ms, bound {bnd:.3f} ms ({by}: "
          f"{proj_ops / 1e9:.1f} GOP int8 + {attn_flops / 1e9:.1f} GFLOP attention)")
    ms = ms[0]
    return {
        "name": "fused_ln_qkv_attention_int8" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_int8.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541", "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def phase_int8_proj(dev, s: Shape, dtype: torch.dtype) -> dict:
    """The int8 LN + quantize + QKV projection alone, the first launch of
    rows 2b and 2c, at the launch ``s`` (M = 140 x 229 rows, D = 768, N
    = 2304 at the flagship) through its C entries: the float epilogue (row 2b: qkv in x's
    dtype) and the int8 one (row 2c: q, k, v with calibrated scales
    folded in), each against the plain projection with the same
    epilogue (max 2e-2 and median 1e-3 of the largest output in bf16 and
    for the int8 outputs, 2e-3 and 1e-4 for fp32 qkv), timed by device
    time beside ``torch._int_mm`` on the bare int8 product (cuBLAS, no
    LayerNorm, quantize or epilogue: a yardstick, no PyTorch call
    computes the fused function)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    fp32 = dtype == torch.float32
    tag = " fp32" if fp32 else ""
    x, ln_w, ln_b, w, bias, act_scale, aq = _int8_attn_inputs(dev, s, dtype, 12)
    w_q, s_col = quantize_weight(w)
    m, n = s.b * s.l, 3 * s.d
    inv_act = (1.0 / act_scale).reshape(1)
    sw_f = s_col * act_scale
    sw_q, bias_q = fa.fold_attn_scales(s_col, bias, act_scale, aq, s.d)
    outs = {"float": torch.empty(m, n, dtype=dtype, device=dev),
            "int8": torch.empty(m, n, dtype=torch.int8, device=dev)}
    entries = {"float": ("ebc_ln_qkv_proj_int8", sw_f, bias),
               "int8": ("ebc_ln_qkv_proj_int8_q", sw_q, bias_q)}

    def run(epi):
        name, sw, bi = entries[epi]
        fa._run(name, fa._entry("fused_attention_int8", name)(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
            bi.data_ptr(), inv_act.data_ptr(), outs[epi].data_ptr(), m, s.d, int(fp32), 1e-5,
            fa._stream(dev)))

    acc = fa._int8_ln_project(x, ln_w, ln_b, w_q, act_scale, 1e-5).reshape(m, n)
    want = {"float": (acc * sw_f + bias.float()).to(dtype),
            "int8": torch.clamp(torch.round(acc * sw_q + bias_q), -127, 127).to(torch.int8)}
    del acc
    errs, ms = [], {}
    for epi in ("float", "int8"):
        run(epi)
        torch.cuda.synchronize()
        max_tol, med_tol = (2e-3, 1e-4) if fp32 and epi == "float" else (2e-2, 1e-3)
        errs.append(_check_max_median(f"int8 projection{tag}, {epi} epilogue, kernel vs plain",
                                      outs[epi], want[epi], max_tol, med_tol))
        ms[epi] = time_spread(lambda epi=epi: run(epi))
    del want
    yq = torch.randint(-127, 128, (m, s.d), dtype=torch.int8, device=dev)
    int_mm = time_spread(lambda: torch._int_mm(yq, w_q.t()))
    ops = 2 * m * s.d * n
    es = x.element_size()
    bounds = {epi: bound_ms(ops, PEAK_INT8, m * s.d * es + m * n * (es if epi == "float" else 1)
                            + n * s.d + (2 * s.d + 2 * n) * 4 + 4) for epi in ("float", "int8")}
    for epi in ("float", "int8"):
        print(f"int8 projection{tag}, {epi} epilogue: kernel {spread_str(ms[epi])}, bound "
              f"{bounds[epi][0]:.4f} ms ({bounds[epi][1]}); {ops / ms[epi][0] / 1e9:.1f} TOP/s")
    print(f"int8 projection{tag}: torch._int_mm on the bare int8 product ({m}, {s.d}) x ({s.d}, {n}) "
          f"{spread_str(int_mm)}; kernel / _int_mm: float {ms['float'][0] / int_mm[0]:.2f}x, "
          f"int8 {ms['int8'][0] / int_mm[0]:.2f}x")
    plain = time_ms(lambda: fa._int8_ln_project(x, ln_w, ln_b, w_q, act_scale, 1e-5) * sw_f + bias,
                    iters=5, warmup=1)
    bnd, by = bounds["float"]
    return {
        "name": "ln_qkv_proj_int8" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/int8_proj.cuh",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541", "max_abs_err": max(errs),
        "ms": ms["float"][0], "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "ms_int8_epilogue": ms["int8"][0], "int_mm_ms": int_mm[0],
    }


def phase_ln_qkv_proj(dev) -> dict:
    """The bf16 LN + QKV projection alone (``ebc_ln_qkv_proj``: the first
    launch of row 2 bf16 and the recompute of row 5) at a window forward
    (M = 140 x 229 rows) and at a training step (M = 16 x 229), D = 768, N
    = 2304, through its C entry, against ``ln_qkv_proj_plain`` (max 2e-2
    and median 1e-3 of the largest output: both round y and qkv to bf16 at
    the same points and differ only in the product's order of sums), timed
    by device time beside ``F.linear`` on the bf16 LayerNormed rows
    (cuBLAS's bare product: a yardstick, no PyTorch call computes the fused
    function)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(14)
    ln_w = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(D, generator=g, device=dev)
    w = (torch.randn(3 * D, D, generator=g, device=dev) * D**-0.5).to(torch.bfloat16)
    bias = 0.02 * torch.randn(3 * D, generator=g, device=dev)
    entry = fa._entry("fused_attention", "ebc_ln_qkv_proj")
    res = {}
    for b in (B, TRAIN_B):
        m = b * L
        x = torch.randn(m, D, generator=g, device=dev).to(torch.bfloat16)
        qkv = torch.empty(m, 3 * D, dtype=torch.bfloat16, device=dev)

        def run():
            fa._run("ebc_ln_qkv_proj", entry(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                                             w.data_ptr(), bias.data_ptr(), qkv.data_ptr(), m, D,
                                             1e-5, fa._stream(dev)))

        run()
        torch.cuda.synchronize()
        err = _check_max_median(f"ln_qkv_proj at M = {b} x {L}, kernel vs plain", qkv,
                                fa.ln_qkv_proj_plain(x, ln_w, ln_b, w, bias), 2e-2, 1e-3)
        ms = time_spread(run)
        y = torch.nn.functional.layer_norm(x.float(), (D,), ln_w, ln_b).to(torch.bfloat16)
        linear = time_spread(lambda: torch.nn.functional.linear(y, w))
        plain = time_ms(lambda: fa.ln_qkv_proj_plain(x, ln_w, ln_b, w, bias), iters=5, warmup=1)
        flops = 2 * m * D * 3 * D
        bnd, by = bound_ms(flops, PEAK_BF16, m * D * 2 + 3 * D * D * 2 + m * 3 * D * 2 + 5 * D * 4)
        print(f"ln_qkv_proj at M = {b} x {L}: kernel {spread_str(ms)} "
              f"({flops / ms[0] / 1e9:.1f} TFLOP/s), F.linear on the bare bf16 product "
              f"{spread_str(linear)} ({flops / linear[0] / 1e9:.1f} TFLOP/s), kernel / F.linear "
              f"{ms[0] / linear[0]:.2f}x; plain {plain:.3f} ms; bound {bnd:.4f} ms ({by}), "
              f"kernel at {bnd / ms[0]:.0%} of it")
        res[b] = dict(err=err, ms=ms[0], linear=linear[0], plain=plain, bound=(bnd, by))
        del x, qkv, y
    r = res[B]
    return {
        "name": "ln_qkv_proj", "route": "cuda", "source": "clip_ebc_tpu_torch/csrc/fused_attention.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:541",
        "max_abs_err": max(v["err"] for v in res.values()),
        "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None, "linear_ms": r["linear"], f"ms_b{TRAIN_B}": res[TRAIN_B]["ms"],
        f"linear_ms_b{TRAIN_B}": res[TRAIN_B]["linear"],
    }


def phase_int8_attention_body(dev, s: Shape) -> dict:
    """The int8 attention body alone (``ebc_int8_attention``, the attention
    launch of rows 2c and 2d) on an int8 qkv from the LN + int8 projection
    kernel: static scales at the windows of ``s`` (140 x 229 tokens at the
    flagship) and at ``--window_size 320`` (70 x 433), dynamic per-tile
    scales (from the float projection and the scale pass) at s.l tokens, each with bf16 and
    fp32 output, against ``int8_attention_static_plain`` and
    ``int8_attention_dynamic_plain`` at kv_len = L and L - 29 (max 2e-2 and
    median 1e-3 of the largest output, as ``phase_int8_attention_q``),
    timed by device time beside its bound (the int8 qkv in and the output
    back, or the QK^T and PV int8 operations)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    sm = (s.d // s.h) ** -0.5
    who = "int8_attention_body"
    rows = {}
    for branch, b, l in (("static", s.b, s.l), ("static", LONG_B, LONG_L), ("dynamic", s.b, s.l)):
        x, ln_w, ln_b, w, bias, act_scale, aq = _int8_attn_inputs(dev, s._replace(b=b, l=l),
                                                                  torch.bfloat16, 12)
        w_q, s_col = quantize_weight(w)
        m = b * l
        inv_act = (1.0 / act_scale).reshape(1)
        if branch == "static":
            sw, bi = fa.fold_attn_scales(s_col, bias, act_scale, aq, s.d)
            name, proj_out = "ebc_ln_qkv_proj_int8_q", torch.empty(b, l, 3 * s.d, dtype=torch.int8, device=dev)
        else:
            sw, bi = s_col * act_scale, bias
            name, proj_out = "ebc_ln_qkv_proj_int8", torch.empty(b, l, 3 * s.d, dtype=torch.bfloat16, device=dev)
        fa._run(name, fa._entry("fused_attention_int8", name)(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
            bi.data_ptr(), inv_act.data_ptr(), proj_out.data_ptr(), m, s.d, 0, 1e-5, fa._stream(dev)))
        del x, w, w_q
        for out_dtype in (torch.bfloat16, torch.float32):
            f32 = out_dtype == torch.float32
            if branch == "static":
                qkv_q, scales = proj_out, aq.contiguous()
            else:
                # the scale pass on the float qkv (fp32 output: the same values in fp32)
                qkv = proj_out.float() if f32 else proj_out
                qkv_q, scales = fa.qkv_quant_dynamic(qkv, s.h, 1 if f32 else 2)
            out = torch.empty(b, l, s.d, dtype=out_dtype, device=dev)
            tag = f"{branch} scales, {b} x {l} tokens, {'fp32' if f32 else 'bf16'} out"
            errs = []
            for kv_len in (l, l - 29):
                fa._launch_int8_attention(who, qkv_q, scales, out, s.h, kv_len, sm, branch == "dynamic")
                want = (fa.int8_attention_static_plain(qkv_q, aq, s.h, kv_len, sm, out_dtype)
                        if branch == "static" else
                        fa.int8_attention_dynamic_plain(qkv, s.h, kv_len, sm, 1 if f32 else 2))
                torch.cuda.synchronize()
                errs.append(_check_max_median(f"{who}, {tag}, kernel vs plain, kv_len={kv_len}",
                                              out[:, :kv_len], want[:, :kv_len], 2e-2, 1e-3))
                del want
            ms = time_spread(lambda: fa._launch_int8_attention(who, qkv_q, scales, out, s.h, l, sm,
                                                               branch == "dynamic"))
            plain = (time_ms(lambda: fa.int8_attention_static_plain(qkv_q, aq, s.h, l, sm, out_dtype),
                             iters=5, warmup=1) if branch == "static" else
                     time_ms(lambda: fa.int8_attention_dynamic_plain(qkv, s.h, l, sm, 1 if f32 else 2),
                             iters=5, warmup=1))
            ops = 2 * 2 * b * s.h * l * l * (s.d // s.h)
            bnd, by = bound_ms(ops, PEAK_INT8, m * 3 * s.d + m * s.d * out.element_size() + scales.numel() * 4)
            print(f"{who}, {tag}: kernel {spread_str(ms)} ({ops / ms[0] / 1e9:.1f} TOP/s), plain "
                  f"{plain:.3f} ms, bound {bnd:.4f} ms ({by}), kernel at {bnd / ms[0]:.0%} of it")
            rows[(branch, l, f32)] = dict(err=max(errs), ms=ms[0], plain=plain,
                                          bound=(bnd, by))
            del out
        del proj_out
    r = rows[("static", s.l, False)]
    return {
        "name": "int8_attention_body", "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_int8.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:195",
        "max_abs_err": max(v["err"] for v in rows.values()),
        "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None,
        **{f"ms_{br}_l{l}_{'fp32' if f32 else 'bf16'}": v["ms"] for (br, l, f32), v in rows.items()},
    }


def _int8_attn_inputs(dev, s: Shape, dtype, seed):
    """The block's inputs at the launch ``s`` with the scales a calibration
    records: the LN output's max-abs / 127 and each of q, k, v's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(s.b, s.l, s.d, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(s.d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(s.d, generator=g, device=dev)
    w = torch.randn(3 * s.d, s.d, generator=g, device=dev) * s.d**-0.5  # the fp32 master weight
    bias = 0.02 * torch.randn(3 * s.d, generator=g, device=dev)
    y = torch.nn.functional.layer_norm(x.float(), (s.d,), ln_w, ln_b)
    act_scale = y.abs().amax() / 127.0
    aq = (y @ w.T + bias).reshape(-1, 3, s.d).abs().amax((0, 2)) / 127.0
    return x, ln_w, ln_b, w, bias, act_scale, aq


def phase_int8_attention_q(dev, s: Shape, dtype: torch.dtype, branch: str) -> dict:
    """The fully int8 block attention at the launch ``s`` against its
    plain version: ``static`` (calibrated q, k, v scales: the projection
    writes int8 q, k, v, then the int8 attention kernel) or ``dynamic``
    (the float projection, the per-tile scale pass, the same int8 attention
    kernel). With ``s.l`` = LONG_L, the static branch at the shape of
    ``--window_size 320`` (LONG_B windows of 433 tokens; its row named
    ``_l433``), whose attention sweeps the keys twice. Max 2e-2 and median 1e-3 of the largest output
    in both dtypes: a flipped int8 step of q, k, v or p moves an output by
    up to 1/127 of its range, a wrong scale every output."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    fp32 = dtype == torch.float32
    b, l = s.b, s.l
    tag = ((" fp32" if fp32 else "") + (f" at L = {l}" if l == LONG_L else "")
           + (f" at B = {b}" if b in PACKED_B else ""))
    x, ln_w, ln_b, w, bias, act_scale, aq = _int8_attn_inputs(dev, s, dtype, 12)
    wq = quantize_weight(w)
    sm = (s.d // s.h) ** -0.5
    block_b = 1 if fp32 else 2
    kw = dict(attn_scales=aq) if branch == "static" else dict(quant_attn=True)

    def plain(kv_len):
        if branch == "static":
            return fa.ln_qkv_attention_int8_static_plain(x, ln_w, ln_b, *wq, bias, act_scale, aq, s.h,
                                                         kv_len, sm)
        return fa.ln_qkv_attention_int8_dynamic_plain(x, ln_w, ln_b, *wq, bias, act_scale, s.h, kv_len,
                                                      sm, block_b=block_b)

    errs = []
    for kv_len in (l, l - 29):
        got = fa.fused_ln_qkv_attention_int8(x, ln_w, ln_b, w, bias, act_scale, s.h, kv_len, sm,
                                             quantized=wq, **kw)
        want = plain(kv_len)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"int8 attention ({branch}) returned {got.dtype}, expected {dtype}")
        errs.append(_check_max_median(f"int8 attention, {branch} scales{tag}, kernel vs plain, "
                                      f"kv_len={kv_len}", got[:, :kv_len], want[:, :kv_len],
                                      2e-2, 1e-3))
        del got, want
    ms = time_spread(lambda: fa.fused_ln_qkv_attention_int8(x, ln_w, ln_b, w, bias, act_scale, s.h, l, sm,
                                                            quantized=wq, **kw))
    plain_ms = time_ms(lambda: plain(l), iters=5, warmup=1)
    m, es = b * l, x.element_size()
    ops = 2 * m * s.d * 3 * s.d + 2 * 2 * b * s.h * l * l * (s.d // s.h)  # projection, QK^T and PV: all int8
    nbytes = m * s.d * es * 2 + 3 * s.d * s.d + 2 * s.d * 4 + 2 * 3 * s.d * 4 + 4 + 3 * 4
    bnd, by = bound_ms(ops, PEAK_INT8, nbytes)
    print(f"int8 attention, {branch} scales{tag}: kernel {spread_str(ms)}, plain {plain_ms:.3f} ms, bound "
          f"{bnd:.4f} ms ({by}: {ops / 1e9:.1f} GOP int8); {ops / ms[0] / 1e9:.1f} TOP/s")
    ms = ms[0]
    return {
        "name": f"int8_attention_{branch}" + ("_fp32" if fp32 else "") + (f"_l{l}" if l == LONG_L else ""),
        "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_int8.cu",
        "replaces": ("clip_ebc_tpu/ops/fused_attention.py:195" if branch == "static"
                     else "clip_ebc_tpu/ops/fused_attention.py:152"),
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
        "bound_by": by, "library_ms": None,
    }


def phase_mlp_int8(dev, s: Shape, dtype: torch.dtype) -> list:
    """The W8A8 MLP (LN, int8 fc, GELU, int8 proj, residual) at the
    launch ``s`` (140 windows x 229 tokens, D = 768, hidden 3072 at the
    flagship) against its plain version: QuickGELU, and in bf16 the tanh
    GELU once. Max 2e-2
    of the largest output (one flipped int8 step of an LN output moves all
    3072 hidden units of its row: 6.6e-2 on outputs of magnitude 12 in
    fp32 at this shape on an H100) and median 1e-3 in bf16, 1e-4 in fp32; in
    fp32 the MLP branch (output - x) alone is also held to 5e-2 and 1e-3 of
    its own largest magnitude (the residual would hide a wrong branch).
    Then its two launches apart, by device time: launch 1 (the LN + int8
    fc + GELU + quantize, ``ebc_ln_proj_gelu_int8``) and launch 2 (``hq .
    W_pj^T`` + dequantize + bias + residual, ``int8_gemm_residual``), launch
    2 held bit-equal to ``int8_gemm_residual_plain`` on the kernel's hq and
    timed beside ``torch._int_mm`` on the bare product (a yardstick: it
    lacks the epilogue). Returns the MLP's row and launch 2's."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops import quant
    from clip_ebc_tpu_torch.ops.quant import quantize_weight

    fp32 = dtype == torch.float32
    tag = " fp32" if fp32 else ""
    hidden = 4 * s.d
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(s.b, s.l, s.d, generator=g, device=dev).to(dtype)
    ln_w = 1.0 + 0.1 * torch.randn(s.d, generator=g, device=dev)
    ln_b = 0.1 * torch.randn(s.d, generator=g, device=dev)
    w_fc = 0.06 * torch.randn(hidden, s.d, generator=g, device=dev)
    b_fc = 0.02 * torch.randn(hidden, generator=g, device=dev)
    w_pj = 0.03 * torch.randn(s.d, hidden, generator=g, device=dev)
    b_pj = 0.02 * torch.randn(s.d, generator=g, device=dev)
    y = torch.nn.functional.layer_norm(x.float(), (s.d,), ln_w, ln_b)
    hh = y @ w_fc.T + b_fc
    act1 = y.abs().amax() / 127.0
    act2 = (hh * torch.sigmoid(1.702 * hh)).abs().amax() / 127.0
    del y, hh
    qz = (*quantize_weight(w_fc), *quantize_weight(w_pj))
    args = (x, ln_w, ln_b, w_fc, b_fc, act1, w_pj, b_pj, act2)
    med_tol = 1e-4 if fp32 else 1e-3
    errs = []
    for quick in ((True,) if fp32 else (True, False)):
        got = fa.fused_ln_mlp_int8(*args, quick_gelu=quick, quantized=qz)
        want = fa.ln_mlp_int8_plain(x, ln_w, ln_b, *qz[:2], b_fc, act1, *qz[2:], b_pj, act2, quick)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"int8 MLP returned {got.dtype}, expected {dtype}")
        who = f"int8 MLP{tag} ({'QuickGELU' if quick else 'tanh GELU'}) kernel vs plain"
        errs.append(_check_max_median(who, got, want, 2e-2, med_tol))
        if fp32:
            _check_max_median(who + ", MLP branch", got - x, want - x, 5e-2, 1e-3)
        del got, want
    ms = time_spread(lambda: fa.fused_ln_mlp_int8(*args, quantized=qz))
    plain_ms = time_ms(lambda: fa.ln_mlp_int8_plain(x, ln_w, ln_b, *qz[:2], b_fc, act1, *qz[2:], b_pj,
                                                    act2, True), iters=5, warmup=1)
    m, es = s.b * s.l, x.element_size()
    ops = 2 * 2 * m * s.d * hidden
    nbytes = m * s.d * es * 2 + 2 * s.d * hidden + (2 * hidden + 2 * s.d + 2 * s.d) * 4 + 8
    bnd, by = bound_ms(ops, PEAK_INT8, nbytes)
    print(f"int8 MLP{tag}: kernel {spread_str(ms)}, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ({by}: "
          f"{ops / 1e9:.1f} GOP int8); {ops / ms[0] / 1e9:.1f} TOP/s")

    # the two launches apart, on the same inputs
    wfc_q, s_fc, wpj_q, s_pj = qz
    sw1, sw2 = s_fc * act1, s_pj * act2
    inv = torch.stack([1.0 / act1, 1.0 / act2])
    hq = torch.empty(m, hidden, dtype=torch.int8, device=dev)
    launch1 = fa._entry("fused_mlp_int8", "ebc_ln_proj_gelu_int8")

    def run1():
        fa._run("ebc_ln_proj_gelu_int8", launch1(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wfc_q.data_ptr(), sw1.data_ptr(),
            b_fc.data_ptr(), inv[0:1].data_ptr(), inv[1:2].data_ptr(), hq.data_ptr(), m, s.d, hidden, 1,
            int(fp32), 1e-5, fa._stream(dev)))

    run1()
    x2 = x.reshape(m, s.d)
    got = fa.int8_gemm_residual(hq, wpj_q, sw2, b_pj, x2)
    want = fa.int8_gemm_residual_plain(hq, wpj_q, sw2, b_pj, x2)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"int8 MLP launch 2{tag} differs from int8_gemm_residual_plain")
    print(f"int8 MLP launch 2{tag}: bit-equal to int8_gemm_residual_plain at ({m}, {hidden}) x ({s.d}, {hidden})^T")
    del got, want
    ms1 = time_spread(run1)
    ms2 = time_spread(lambda: fa.int8_gemm_residual(hq, wpj_q, sw2, b_pj, x2))
    int_mm_ms = time_spread(lambda: quant.int_mm(hq, wpj_q))
    plain2 = time_ms(lambda: fa.int8_gemm_residual_plain(hq, wpj_q, sw2, b_pj, x2), iters=5, warmup=1)
    ops1 = ops2 = 2 * m * s.d * hidden
    bnd1 = bound_ms(ops1, PEAK_INT8, m * s.d * es + s.d * hidden + m * hidden + (2 * hidden + 2 * s.d) * 4 + 8)
    bnd2 = bound_ms(ops2, PEAK_INT8, m * hidden + s.d * hidden + 2 * m * s.d * es + 2 * s.d * 4)
    print(f"int8 MLP{tag} by launch: launch 1 (LN, fc, GELU, quantize) {spread_str(ms1)}, bound "
          f"{bnd1[0]:.4f} ms ({bnd1[1]}), at {bnd1[0] / ms1[0]:.0%} of it; launch 2 (proj, residual) "
          f"{spread_str(ms2)}, bound {bnd2[0]:.4f} ms ({bnd2[1]}), at {bnd2[0] / ms2[0]:.0%} of it, "
          f"{ops2 / ms2[0] / 1e9:.1f} TOP/s; torch._int_mm on the bare product {spread_str(int_mm_ms)}; "
          f"launch 2 plain {plain2:.3f} ms")
    return [{
        "name": "fused_ln_mlp_int8" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_mlp_int8.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:850",
        "max_abs_err": max(errs), "ms": ms[0], "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "ms_launch1": ms1[0], "bound_ms_launch1": bnd1[0],
    }, {
        "name": "int8_gemm_residual" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_mlp_int8.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:850",
        "max_abs_err": 0.0, "ms": ms2[0], "plain_ms": plain2, "bound_ms": bnd2[0], "bound_by": bnd2[1],
        "library_ms": None, "yardstick_int_mm_ms": int_mm_ms[0],
    }]


def phase_qkv_quant_dynamic(dev, s: Shape, dtype: torch.dtype) -> dict:
    """The dynamic scale pass alone (``qkv_quant_dynamic``: row 2d's
    per-tile max-abs scales and int8 q, k, v) on a float qkv at the
    launch ``s``, tiles of 2 windows in bf16 and 1 in fp32: qkv_q and the
    scales bit-equal to ``qkv_quant_dynamic_plain``; timed by device time beside its bound
    (qkv read once, written once as int8)."""
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    fp32 = dtype == torch.float32
    b, l = s.b, s.l
    tag = (" fp32" if fp32 else "") + (f" at ({b}, {l}, {3 * s.d})" if s != FLAGSHIP else "")
    block_b = 1 if fp32 else 2
    g = torch.Generator(device=dev).manual_seed(17)
    # heads of unlike magnitude, as a projection gives them
    qkv = (torch.randn(b, l, 3 * s.d, generator=g, device=dev)
           * (0.5 + torch.rand(3 * s.d // 64, generator=g, device=dev)).repeat_interleave(64)).to(dtype)
    got_q, got_s = fa.qkv_quant_dynamic(qkv, s.h, block_b)
    want_q, want_s = fa.qkv_quant_dynamic_plain(qkv, s.h, block_b)
    torch.cuda.synchronize()
    check(torch.equal(got_q, want_q) and torch.equal(got_s, want_s),
          f"scale pass{tag} differs from qkv_quant_dynamic_plain")
    print(f"scale pass{tag}: qkv_q and scales bit-equal to qkv_quant_dynamic_plain")
    del got_q, got_s, want_q, want_s
    ms = time_spread(lambda: fa.qkv_quant_dynamic(qkv, s.h, block_b))
    plain = time_ms(lambda: fa.qkv_quant_dynamic_plain(qkv, s.h, block_b), iters=5, warmup=1)
    n = qkv.numel()
    bnd, by = bound_ms(0.0, PEAK_FP32, n * qkv.element_size() + n + b * s.h * 3 * 4)
    print(f"scale pass{tag}: kernel {spread_str(ms)}, plain {plain:.3f} ms, bound {bnd:.4f} ms ({by}), "
          f"kernel at {bnd / ms[0]:.0%} of it, {(n * qkv.element_size() + n) / ms[0] / 1e6:.0f} GB/s")
    return {
        "name": "qkv_quant_dynamic" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/fused_attention_int8.cu",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:140", "max_abs_err": 0.0,
        "ms": ms[0], "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
    }


def phase_qkv_attention(dev, s: Shape, dtype: torch.dtype) -> dict:
    """The attention from a precomputed qkv against its plain version at
    the width and heads of ``s``, at (windows, tokens, valid keys): a window
    forward (s.b, s.l, s.l), a calibration batch with masked keys (16, s.l,
    200: its query tiles in two parts a pair), one valid key, the longest
    fused length, a length that is no multiple of 16, and a calibration
    batch whole and with s.l - 39 keys: bf16 max 2e-2 and median 1e-3 of the
    largest magnitude (the bf16 kernel multiplies O by the reciprocal of
    the fp32 row sum where the plain version divides), fp32 1e-4 and 1e-5
    (fp32 throughout). Timed
    (device time, ``time_spread``) at a calibration batch (16 windows, the
    row's ms) and at a window forward's 140, each beside the forward of
    ``F.scaled_dot_product_attention`` on the same q, k, v (the library
    yardstick, timed here only); in fp32 at 140 also beside the fp32
    ``flash_short`` kernel (row 7 fp32) on the same views."""
    from clip_ebc_tpu_torch.ops import flash_attention as fl
    from clip_ebc_tpu_torch.ops.fused_attention import fused_qkv_attention, qkv_attention_plain

    fp32 = dtype == torch.float32
    max_tol, med_tol, peak, tag = (1e-4, 1e-5, PEAK_FP32, " fp32") if fp32 else (2e-2, 1e-3, PEAK_BF16, "")
    sm = (s.d // s.h) ** -0.5
    errs = []
    cases = [(s.b, s.l, s.l), (CALIB_B, s.l, 200), (3, 64, 1), (2, 320, 320), (2, 77, 77),
             (CALIB_B, s.l, s.l), (CALIB_B, s.l, s.l - 39)]
    for i, (b, l, kv_len) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(5 + i)
        qkv = torch.randn(b, l, 3 * s.d, generator=g, device=dev).to(dtype)
        got = fused_qkv_attention(qkv, s.h, kv_len, sm)
        want = qkv_attention_plain(qkv, s.h, kv_len, sm)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"qkv attention kernel returned {got.dtype}, expected {dtype}")
        errs.append(_check_max_median(f"qkv attention{tag} kernel vs plain at ({b}, {l}), kv_len={kv_len}",
                                      got[:, :kv_len], want[:, :kv_len], max_tol, med_tol))
        del qkv, got, want
    es = 4 if fp32 else 2
    times = {}
    for b in (CALIB_B, s.b):
        g = torch.Generator(device=dev).manual_seed(5)
        qkv = torch.randn(b, s.l, 3 * s.d, generator=g, device=dev).to(dtype)
        q, k, v = (t.reshape(b, s.l, s.h, s.d // s.h).transpose(1, 2) for t in qkv.split(s.d, dim=-1))
        t = {"kernel": time_spread(lambda: fused_qkv_attention(qkv, s.h, s.l, sm)),
             "SDPA forward": time_spread(
                 lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=sm))}
        if fp32 and b == s.b:
            t["flash_short_fp32"] = time_spread(lambda: fl.flash_short(q, k, v, sm))
        flops = 2 * 2 * b * s.h * s.l * s.l * (s.d // s.h)
        bnd, by = bound_ms(flops, peak, b * s.l * (3 * s.d + s.d) * es)
        print(f"qkv attention{tag} at ({b}, {s.l}, {3 * s.d}): " + ", ".join(
            f"{k} {spread_str(v)}" for k, v in t.items())
            + f"; bound {bnd:.4f} ms ({by}); kernel {flops / t['kernel'][0] / 1e9:.1f} TFLOP/s")
        times[b] = t
        del qkv, q, k, v
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn(CALIB_B, s.l, 3 * s.d, generator=g, device=dev).to(dtype)
    plain = time_ms(lambda: qkv_attention_plain(qkv, s.h, s.l, sm))
    bnd, by = bound_ms(2 * 2 * CALIB_B * s.h * s.l * s.l * (s.d // s.h), peak, CALIB_B * s.l * (3 * s.d + s.d) * es)
    return {
        "name": "fused_qkv_attention" + ("_fp32" if fp32 else ""), "route": "cuda",
        "source": "clip_ebc_tpu_torch/csrc/attention_short.cuh",
        "replaces": "clip_ebc_tpu/ops/fused_attention.py:386", "max_abs_err": max(errs),
        "ms": times[CALIB_B]["kernel"][0], "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": times[CALIB_B]["SDPA forward"][0],
    }


def _flash_inputs(dev, dtype, b, h, l, seed):
    """q, k, v as the model hands them to the kernels: strided head views
    of a unit-variance joint qkv (B, L, 3 H 64)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * 64, generator=g, device=dev).to(dtype)
    return [t.reshape(b, l, h, 64).transpose(1, 2) for t in qkv.split(h * 64, dim=-1)]


def phase_flash(dev, route: str, dtype: torch.dtype) -> dict:
    """One flash-attention kernel against its plain version, max abs error
    within 2e-2 x max|want| (bf16: P rounded at the same points, sums in
    another order) or 1e-4 (fp32): the tiled kernel at the flagship full
    image and on a ragged causal sequence, the short kernel at the
    windows' shape, at the text tower's (causal) and at 320, 321 and 512
    keys (the fused route's longest; past it the fp32 body holds 24-32 keys
    a thread, one block an SM; the route's longest). Timed at the first
    shape (device time, ``time_spread``), beside the SDPA forward on the
    same q, k, v (timed here only)."""
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.ops import flash_attention as fa

    fp32 = dtype == torch.float32
    peak, tag = (PEAK_FP32, "_fp32") if fp32 else (PEAK_BF16, "")
    wrapper = fa.flash_tiled if route == "tiled" else fa.flash_short
    plain = fa.flash_tiled_plain if route == "tiled" else fa.flash_short_plain
    n_prompts = len(get_bins_and_anchors(8, 4, "qnrf")[1])
    shapes = ([(1, H, FULL_L, False), (2, H, 1100, True)] if route == "tiled"
              else [(B, H, L, False), (n_prompts, 8, 77, True), (2, H, 320, False),
                    (2, H, 321, False), (2, H, 512, False)])
    errs = []
    for i, (b, h, l, causal) in enumerate(shapes):
        q, k, v = _flash_inputs(dev, dtype, b, h, l, 7 + i)
        got = wrapper(q, k, v, 0.125, causal)
        want = plain(q, k, v, 0.125, causal)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == want.shape, f"flash_{route}{tag}: {got.dtype} {tuple(got.shape)}")
        who = f"flash_{route}{tag} kernel vs plain at ({b}, {h}, {l}, 64){' causal' if causal else ''}"
        if fp32:
            err = (got - want).abs().max().item()
            print(f"{who}: max abs err {err:.3e} (tol 1e-4)")
            check(math.isfinite(err) and err <= 1e-4, f"{who}: kernel disagrees")
        else:
            err = _check_scaled(who, got, want, 2e-2)
        errs.append(err)
        del got, want
    b, h, l, _ = shapes[0]
    q, k, v = _flash_inputs(dev, dtype, b, h, l, 7)
    ms = time_spread(lambda: wrapper(q, k, v, 0.125))
    plain_ms = time_ms(lambda: plain(q, k, v, 0.125, False), iters=5, warmup=1)
    library = time_spread(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=0.125))
    flops = 4 * b * h * l * l * 64  # QK^T and PV
    nbytes = 4 * b * h * l * 64 * q.element_size()  # q, k, v read, out written
    bnd, by = bound_ms(flops, peak, nbytes)
    print(f"flash_{route}{tag} at ({b}, {h}, {l}, 64): kernel {spread_str(ms)}, plain {plain_ms:.3f} ms, "
          f"SDPA forward {spread_str(library)}, bound {bnd:.4f} ms ({by}); "
          f"{flops / ms[0] / 1e9:.1f} TFLOP/s")
    ms, library = ms[0], library[0]
    return {
        "name": f"flash_{route}{tag}", "route": "cuda",
        "source": ("clip_ebc_tpu_torch/csrc/flash_attention.cu" if route == "tiled"
                   else "clip_ebc_tpu_torch/csrc/attention_short.cuh"),
        "replaces": ("clip_ebc_tpu/ops/flash_attention.py:197" if route == "tiled"
                     else "clip_ebc_tpu/ops/flash_attention.py:154"),
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": library,
    }


def _library_kernels_child() -> None:
    phase_library_kernels(torch.device("cuda", 0))


def phase_library_kernels_apart() -> None:
    """:func:`phase_library_kernels` in a spawned process (this one holds a
    CUDA context, so no fork), its output on this one's; its failure, exit
    or silence past 600 s fails the run."""
    import multiprocessing as mp

    sys.stdout.flush()
    p = mp.get_context("spawn").Process(target=_library_kernels_child)
    p.start()
    p.join(600)
    if p.is_alive():
        p.kill()
        p.join()
    check(p.exitcode == 0, f"phase 5's process exited with {p.exitcode}")


def phase_library_kernels(dev) -> None:
    """The kernels behind the PyTorch yardsticks of the redesigned rows (the
    SDPA forward of the short flash route's windows, of a calibration batch
    in fp32 and of the whole image in bf16; the SDPA backward of the
    training step), by device time under torch.profiler. Run last, in a
    process of its own (:func:`phase_library_kernels_apart`): the
    profiler's tracing stays attached to a process and slows the launches
    of every timing after it, and after an earlier trace in the process it
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile as prof

    def kernels(fn) -> str:
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in sorted(p.key_averages(), key=lambda e: -e.device_time_total)
                if e.device_time_total > 0]
        check(bool(rows), "torch.profiler recorded no device time for a library call")
        return "; ".join(f"{e.key[:110]} ({e.device_time_total / 1e3:.3f} ms)" for e in rows[:3])

    for dtype, (b, l) in ((torch.bfloat16, (B, L)), (torch.float32, (CALIB_B, L)),
                          (torch.bfloat16, (1, FULL_L))):
        q, k, v = _flash_inputs(dev, dtype, b, H, l, 7)
        print(f"SDPA forward at ({b}, {H}, {l}, 64), {str(dtype)[6:]}: "
              f"{kernels(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=0.125))}")
        del q, k, v
    for dtype in (torch.bfloat16, torch.float32):
        qkv, gout = _bwd_inputs(dev, FLAGSHIP, dtype, 2)
        q, k, v = (t.reshape(TRAIN_B, L, H, D // H).transpose(1, 2).detach().requires_grad_(True)
                   for t in qkv.split(D, dim=-1))
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        go = gout.reshape(TRAIN_B, L, H, D // H).transpose(1, 2)
        print(f"SDPA backward at ({TRAIN_B}, {H}, {L}, 64), {str(dtype)[6:]}: "
              f"{kernels(lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True))}")


def phase_int8_products(dev) -> None:
    """The integer products that lie outside the kernels (library calls, as
    the JAX package leaves them to XLA). The decoder's int8 convolution on
    the card must give the plain int32 convolution's accumulators exactly,
    by both routes; then the time of each route at the flagship decoder
    shape beside the bf16 convolution, and of the trunk's int8 products
    beside their bf16 twins."""
    from clip_ebc_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(6)
    conv = quant.Int8Conv2d(D, D, 3, padding=1, bias=False).to(dev)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02, generator=g)
    w_q, _ = conv.quantized_weight()
    routes = {"im2col": quant.int8_conv2d_im2col, "shifted": quant.int8_conv2d_shifted}

    def nchw_int8(n, hw):  # channels-last memory, as the model's features are
        t = torch.randint(-127, 128, (n, hw, hw, D), generator=g, device=dev, dtype=torch.int8)
        return t.permute(0, 3, 1, 2)

    x_q = nchw_int8(3, 28)
    want = quant.int8_conv2d_plain(x_q.cpu(), w_q.cpu(), conv.stride, conv.padding, conv.dilation)
    for route, fn in routes.items():
        got = fn(x_q, w_q, conv.stride, conv.padding, conv.dilation)
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
              f"int8 convolution ({route}) accumulators differ from the plain int32 convolution")
    check(torch.equal(conv.accumulate(x_q, w_q).cpu(), want), "Int8Conv2d accumulators differ")
    print(f"int8 decoder convolution: accumulators of both routes equal the plain int32 "
          f"convolution's on {tuple(x_q.shape)} (max |acc| {int(want.abs().max())})")

    x_q = nchw_int8(B, 28)
    times = {route: time_ms(lambda fn=fn: fn(x_q, w_q, conv.stride, conv.padding, conv.dilation), iters=10)
             for route, fn in routes.items()}
    xb = torch.randn(B, 28, 28, D, generator=g, device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    wb = conv.weight.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn = time_ms(lambda: torch.nn.functional.conv2d(xb, wb, padding=1), iters=10)
    full = time_ms(lambda: conv(xb), iters=10)
    ops = 2 * B * 28 * 28 * D * 9 * D
    print(f"int8 decoder convolution at ({B}, {D}, 28, 28): "
          + ", ".join(f"{r} {t:.3f} ms" for r, t in times.items())
          + f" (accumulators only); Int8Conv2d in all (dynamic quantize, im2col, "
          f"dequantize) {full:.3f} ms; bf16 convolution {cudnn:.3f} ms; bound {ops / PEAK_INT8 * 1e3:.3f} ms "
          f"int8, {ops / PEAK_BF16 * 1e3:.3f} ms bf16")
    del x_q, xb

    m = B * L
    for k, n in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
        a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        wgt = torch.randn(n, k, generator=g, device=dev) * k**-0.5
        wq, s_w = quant.quantize_weight(wgt)
        wb = wgt.to(torch.bfloat16)
        a_q = quant.quantize_rowwise(a)[0]
        scale = a.float().abs().amax() / 127.0
        t_mm = time_ms(lambda: quant.int_mm(a_q, wq), iters=10)
        t_dyn = time_ms(lambda: quant.int8_linear(a, wq, s_w, None), iters=10)
        t_sta = time_ms(lambda: quant.int8_linear(a, wq, s_w, None, scale), iters=10)
        t_bf = time_ms(lambda: torch.nn.functional.linear(a, wb), iters=10)
        print(f"trunk product ({m}, {k}) x ({n}, {k})^T: _int_mm {t_mm:.3f} ms, int8 linear "
              f"dynamic {t_dyn:.3f} / static {t_sta:.3f} ms (quantize, product, dequantize), "
              f"bf16 linear {t_bf:.3f} ms; bound {2 * m * k * n / PEAK_INT8 * 1e3:.3f} ms int8")


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
    fused_ln_qkv_attention.launches = fused_ln_qkv_attention.launches_proj = 0
    fused_ebc_head.launches = 0
    _off_path_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"fused_ln_qkv_attention": fused_ln_qkv_attention.launches,
                "ln_qkv_proj": fused_ln_qkv_attention.launches_proj,
                "fused_ebc_head": fused_ebc_head.launches}
    mode = "bf16 (--amp)" if amp else "fp32 (default)"
    print(f"predict CLI, {mode}: {cli_s:.1f} s (model build, weights, one image); "
          f"launches {launches}")
    _tally_off_path(f"predict CLI, {mode}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"CSV has {len(rows)} rows")
    count = float(rows[0]["count"])
    check(math.isfinite(count), f"CLI count {count} is not finite")
    check(launches["fused_ln_qkv_attention"] == 12,
          f"{mode}: expected 12 attention launches per forward")
    check(launches["ln_qkv_proj"] == (12 if amp else 0),
          f"{mode}: expected {12 if amp else 0} bf16 LN + QKV projection launches per forward")
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
        kernels["ln_qkv_proj"]["launches"] = launches["ln_qkv_proj"]
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


def phase_path_ms(dev) -> None:
    """The paths the float attention bodies sit on, kernel path only, for
    timing a tree against its parent (``scripts/torch_kernel_ab.py``): ms
    per image of the flagship windows (140 of 224 px; host clock, median of
    5 after a warm-up) in bf16 (12 launches of row 2), in fp32 (the CLIs'
    default) and under ``--quant
    int8`` in bf16 (dynamic scales: the int8 projection, then row 3 at 140
    windows), under ``--quant int8_static`` (rows 2b: the int8 LN + QKV
    projection, then the bf16 attention body) and ``--quant int8_static
    --quant_attn kernel`` (row 2c: the projection's int8 epilogue, then the
    int8 attention), both calibrated on the image, and the ms of the bf16
    training step's forward and of its forward and backward (16 windows in
    train mode, the prompts requiring grad: 12 launches of row 2 and 12 of
    row 5; host clock ending in a synchronize, median of 10 after 2
    warm-up)."""
    import argparse

    from clip_ebc_tpu_torch.cli._common import calibrate_static_int8
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import normalize_image
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    image = normalize_image(np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,)).astype(np.float32) / 255.0)
    for tag, dtype, kw in (("bf16", torch.bfloat16, {}), ("fp32", torch.float32, {}),
                           ("--quant int8, bf16", torch.bfloat16, {"quant_int8": True})):
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=dtype, num_vpt=32,
                          seed=0, device=dev, **kw)
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                       pad_to_multiple=16)
        print(f"path: windows {tag}, {time_image(ev, image):.2f} ms/image")
        del ev, model
    args = argparse.Namespace(model="clip_vit_b_16", input_size=224, reduction=8, window_size=224)
    for tag, kw in (("--quant int8_static, bf16", {}),
                    ("--quant int8_static --quant_attn kernel, bf16", {"quant_attn": True})):
        kw = dict(dtype=torch.bfloat16, num_vpt=32, seed=0, device=dev, quant_int8=True, **kw)
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, quant_mode="static", **kw)
        calibrate_static_int8(args, kw, bins, anchors, model, [image])
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                       pad_to_multiple=16)
        print(f"path: windows {tag}, {time_image(ev, image):.2f} ms/image")
        del ev, model
    model = _flagship_model(dev, torch.bfloat16).train()
    with torch.no_grad():
        text = model.encode_text()
    windows = torch.from_numpy(np.random.default_rng(1).normal(size=(TRAIN_B, TRAIN_SIZE, TRAIN_SIZE, 3))
                               .astype(np.float32)).to(dev)
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(windows, text_feats=text)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"path: training step forward, bf16, {TRAIN_B} windows: {statistics.median(times):.2f} ms "
          f"({min(times):.2f}-{max(times):.2f}; host clock, 10 after 2 warm-up)")
    times = []
    for i in range(12):  # forward and backward (the frozen trunk's backward recomputes the projection)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, density = model(windows, text_feats=text)
        (logits.float().mean() + density.float().mean()).backward()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"path: training step forward + backward, bf16, {TRAIN_B} windows: "
          f"{statistics.median(times):.2f} ms ({min(times):.2f}-{max(times):.2f}; host clock, 10 after "
          f"2 warm-up)")


def _int8_counters(reset: bool = False) -> dict:
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head

    q = fa.fused_ln_qkv_attention_int8
    names = {"fused_ln_qkv_attention_int8": (q, "launches"), "ln_qkv_proj_int8": (q, "launches_proj"),
             "int8_attention_body": (q, "launches_attn"),
             "fused_qkv_attention": (fa.fused_qkv_attention, "launches"),
             "fused_ln_qkv_attention": (fa.fused_ln_qkv_attention, "launches"),
             "fused_ebc_head": (fused_ebc_head, "launches")}
    if reset:
        _off_path_counters(reset=True)
        for f, attr in names.values():
            setattr(f, attr, 0)
    return {k: getattr(f, attr) for k, (f, attr) in names.items()}


def run_cli_int8(img_dir: str, out: str, quant: str, amp: bool) -> tuple:
    """The predict CLI on ``img_dir`` with ``--quant``, counters zeroed just
    before and read just after: ``(count, launches)``."""
    from clip_ebc_tpu_torch.cli import predict

    argv = [img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
            "--num_vpt", "32", "--sliding_window", "--window_size", "224", "--stride", "224",
            "--seed", "0", "--quant", quant, "--calib_images", "2", "--out", out]
    argv += ["--amp"] if amp else []
    _int8_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _int8_counters()
    mode = f"--quant {quant}, " + ("bf16 (--amp)" if amp else "fp32")
    print(f"predict CLI, {mode}: {secs:.1f} s (model build, weights, "
          f"{'calibration, ' if quant == 'int8_static' else ''}one image); launches {launches}")
    _tally_off_path(f"predict CLI, {mode}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"CSV has {len(rows)} rows")
    count = float(rows[0]["count"])
    check(math.isfinite(count), f"{mode}: CLI count {count} is not finite")
    # one image: one calibration batch (its first 16 windows) and one forward
    static = quant == "int8_static"
    want = {"fused_ln_qkv_attention_int8": 12 if static else 0, "ln_qkv_proj_int8": 12 if static else 0,
            "int8_attention_body": 0, "fused_qkv_attention": 12, "fused_ln_qkv_attention": 0,
            "fused_ebc_head": 2 if static else 1}
    check(launches == want, f"{mode}: launches {launches}, expected {want}")
    return count, launches


def phase_int8_path(dev, kernels: dict, profile: bool) -> None:
    import argparse

    from clip_ebc_tpu_torch.cli._common import calibrate_static_int8
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.ops.quant import load_quant_state, quant_state
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        cli_count, n = run_cli_int8(img_dir, os.path.join(tmp, "s.csv"), "int8_static", amp=True)
        kernels["fused_ln_qkv_attention_int8"]["launches"] = n["fused_ln_qkv_attention_int8"]
        kernels["ln_qkv_proj_int8"]["launches"] = n["ln_qkv_proj_int8"]
        kernels["fused_qkv_attention"]["launches"] = n["fused_qkv_attention"]
        dyn_count, _ = run_cli_int8(img_dir, os.path.join(tmp, "d.csv"), "int8", amp=True)
        cli32_count, n32 = run_cli_int8(img_dir, os.path.join(tmp, "s32.csv"), "int8_static", amp=False)
        kernels["fused_ln_qkv_attention_int8_fp32"]["launches"] = n32["fused_ln_qkv_attention_int8"]
        kernels["ln_qkv_proj_int8_fp32"]["launches"] = n32["ln_qkv_proj_int8"]
        kernels["fused_qkv_attention_fp32"]["launches"] = n32["fused_qkv_attention"]
        image = normalize_image(_load_image(path))

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    args = argparse.Namespace(model="clip_vit_b_16", input_size=224, reduction=8, window_size=224)

    def evaluator(**kw):
        kw = dict(dict(dtype=torch.bfloat16, num_vpt=32, seed=0, device=dev), **kw)
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, **kw)
        return Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                         pad_to_multiple=16), kw

    static, kw = evaluator(quant_int8=True, quant_mode="static")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrate_static_int8(args, {k: v for k, v in kw.items() if k != "quant_mode"}, bins, anchors,
                          static.model, [image])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    state = quant_state(static.model)
    zero = [k for k, v in state.items() if not bool((v > 0).all())]
    check(len(state) == 12 * 5 + 2 and not zero, f"quant state has zero leaves: {zero[:4]}")
    density = static.predict_density(image)
    check(tuple(density.shape) == (IMAGE_HW[0] // 8, IMAGE_HW[1] // 8),
          f"int8 density shape {tuple(density.shape)}")
    check(bool(torch.isfinite(density).all()), "int8 density has non-finite values")
    count = float(density.sum())
    plain, _ = evaluator(quant_int8=True, quant_mode="static", attn_backend="sdpa", fused_head="off")
    load_quant_state(plain.model, state)
    plain_count = plain.predict_count(image)
    rel = abs(count - plain_count) / abs(plain_count)
    print(f"int8_static count: kernels {count:.4f}, plain path {plain_count:.4f}, CLI {cli_count:.2f}; "
          f"|diff|/count {rel:.2e} (tol 1e-2); quant state: {len(state)} leaves, none zero")
    check(rel <= 1e-2, "int8 kernel path and plain path disagree on the count")
    check(abs(cli_count - count) <= 1e-2 * abs(count), "int8 CLI count differs from the Evaluator's")
    del plain

    bf16, _ = evaluator()
    bf16_count = bf16.predict_count(image)
    dynamic, _ = evaluator(quant_int8=True)
    ms = {"int8_static": time_image(static, image), "bf16": time_image(bf16, image),
          "int8 (dynamic)": time_image(dynamic, image)}
    print(f"flagship image, W8A8: " + ", ".join(f"{k} {v:.2f} ms/image" for k, v in ms.items())
          + f"; calibration {calib_s:.2f} s (twin build, one batch of {CALIB_B} windows); counts: "
          f"bf16 {bf16_count:.2f}, int8_static {count:.2f} ({abs(count - bf16_count) / abs(bf16_count):.2e} "
          f"from bf16), int8 dynamic (CLI) {dyn_count:.2f} "
          f"({abs(dyn_count - bf16_count) / abs(bf16_count):.2e}), fp32 int8_static (CLI) {cli32_count:.2f}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            static.predict_count(image)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=30))


def _full_counters(reset: bool = False) -> dict:
    from clip_ebc_tpu_torch.ops import flash_attention as fl
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head

    fns = {"flash_tiled": fl.flash_tiled, "flash_short": fl.flash_short,
           "fused_ln_qkv_attention": fa.fused_ln_qkv_attention, "fused_ebc_head": fused_ebc_head}
    if reset:
        _off_path_counters(reset=True)
        for f in fns.values():
            f.launches = 0
    return {k: f.launches for k, f in fns.items()}


def run_cli_full(img_dir: str, out: str, amp: bool) -> tuple:
    """The predict CLI without ``--sliding_window`` on ``img_dir``, counters
    zeroed just before and read just after: ``(count, launches)``."""
    from clip_ebc_tpu_torch.cli import predict

    argv = [img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
            "--num_vpt", "32", "--seed", "0", "--out", out] + (["--amp"] if amp else [])
    _full_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _full_counters()
    mode = "full image, " + ("bf16 (--amp)" if amp else "fp32 (default)")
    print(f"predict CLI, {mode}: {secs:.1f} s (model build, weights, one image); launches {launches}")
    _tally_off_path(f"predict CLI, {mode}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"CSV has {len(rows)} rows")
    count = float(rows[0]["count"])
    check(math.isfinite(count), f"{mode}: CLI count {count} is not finite")
    want = {"flash_tiled": 12, "flash_short": 0, "fused_ln_qkv_attention": 0, "fused_ebc_head": 1}
    check(launches == want, f"{mode}: launches {launches}, expected {want}")
    return count, launches


def phase_full_image(dev, kernels: dict, profile: bool) -> None:
    from torch.utils.flop_counter import FlopCounterMode

    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        cli_count, n = run_cli_full(img_dir, os.path.join(tmp, "full.csv"), amp=True)
        kernels["flash_tiled"]["launches"] = n["flash_tiled"]
        cli32_count, n32 = run_cli_full(img_dir, os.path.join(tmp, "full32.csv"), amp=False)
        kernels["flash_tiled_fp32"]["launches"] = n32["flash_tiled"]
        image = normalize_image(_load_image(path))
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")

    def evaluator(dtype, windows=False, **paths):
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=dtype, num_vpt=32,
                          seed=0, device=dev, **paths)
        if windows:
            return Evaluator(model, reduction=8, sliding_window=True, window_size=224,
                             stride=224, pad_to_multiple=16)
        return Evaluator(model, reduction=8, pad_to_multiple=16)

    # ms per image and peak memory, bf16 then fp32; the bound: matmul and
    # convolution FLOP of the kernel path (FlopCounterMode sees no kernel)
    # plus the attention's 4 L^2 64 per head and layer
    attn_flops = 12 * 4 * H * FULL_L * FULL_L * 64
    for dtype, reps, peak, cli in ((torch.bfloat16, 5, PEAK_BF16, cli_count),
                                   (torch.float32, 2, PEAK_FP32, cli32_count)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        ev = evaluator(dtype)
        density = ev.predict_density(image)
        check(tuple(density.shape) == (IMAGE_HW[0] // 8, IMAGE_HW[1] // 8),
              f"full-image density shape {tuple(density.shape)}")
        check(bool(torch.isfinite(density).all()), "full-image density has non-finite values")
        count = float(density.sum())
        check(abs(cli - count) <= 1e-2 * abs(count), f"{tag}: CLI count {cli} differs from {count}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_image(ev, image, reps=reps)
        peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
        ev.model.requires_grad_(False)
        counter = FlopCounterMode(display=False)
        with counter:
            ev.predict_count(image)
        flops = float(counter.get_total_flops()) + attn_flops
        print(f"full image {IMAGE_HW[0]}x{IMAGE_HW[1]} ({FULL_L} tokens), {tag}: {ms:.2f} ms/image "
              f"(median of {reps} after one warm-up), peak memory {peak_mem:.2f} GiB, count "
              f"{count:.4f}; bound {flops / 1e12:.3f} TFLOP ({attn_flops / 1e12:.3f} of attention) / "
              f"{peak / 1e12:.0f} TFLOP/s = {flops / peak * 1e3:.2f} ms ({ms / (flops / peak * 1e3):.1f}x)")
        if profile and dtype == torch.bfloat16:
            from torch.profiler import ProfilerActivity, profile as prof

            with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                ev.predict_count(image)
                torch.cuda.synchronize()
            print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        del ev, density

    # kernel path against the plain path where the plain path's scores fit
    small = normalize_image(np.random.default_rng(1).integers(0, 256, PLAIN_HW + (3,)).astype(np.float32) / 255.0)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-3)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        _full_counters(reset=True)
        got = evaluator(dtype).predict_count(small)
        torch.cuda.synchronize()
        check(_full_counters()["flash_tiled"] == 12, f"{tag}: the {PLAIN_HW} image took no tiled kernel")
        want = evaluator(dtype, attn_backend="sdpa", fused_head="off").predict_count(small)
        rel = abs(got - want) / abs(want)
        print(f"full image {PLAIN_HW[0]}x{PLAIN_HW[1]}, {tag}: kernels {got:.4f}, plain path {want:.4f}; "
              f"|diff|/count {rel:.2e} (tol {tol:g})")
        check(rel <= tol, f"{tag}: full-image kernel path and plain path disagree")

    # the flagship windows and the text tower through attn_backend="flash"
    for dtype, tol, name in ((torch.bfloat16, 1e-2, "flash_short"), (torch.float32, 1e-3, "flash_short_fp32")):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        ev = evaluator(dtype, windows=True, attn_backend="flash")
        _full_counters(reset=True)
        ev.text_features()
        text_n = _full_counters()["flash_short"]
        _full_counters(reset=True)
        got = ev.predict_count(image)
        torch.cuda.synchronize()
        n = _full_counters()
        check(text_n == 12 and n["flash_short"] == 12 and n["fused_ln_qkv_attention"] == 0,
              f"{tag}: attn_backend='flash' launched {text_n} (text) and {n} (windows)")
        kernels[name]["launches"] = text_n + n["flash_short"]
        fused = evaluator(dtype, windows=True)
        want = fused.predict_count(image)
        rel = abs(got - want) / abs(want)
        ms, fused_ms = time_image(ev, image), time_image(fused, image)
        print(f"windows, attn_backend='flash', {tag}: 12 short launches in the text tower and 12 "
              f"per forward; count {got:.4f} vs fused kernel path {want:.4f}, |diff|/count {rel:.2e} "
              f"(tol {tol:g}); {ms:.2f} ms/image (fused kernel path {fused_ms:.2f})")
        check(rel <= tol, f"{tag}: flash-backend windows and the fused kernel path disagree")
        del ev, fused


def _quant_attn_counters(reset: bool = False) -> dict:
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head

    q = fa.fused_ln_qkv_attention_int8
    names = {"int8_attention_static": (q, "launches_static"),
             "int8_attention_dynamic": (q, "launches_dynamic"),
             "fused_ln_qkv_attention_int8": (q, "launches"), "ln_qkv_proj_int8": (q, "launches_proj"),
             "int8_attention_body": (q, "launches_attn"),
             "fused_qkv_attention": (fa.fused_qkv_attention, "launches"),
             "fused_ln_qkv_attention": (fa.fused_ln_qkv_attention, "launches"),
             "fused_ebc_head": (fused_ebc_head, "launches")}
    if reset:
        _off_path_counters(reset=True)
        for f, attr in names.values():
            setattr(f, attr, 0)
    return {k: getattr(f, attr) for k, (f, attr) in names.items()}


def run_cli_quant_attn(img_dir: str, out: str, mode: str, amp: bool, window: int = 224) -> tuple:
    """The predict CLI by windows of ``window`` px with ``--quant
    int8_static --quant_attn MODE``, counters zeroed just before and read
    just after: ``(count, launches)``."""
    from clip_ebc_tpu_torch.cli import predict

    argv = [img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
            "--num_vpt", "32", "--sliding_window", "--window_size", str(window), "--stride",
            str(window), "--seed", "0", "--quant", "int8_static", "--calib_images", "2", "--out",
            out, "--quant_attn"] + ([] if mode == "kernel" else [mode]) + (["--amp"] if amp else [])
    _quant_attn_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _quant_attn_counters()
    tag = (f"--window_size {window} --quant int8_static --quant_attn {mode}, "
           + ("bf16 (--amp)" if amp else "fp32"))
    print(f"predict CLI, {tag}: {secs:.1f} s (model build, weights, calibration, one image); "
          f"launches {launches}")
    _tally_off_path(f"predict CLI, {tag}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"CSV has {len(rows)} rows")
    count = float(rows[0]["count"])
    check(math.isfinite(count), f"{tag}: CLI count {count} is not finite")
    # one calibration batch (the float attention of the dynamic twin: the
    # kernel up to 320 tokens, plain past them) and one static forward: the
    # int8 attention kernel in every block ("kernel", to 512 tokens), or the
    # plain integer products and no attention kernel ("xla")
    want = {"int8_attention_static": 12 if mode == "kernel" else 0, "int8_attention_dynamic": 0,
            "fused_ln_qkv_attention_int8": 0, "ln_qkv_proj_int8": 12 if mode == "kernel" else 0,
            "int8_attention_body": 12 if mode == "kernel" else 0,
            "fused_qkv_attention": 12 if window == 224 else 0,
            "fused_ln_qkv_attention": 0, "fused_ebc_head": 2}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    return count, launches


def phase_quant_attn(dev, kernels: dict, profile: bool) -> None:
    import argparse

    from clip_ebc_tpu_torch.cli._common import calibrate_static_int8
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.ops.quant import load_quant_state, quant_state
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        cli_counts = {}
        for mode, amp in (("kernel", True), ("kernel", False), ("xla", True)):
            tag = f"{mode} {'bf16' if amp else 'fp32'}"
            cli_counts[tag], n = run_cli_quant_attn(img_dir, os.path.join(tmp, f"{mode}{amp}.csv"),
                                                    mode, amp)
            if mode == "kernel":
                kernels["int8_attention_static" + ("" if amp else "_fp32")]["launches"] = \
                    n["int8_attention_static"]
                if amp:
                    kernels["int8_attention_body"]["launches"] = n["int8_attention_body"]
        # windows of 433 tokens: the kernel route where the parent ran float
        # attention; its count against the xla mode's at the same windows
        long_counts = {}
        for mode in ("kernel", "xla"):
            long_counts[mode], n = run_cli_quant_attn(
                img_dir, os.path.join(tmp, f"long_{mode}.csv"), mode, True, LONG_WINDOW)
            if mode == "kernel":
                kernels[f"int8_attention_static_l{LONG_L}"]["launches"] = n["int8_attention_static"]
        rel = abs(long_counts["kernel"] - long_counts["xla"]) / abs(long_counts["xla"])
        print(f"--window_size {LONG_WINDOW} ({LONG_B} windows of {LONG_L} tokens), bf16: counts "
              f"kernel {long_counts['kernel']:.4f}, xla {long_counts['xla']:.4f}; |diff|/count "
              f"{rel:.2e} (tol 2e-2)")
        check(rel <= 2e-2, f"--window_size {LONG_WINDOW}: --quant_attn kernel and xla counts disagree")
        image = normalize_image(_load_image(path))

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    args = argparse.Namespace(model="clip_vit_b_16", input_size=224, reduction=8, window_size=224)

    def evaluator(**kw):
        kw = dict(dict(dtype=torch.bfloat16, num_vpt=32, seed=0, device=dev), **kw)
        model = get_model("clip_vit_b_16", 224, 8, bins, anchors, **kw)
        return Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                         pad_to_multiple=16), kw

    kernel, kw = evaluator(quant_int8=True, quant_mode="static", quant_attn=True)
    calibrate_static_int8(args, {k: v for k, v in kw.items() if k != "quant_mode"}, bins, anchors,
                          kernel.model, [image])
    state = quant_state(kernel.model)
    xla, _ = evaluator(quant_int8=True, quant_mode="static", quant_attn="xla")
    static, _ = evaluator(quant_int8=True, quant_mode="static")
    for ev in (xla, static):
        load_quant_state(ev.model, state)
    bf16, _ = evaluator()
    paths = {"int8_static --quant_attn kernel": kernel, "int8_static --quant_attn xla": xla,
             "int8_static": static, "bf16": bf16}
    counts, ms = {}, {}
    for name, ev in paths.items():
        density = ev.predict_density(image)
        check(tuple(density.shape) == (IMAGE_HW[0] // 8, IMAGE_HW[1] // 8),
              f"{name}: density shape {tuple(density.shape)}")
        check(bool(torch.isfinite(density).all()), f"{name}: density has non-finite values")
        counts[name] = float(density.sum())
    for name, ev in paths.items():
        ms[name] = time_image(ev, image)
    ref = counts["bf16"]
    k_count, x_count = counts["int8_static --quant_attn kernel"], counts["int8_static --quant_attn xla"]
    rel_kx = abs(k_count - x_count) / abs(k_count)
    print(f"flagship image, --quant_attn: " + ", ".join(f"{k} {v:.2f} ms/image" for k, v in ms.items())
          + "; counts " + ", ".join(f"{k} {v:.4f}" for k, v in counts.items())
          + f"; kernel vs xla |diff|/count {rel_kx:.2e} (tol 2e-2); CLI counts "
          + ", ".join(f"{k} {v:.2f}" for k, v in cli_counts.items()))
    check(rel_kx <= 2e-2, "--quant_attn kernel and xla counts disagree")
    for name, count in list(counts.items())[:3] + [(f"CLI {k}", v) for k, v in cli_counts.items()]:
        rel = abs(count - ref) / abs(ref)
        print(f"  {name}: |count - bf16 count|/count {rel:.2e} (tol 8e-2)")
        check(rel <= 8e-2, f"{name}: count {count} is more than 8e-2 from the bf16 count {ref}")
    check(abs(cli_counts["kernel bf16"] - k_count) <= 1e-2 * abs(k_count),
          "--quant_attn CLI count differs from the Evaluator's")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            kernel.predict_count(image)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


NWPU_SIZES = {3099: (1024, 768), 3098: (768, 1024)}  # phase 3d's test tree


def nwpu_images(tmp: str) -> str:
    """Phase 3d's synthetic NWPU test tree under ``tmp`` (two seeded
    JPEGs); returns its image directory."""
    from PIL import Image

    img_dir = os.path.join(tmp, "data", "nwpu", "test", "images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(2)
    for iid, hw in NWPU_SIZES.items():
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8), "RGB").save(
            os.path.join(img_dir, f"{iid}.jpg"))
    return img_dir


def nwpu_tree(dev, tmp: str) -> tuple:
    """Phase 3d's synthetic NWPU test tree under ``tmp`` and a weights file
    of a seeded model: ``(image dir, weights)``."""
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.models import get_model

    img_dir = nwpu_images(tmp)
    bins, anchors = get_bins_and_anchors(8, 4, "nwpu")
    weights = os.path.join(tmp, "ckpt", "best", "1.pt")
    os.makedirs(os.path.dirname(weights))
    model = get_model("clip_vit_b_16", 224, 8, bins, anchors, seed=5, device=dev)
    torch.save(model.state_dict(), weights)
    return img_dir, weights


def read_submission(path: str) -> list:
    """The ``{id} {count}`` lines of an NWPU submission file, checked for
    the format's missing trailing newline."""
    with open(path) as f:
        text = f.read()
    check(not text.endswith("\n"), "the submission file ends in a newline")
    return [line.split(" ") for line in text.split("\n")]


def phase_nwpu(dev) -> None:
    """``cli/test_nwpu.py`` on a synthetic NWPU test tree, whole images in
    bf16, against the predict CLI on the same images and weights."""
    from clip_ebc_tpu_torch.cli import predict, test_nwpu

    sizes = NWPU_SIZES
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, weights = nwpu_tree(dev, tmp)
        _full_counters(reset=True)
        t0 = time.perf_counter()
        test_nwpu.main(["--data_root", os.path.join(tmp, "data"), "--weight_path", weights,
                        "--result_dir", os.path.join(tmp, "results"), "--amp", "--disable_size_check"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _full_counters()
        _tally_off_path("test_nwpu CLI")
        lines = read_submission(os.path.join(tmp, "results", "best_1.txt"))
        check([r[0] for r in lines] == ["3098", "3099"], f"submission ids {[r[0] for r in lines]}")
        check(n["flash_tiled"] == 24 and n["fused_ln_qkv_attention"] == 0,
              f"test_nwpu launches {n}, expected 24 tiled")
        dens = os.path.join(tmp, "dens")
        predict.main([img_dir, "--bins_dataset", "nwpu", "--weight_path", weights, "--amp",
                      "--save_density", dens, "--out", os.path.join(tmp, "p.csv"), "--device", str(dev)])
        for iid, count in lines:
            want = float(np.load(os.path.join(dens, f"{iid}.npy")).astype(np.float64).sum())
            check(math.isfinite(float(count)) and abs(float(count) - want) <= 1e-5 * abs(want),
                  f"test_nwpu count {count} of {iid} differs from the predict CLI's {want}")
        print(f"test_nwpu CLI, 2 whole images ({sizes[3098][0]}x{sizes[3098][1]}, "
              f"{sizes[3099][0]}x{sizes[3099][1]}), bf16: {secs:.1f} s (model build, weights, "
              f"2 images); launches {n}; counts {[c for _, c in lines]} equal the predict CLI's")


def _train_counters(reset: bool = False) -> dict:
    from clip_ebc_tpu_torch.ops import fused_attention as fa
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head

    fns = {"fused_ln_qkv_attention": (fa.fused_ln_qkv_attention, "launches"),
           "ln_qkv_proj": (fa.fused_ln_qkv_attention, "launches_proj"),
           "attention_bwd": (fa.attention_bwd, "launches"),
           "ln_qkv_bwd_frozen": (fa.ln_qkv_bwd_frozen, "launches"),
           "ln_bwd_dx": (fa.ln_bwd_dx, "launches"),
           "fused_ebc_head": (fused_ebc_head, "launches")}
    if reset:
        _off_path_counters(reset=True)
        for f, attr in fns.values():
            setattr(f, attr, 0)
    return {k: getattr(f, attr) for k, (f, attr) in fns.items()}


def _flagship_model(dev, dtype, **paths):
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.models import get_model

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    return get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=dtype, num_vpt=32, seed=42,
                     device=dev, **paths)


def run_trainer(dev, data_root: str, ckpt_dir: str, amp: bool, extra: tuple = ()) -> dict:
    """The trainer CLI for one epoch (4 steps) and one evaluation (with the
    flags ``extra`` too), counters zeroed just before and read just after;
    returns them with the epoch's loss terms (the checkpoint's loss
    history)."""
    from clip_ebc_tpu_torch.cli import trainer

    argv = train_flags() + ["--total_epochs", "1", "--eval_start", "1", "--data_root", data_root,
                            "--ckpt_dir", ckpt_dir, "--eval_disable_size_check",
                            "--device", str(dev), *extra]
    argv += ["--amp"] if amp else []
    _train_counters(reset=True)
    t0 = time.perf_counter()
    trainer.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _train_counters()
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    mode = ("bf16 (--amp)" if amp else "fp32 (default)") + "".join(f" {a}" for a in extra)
    _tally_off_path(f"trainer CLI, {mode}")
    print(f"trainer CLI, {mode}: {secs:.1f} s (model build, {_steps()} steps, eval, "
          f"checkpoints); launches {launches}; epoch {meta['loss_history'][-1]}; "
          f"val {meta['best_scores']}")
    return {"launches": launches, "loss": meta["loss_history"][-1]["loss"]}


def _steps() -> int:
    return TRAIN_IMAGES // (TRAIN_B // 2)


def _group_err(got: dict, want: dict, prefixes: tuple) -> float:
    names = sorted(n for n in want if n.startswith(prefixes))
    a = torch.cat([got[n].float().flatten() for n in names])
    b = torch.cat([want[n].float().flatten() for n in names])
    return float((a - b).norm() / b.norm())


def _step_grads(dev, dtype, batch, **paths) -> dict:
    """Gradients of the flagship model's training loss on ``batch``."""
    from clip_ebc_tpu_torch.config import ExperimentConfig
    from clip_ebc_tpu_torch.losses import make_loss_fn

    cfg = ExperimentConfig(model="clip_vit_b_16", dataset="qnrf", input_size=TRAIN_SIZE,
                           reduction=8, truncation=4, count_loss="dmcount").normalize()
    model = _flagship_model(dev, dtype, **paths).train()
    with torch.no_grad():
        text = model.encode_text()
    logits, density = model(batch.images, text_feats=text)
    loss, _ = make_loss_fn(cfg)(logits, density, batch)
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def time_steps(trainer, batch, text, reps: int = 10, warmup: int = 2) -> float:
    """Median wall ms of one optimizer step on ``batch`` (ends in a
    synchronize) after ``warmup`` steps."""
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, text)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(fn, cpu: bool = True) -> tuple:
    """``fn()`` under torch.profiler, ending in a synchronize: ``(profile,
    wall ms, device busy ms, host CPU ms)``. Busy is the kernel and copy
    events only (an operator's own device time repeats its kernels'; the
    profiler's buffer entry is not work); idle share = 1 - busy / wall.
    ``cpu=False`` traces the device alone (no host CPU ms): after a trace
    of both, a later device-only trace in the process (phase 5's) records
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with prof(activities=activities + [ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in p.events() if e.name != "Activity Buffer Request"]
    busy = sum(e.device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3
    host = sum(e.self_cpu_time_total for e in events if e.device_type == DeviceType.CPU) / 1e3
    return p, wall, busy, host


def profile_step(trainer, batch, text, tag: str) -> None:
    """Device time of one training step by CUDA kernel (torch.profiler),
    the step's wall time under the profiler and the device's idle share."""
    p, wall, busy, host = profiled(lambda: trainer.train_step(batch, text))
    print(f"profiled training step {tag}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall:.2f}), host CPU {host:.2f} ms")
    print(p.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


def profile_image(evaluator, image, tag: str) -> None:
    """Device time of one image through ``evaluator`` by CUDA kernel
    (torch.profiler), its wall time under the profiler and the device's
    idle share, as :func:`profile_step` reads a step."""
    p, wall, busy, _ = profiled(lambda: evaluator.predict_count(image))
    print(f"profiled image {tag}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall:.2f})")
    print(p.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))


def phase_training(dev, kernels: dict, profile: bool) -> None:
    from clip_ebc_tpu_torch.cli import predict
    from clip_ebc_tpu_torch.config import ExperimentConfig
    from clip_ebc_tpu_torch.data.crowd import CrowdDataset
    from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.losses import make_loss_fn
    from clip_ebc_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "qnrf",
                                            n_train=TRAIN_IMAGES, n_val=2, size=DATA_HW, seed=0)
        print(f"synthetic qnrf ({TRAIN_IMAGES} train, 2 val, {DATA_HW[0]} x {DATA_HW[1]}): "
              f"{time.perf_counter() - t0:.1f} s")
        for amp in (True, False):
            dtype = torch.bfloat16 if amp else torch.float32
            ckpt = os.path.join(tmp, f"ckpt_{'bf16' if amp else 'fp32'}")
            init = {k: v.cpu() for k, v in _flagship_model(dev, dtype).state_dict().items()}
            res = run_trainer(dev, data, ckpt, amp)
            n, steps = res["launches"], _steps()
            check(math.isfinite(res["loss"]), f"training loss {res['loss']} is not finite")
            if amp:
                check(n["ln_qkv_bwd_frozen"] == 12 * steps,
                      f"bf16: expected {12 * steps} frozen-backward launches")
                check(n["attention_bwd"] == 12 * steps and n["ln_bwd_dx"] == 12 * steps,
                      "bf16: the frozen backward runs one attention backward and one dx launch "
                      "per block")
                # the projection runs in every bf16 forward (the steps' and the
                # evaluation's) and in every frozen backward's recompute
                check(n["fused_ln_qkv_attention"] >= 12 * steps and n["ln_qkv_proj"] ==
                      n["fused_ln_qkv_attention"] + n["ln_qkv_bwd_frozen"],
                      f"bf16: LN + QKV projection launches {n['ln_qkv_proj']}, expected one per "
                      "forward and one per frozen backward")
                kernels["ln_qkv_proj"]["launches_train"] = n["ln_qkv_proj"]
                kernels["ln_qkv_bwd_frozen"]["launches"] = n["ln_qkv_bwd_frozen"]
                kernels["ln_bwd_dx"]["launches"] = n["ln_bwd_dx"]
                kernels["attention_bwd"]["launches"] = n["attention_bwd"]
            else:
                check(n["attention_bwd"] == 12 * steps and n["ln_qkv_bwd_frozen"] == 0,
                      f"fp32: expected {12 * steps} attention-backward launches, no frozen")
                kernels["attention_bwd_fp32"]["launches"] = n["attention_bwd"]
            best = os.path.join(ckpt, "best", "1.pt")
            trained = torch.load(best, map_location="cpu", weights_only=True)
            frozen = [k for k in init if k.startswith(("image_encoder.", "text_encoder."))]
            check(all(torch.equal(trained[k], init[k]) for k in frozen),
                  "a frozen trunk or text-tower parameter changed")
            for prefix in ("vpt_", "image_decoder.", "projection."):
                check(all(not torch.equal(trained[k], init[k]) for k in init
                          if k.startswith(prefix) and "num_batches" not in k),
                      f"a {prefix} parameter did not move")
            out = os.path.join(tmp, "val_counts.csv")
            predict.main([os.path.join(data, "qnrf", "val", "images"), "--sliding_window",
                          "--window_size", str(TRAIN_SIZE), "--stride", str(TRAIN_SIZE),
                          "--weight_path", best, "--out", out, "--device", str(dev)]
                         + (["--amp"] if amp else []))
            with open(out) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == 2 and all(math.isfinite(float(r["count"])) for r in rows),
                  "predict CLI on the trained checkpoint gave no finite counts")
            print(f"predict CLI on the trained checkpoint: counts {[r['count'] for r in rows]}")

        # one fixed batch: gradients against the plain path, then timed steps
        cfg = ExperimentConfig(model="clip_vit_b_16", dataset="qnrf", input_size=TRAIN_SIZE,
                               reduction=8, truncation=4, count_loss="dmcount",
                               batch_size=TRAIN_B, num_crops=2, warmup_lr=1e-3).normalize()
        ds = CrowdDataset("qnrf", "train", data, transforms=make_train_transforms(cfg),
                          num_crops=2, check_sizes=False)
        batch = next(iter(TrainLoader(ds, TRAIN_B, 8, seed=0))).to(dev)

    groups = {"vpt": ("vpt_",), "decoder": ("image_decoder.", "projection.")}
    ref32 = _step_grads(dev, torch.float32, batch, attn_backend="sdpa")
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        got = _step_grads(dev, dtype, batch)
        plain = ref32 if dtype == torch.float32 else _step_grads(dev, dtype, batch, attn_backend="sdpa")
        check(all(got[k] is not None for k in plain), f"{tag}: a trainable parameter got no gradient")
        for gname, prefixes in groups.items():
            err = _group_err(got, plain, prefixes)
            if dtype == torch.float32:
                bound = 1e-3
                print(f"step gradient {tag}, {gname}: kernel vs plain path rel L2 {err:.3e} "
                      f"(bound {bound:g})")
            else:
                bound = 5e-2
                print(f"step gradient {tag}, {gname}: kernel vs plain path rel L2 {err:.3e} "
                      f"(bound {bound:g}); plain bf16 vs plain fp32 "
                      f"{_group_err(plain, ref32, prefixes):.3e}")
            check(err <= bound, f"{tag} {gname} gradient disagrees with the plain path")
        del got, plain

    from torch.utils.flop_counter import FlopCounterMode

    for dtype, peak in ((torch.bfloat16, PEAK_BF16), (torch.float32, PEAK_FP32)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        model = _flagship_model(dev, dtype).train()
        trainer = Trainer(cfg, model, make_loss_fn(cfg))
        trainer.set_epoch_lr(1)
        text = trainer.text_features()
        torch.cuda.reset_peak_memory_stats(dev)  # the kernel path's peak, its model alone
        time_steps(trainer, batch, text, reps=1, warmup=1)
        peak_mem = torch.cuda.max_memory_allocated(dev) / 2**30
        plain_model = _flagship_model(dev, dtype, attn_backend="sdpa").train()
        plain_trainer = Trainer(cfg, plain_model, make_loss_fn(cfg))
        plain_trainer.set_epoch_lr(1)
        counter = FlopCounterMode(display=False)
        with counter:
            plain_trainer.train_step(batch, plain_trainer.text_features())
        flops = float(counter.get_total_flops())
        plain_text = plain_trainer.text_features()
        # in turns (plain, kernels, kernels, plain): the host clock drifts
        turns = [time_steps(plain_trainer, batch, plain_text, reps=5),
                 time_steps(trainer, batch, text, reps=5), time_steps(trainer, batch, text, reps=5),
                 time_steps(plain_trainer, batch, plain_text, reps=5)]
        ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        if profile:
            profile_step(plain_trainer, batch, plain_text, tag + ", plain path")
        del plain_model, plain_trainer
        bnd = flops / peak * 1e3
        print(f"training step {tag} ({TRAIN_B} windows of {TRAIN_SIZE}): kernels {ms:.2f} ms/step "
              f"({TRAIN_B / ms * 1e3:.0f} windows/s), plain path {plain_ms:.2f} ms/step "
              f"(turns plain, kernels, kernels, plain: {', '.join(f'{t:.2f}' for t in turns)}); "
              f"kernel path / plain path {ms / plain_ms:.3f}; peak memory {peak_mem:.2f} GiB; "
              f"bound {flops / 1e12:.3f} TFLOP (FlopCounterMode, plain path, forward + backward) "
              f"/ {peak / 1e12:.0f} TFLOP/s = {bnd:.2f} ms ({ms / bnd:.1f}x)")
        if profile:
            profile_step(trainer, batch, text, tag + ", kernel path")
        del model, trainer


# the non-CLIP slice: vgg19_ae at the JAX package's defaults (448 px crops,
# batch 8, reduction 8, truncation 4, shb bins) on a synthetic shb dataset of
# 32 train images (4 steps an epoch) and 2 val images of 512 x 768; the
# plain vit_b_16 at 224 px windows (197 tokens)
MODEL_SIZE, MODEL_B, VIT_SIZE, VIT_L = 448, 8, 224, 197


def model_flags(model: str, size: int) -> list:
    """The README's first trainer command (``vgg19_ae``), or the same flags
    for another model at ``size``."""
    return ["--model", model, "--dataset", "shb", "--input_size", str(size), "--reduction", "8",
            "--truncation", "4", "--count_loss", "dmcount", "--batch_size", str(MODEL_B)]


def run_model_trainer(dev, data_root: str, ckpt_dir: str, flags: list, amp: bool,
                      steps: int = TRAIN_IMAGES // MODEL_B) -> dict:
    """The trainer CLI for one epoch (``steps`` steps) and one evaluation
    with ``flags``, the kernels' counters zeroed just before and read just
    after."""
    from clip_ebc_tpu_torch.cli import trainer

    argv = flags + ["--total_epochs", "1", "--eval_start", "1", "--data_root", data_root,
                    "--ckpt_dir", ckpt_dir, "--eval_disable_size_check", "--device", str(dev)]
    argv += ["--amp"] if amp else []
    _train_counters(reset=True)
    t0 = time.perf_counter()
    trainer.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _train_counters()
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    tag = f"{flags[1]}{' --regression' if '--regression' in flags else ''}, " \
          f"{'bf16 (--amp)' if amp else 'fp32'}"
    _tally_off_path(f"trainer CLI, {tag}")
    loss = meta["loss_history"][-1]["loss"]
    check(math.isfinite(loss), f"trainer CLI, {tag}: loss {loss} is not finite")
    print(f"trainer CLI, {tag}: {secs:.1f} s (model build, {steps} steps, eval, "
          f"checkpoints); launches {launches}; epoch {meta['loss_history'][-1]}; "
          f"val {meta['best_scores']}")
    return launches


def _moved(init: dict, path: str, tag: str) -> None:
    trained = torch.load(path, map_location="cpu", weights_only=True)
    params = [k for k in init if "running_" not in k and "num_batches" not in k]
    check(sorted(trained) == sorted(init), f"{tag}: checkpoint keys differ from the model's")
    still = [k for k in params if torch.equal(trained[k], init[k])]
    check(not still, f"{tag}: parameters that did not train: {still[:4]}")


def host_probe_ms() -> float:
    """Median ms of a fixed pure-Python loop (1e5 additions) over 5 runs:
    the speed of the host core the step's Python runs on, to read beside
    a host-bound step's time."""
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        acc = 0
        for i in range(100_000):
            acc += i
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_clocks() -> str:
    """The card's SM clock, its maximum, and its power draw, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_step_events(trainer, batch, reps: int = 20, warmup: int = 2, text=None) -> tuple:
    """One optimizer step on ``batch`` (with the frozen prompt features
    ``text`` of a CLIP-EBC model), ``reps`` times: CUDA events around
    ``Trainer.train_step`` (the events' span ends at the step's last
    kernel; a synchronize follows each), and the host clock beside it.
    Returns (median, min, max) ms of each."""
    dev_ms, host_ms = [], []
    for i in range(warmup + reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        trainer.train_step(batch, text)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
    return tuple((statistics.median(t), min(t), max(t)) for t in (dev_ms, host_ms))


# the plain ViT's path against its plain twin: kernel outputs and gradients
# within a share of the plain version's largest magnitude, counts relative,
# a step's gradients relative L2 over every parameter
VIT_KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
VIT_COUNT_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
VIT_GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error over the largest magnitude of ``want``."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "a kernel output is not finite")
    return float((got - want).abs().max() / want.abs().max())


def _ln_qkv_inputs(dev, dtype, b: int, l: int, d: int, seed: int) -> list:
    """x, LN gamma and beta, the joint QKV weight (out, in) and its bias."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    return [t(rng.normal(size=(b, l, d))).to(dtype), t(1.0 + 0.1 * rng.normal(size=d)),
            t(0.1 * rng.normal(size=d)), t(rng.normal(size=(3 * d, d)) * d**-0.5).to(dtype),
            t(0.02 * rng.normal(size=3 * d))]


def vit_eps_errors(dev, dtype, b: int) -> tuple:
    """Row 2 at the plain ViT's 197 tokens with LayerNorm eps 1e-6, on rows
    of variance 1e-6, where eps 1e-5 would move every output: the kernel's
    scaled error against its plain version at eps 1e-6 and at eps 1e-5,
    and its launches in the call."""
    from clip_ebc_tpu_torch.ops.fused_attention import (fused_ln_qkv_attention,
                                                        ln_qkv_attention_plain)

    x, gam, be, w, bias = _ln_qkv_inputs(dev, dtype, b, VIT_L, D, seed=b)
    x = (x.float() * 1e-3).to(dtype)
    n0 = fused_ln_qkv_attention.launches
    got = fused_ln_qkv_attention(x, gam, be, w, bias, H, VIT_L, (D // H) ** -0.5, 1e-6)
    torch.cuda.synchronize()
    launches = fused_ln_qkv_attention.launches - n0
    errs = [_scaled_err(got, ln_qkv_attention_plain(x, gam, be, w, bias, H, VIT_L,
                                                     (D // H) ** -0.5, eps))
            for eps in (1e-6, 1e-5)]
    return errs[0], errs[1], launches


def split_backward_errors(dev, dtype, b: int, l: int, kv_len: int, d: int) -> tuple:
    """The backward of row 2 when the LayerNorm, the projection and its
    bias train (a plain ViT; CLIP's trunk is frozen): the split path, the
    plain LN + projection's autograd around the row 4 kernel. Returns the
    scaled errors of dx, dgamma, dbeta, dW and db against plain autograd
    through the plain version, and the launches of ``attention_bwd`` and
    ``ln_qkv_bwd_frozen`` in the backward."""
    from clip_ebc_tpu_torch.ops.fused_attention import (
        attention_bwd, fused_ln_qkv_attention, ln_qkv_attention_plain, ln_qkv_bwd_frozen)

    h, sm = d // 64, 0.125
    args = _ln_qkv_inputs(dev, dtype, b, l, d, seed=l)
    gout = torch.from_numpy(np.random.default_rng(7).normal(size=(b, l, d)).astype(np.float32))
    gout = gout.to(dev, dtype)
    gout[:, kv_len:] = 0  # rows past kv_len are not specified
    leaves = [a.clone().requires_grad_(True) for a in args]
    n0 = (attention_bwd.launches, ln_qkv_bwd_frozen.launches)
    out = fused_ln_qkv_attention(*leaves, h, kv_len, sm, 1e-6)
    got = torch.autograd.grad(out, leaves, gout)
    torch.cuda.synchronize()
    launches = (attention_bwd.launches - n0[0], ln_qkv_bwd_frozen.launches - n0[1])
    plain = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(ln_qkv_attention_plain(*plain, h, kv_len, sm, 1e-6), plain, gout)
    errs = {}
    for name, a, e in zip(("dx", "dgamma", "dbeta", "dW", "db"), got, want):
        check(a.shape == e.shape and a.dtype == e.dtype, f"split backward: {name} shape or type")
        errs[name] = _scaled_err(a, e)
    return errs, launches


def vit_pair(dev, dtype, seed: int, size: int = VIT_SIZE) -> tuple:
    """A seeded ``vit_b_16`` Classifier on the kernel path, and its plain
    twin (``attn_backend="sdpa"``) with the same weights."""
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.models import get_model

    bins, anchors = get_bins_and_anchors(8, 4, "shb")
    model = get_model("vit_b_16", size, 8, bins, anchors, dtype=dtype, seed=seed, device=dev)
    plain = get_model("vit_b_16", size, 8, bins, anchors, dtype=dtype, device=dev,
                      attn_backend="sdpa")
    plain.load_state_dict(model.state_dict())
    return model, plain


def _grads(model, loss_of) -> dict:
    model.train().zero_grad(set_to_none=True)
    loss_of(model).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    check(all(g is not None for g in grads.values()), "a parameter got no gradient")
    model.zero_grad(set_to_none=True)
    return grads


def vit_against_plain(model, plain, count_of, loss_of) -> dict:
    """The ViT's kernel path against its plain twin: ``count_of(m)`` (no
    grad) and the gradients of ``loss_of(m)``. Returns both counts, the
    launches of rows 2, 4 and 5 in the kernel path's count and in its
    step, the step's gradients on the plain path and their relative L2
    error over every parameter."""
    with torch.no_grad():
        _train_counters(reset=True)
        count = float(count_of(model.eval()))
        serve = _train_counters()
        plain_count = float(count_of(plain.eval()))
    _train_counters(reset=True)
    got = _grads(model, loss_of)
    torch.cuda.synchronize()
    train = _train_counters()
    want = _grads(plain, loss_of)
    return {"count": count, "plain_count": plain_count, "serve": serve, "train": train,
            "plain_grads": want, "grad_err": _group_err(got, want, tuple(want))}


def phase_vit_kernels(dev) -> None:
    """Rows 2 and 4 where the plain ViT's path differs from CLIP's
    (``vit_eps_errors``, ``split_backward_errors``), at the shapes of that
    path: 140 windows and a training batch of 197 tokens, width 768."""
    for dtype in (torch.bfloat16, torch.float32):
        tag, tol = ("bf16" if dtype == torch.bfloat16 else "fp32"), VIT_KERNEL_TOL[dtype]
        for b in (B, MODEL_B):
            err, err5, n = vit_eps_errors(dev, dtype, b)
            print(f"row 2 at eps 1e-6, {tag}, ({b}, {VIT_L}, {D}): max err {err:.2e} of the largest "
                  f"output (tol {tol:g}); against eps 1e-5 {err5:.2e}")
            check(n == 1 and err <= tol < err5, f"row 2 {tag} does not take eps 1e-6")
        errs, n = split_backward_errors(dev, dtype, MODEL_B, VIT_L, VIT_L, D)
        print(f"split backward, trainable LN + projection, {tag}, ({MODEL_B}, {VIT_L}, {D}): "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {tol:g})")
        check(n == (1, 0), f"{tag}: the split backward took {n} launches, not one attention_bwd")
        check(all(v <= tol for v in errs.values()), f"split backward {tag} disagrees with plain")


def phase_models(dev, kernels: dict, profile: bool) -> None:
    """The non-CLIP slice through the entry points: ``vgg19_ae`` trains
    (bf16, fp32) and ``--regression`` trains (bf16), each checkpoint
    serves through the predict CLI; ``vgg19_ae`` serves a whole 2048 x
    3072 image (bf16, fp32) and the NWPU CLI two images; the step's ms
    (CUDA events, host clock beside) against its bound; the plain
    ``vit_b_16`` Classifier serves by windows through row 2 and trains
    through rows 2 and 4, held to its plain twin."""
    from PIL import Image
    from torch.utils.flop_counter import FlopCounterMode

    from clip_ebc_tpu_torch.cli import predict, test_nwpu
    from clip_ebc_tpu_torch.config import ExperimentConfig, get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import CrowdDataset, _load_image, normalize_image
    from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.losses import make_loss_fn
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.training.evaluate import Evaluator
    from clip_ebc_tpu_torch.training.trainer import Trainer

    vit_serve, vit_train = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "shb",
                                            n_train=TRAIN_IMAGES, n_val=2, size=DATA_HW, seed=0)
        val = os.path.join(data, "shb", "val", "images")
        windows = ["--sliding_window", "--window_size", str(VIT_SIZE), "--stride", str(VIT_SIZE)]
        # (model, input size, bf16, flags of the trainer and the predict CLI)
        runs = [("vgg19_ae", MODEL_SIZE, True, []), ("vgg19_ae", MODEL_SIZE, False, []),
                ("vgg19_ae", MODEL_SIZE, True, ["--regression"]),
                ("vit_b_16", VIT_SIZE, True, windows), ("vit_b_16", VIT_SIZE, False, windows)]
        for i, (name, size, amp, extra) in enumerate(runs):
            cfg = ExperimentConfig(model=name, dataset="shb", input_size=size, reduction=8,
                                   truncation=4, regression="--regression" in extra).normalize()
            init = {k: v.cpu() for k, v in get_model(
                name, size, 8, cfg.bins, cfg.bin_anchors, seed=42, device=dev).state_dict().items()}
            ckpt = os.path.join(tmp, f"ckpt{i}")
            n = run_model_trainer(dev, data, ckpt, model_flags(name, size) + extra, amp)
            best = os.path.join(ckpt, "best", "1.pt")
            _moved(init, best, f"{name} {extra}")
            if name == "vit_b_16":
                steps = TRAIN_IMAGES // MODEL_B
                check(n["attention_bwd"] == 12 * steps and n["ln_qkv_bwd_frozen"] == 0,
                      f"vit_b_16 training launches {n}: expected {12 * steps} of attention_bwd")
                check(n["fused_ln_qkv_attention"] >= 12 * steps, f"vit_b_16 forward launches {n}")
                vit_train["bf16" if amp else "fp32"] = n
            else:
                check(not any(n.values()), f"{name} launched a kernel of the port: {n}")
            out = os.path.join(tmp, f"val{i}.csv")
            predict.main([val, "--model", name, "--input_size", str(size), "--bins_dataset", "shb",
                          "--weight_path", best, "--out", out, "--device", str(dev)]
                         + extra + (["--amp"] if amp else []))
            with open(out) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == 2 and all(math.isfinite(float(r["count"])) for r in rows),
                  f"predict CLI on the {name} {extra} checkpoint gave no finite counts")
            print(f"predict CLI on the {name} {' '.join(extra[:1])} checkpoint "
                  f"({'bf16' if amp else 'fp32'}): counts {[r['count'] for r in rows]}")

        # serving: vgg19_ae whole (the predict CLI's default mode), vit_b_16 by windows
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        image = normalize_image(_load_image(path))
        for amp in (True, False):
            out = os.path.join(tmp, f"vgg_{amp}.csv")
            _train_counters(reset=True)
            predict.main([img_dir, "--model", "vgg19_ae", "--seed", "0", "--out", out,
                          "--device", str(dev)] + (["--amp"] if amp else []))
            check(not any(_train_counters().values()), "vgg19_ae serving launched a kernel")
            with open(out) as f:
                count = float(next(csv.DictReader(f))["count"])
            check(math.isfinite(count), f"vgg19_ae whole-image count {count}")
            out = os.path.join(tmp, f"vit_{amp}.csv")
            _train_counters(reset=True)
            predict.main([img_dir, "--model", "vit_b_16", "--input_size", str(VIT_SIZE), "--seed",
                          "0", "--out", out, "--device", str(dev)] + windows
                         + (["--amp"] if amp else []))
            n = _train_counters()
            _tally_off_path("predict CLI, vit_b_16")
            check(n["fused_ln_qkv_attention"] == 12, f"vit_b_16 serving launches {n}: expected 12")
            vit_serve["bf16" if amp else "fp32"] = n["fused_ln_qkv_attention"]
            with open(out) as f:
                vit_cli = float(next(csv.DictReader(f))["count"])
            print(f"predict CLI, {'bf16' if amp else 'fp32'}: vgg19_ae whole image {count:.2f}; "
                  f"vit_b_16 by windows {vit_cli:.2f}, launches of row 2 {n['fused_ln_qkv_attention']}")

        # the NWPU CLI on two synthetic images
        nwpu = os.path.join(tmp, "nwpu_data", "nwpu", "test", "images")
        os.makedirs(nwpu)
        rng = np.random.default_rng(2)
        for iid, hw in {3098: (768, 1024), 3099: (1024, 768)}.items():
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8), "RGB").save(
                os.path.join(nwpu, f"{iid}.jpg"))
        bins, anchors = get_bins_and_anchors(8, 4, "nwpu")
        weights = os.path.join(tmp, "nwpu_ckpt", "best", "1.pt")
        os.makedirs(os.path.dirname(weights))
        torch.save(get_model("vgg19_ae", MODEL_SIZE, 8, bins, anchors, seed=5,
                             device=dev).state_dict(), weights)
        test_nwpu.main(["--model", "vgg19_ae", "--data_root", os.path.join(tmp, "nwpu_data"),
                        "--weight_path", weights, "--result_dir", os.path.join(tmp, "res"),
                        "--amp", "--disable_size_check", "--device", str(dev)])
        with open(os.path.join(tmp, "res", "best_1.txt")) as f:
            lines = [line.split(" ") for line in f.read().split("\n")]
        check([r[0] for r in lines] == ["3098", "3099"]
              and all(math.isfinite(float(r[1])) for r in lines), f"test_nwpu vgg19_ae: {lines}")
        print(f"test_nwpu CLI, vgg19_ae, 2 whole images, bf16: counts {[r[1] for r in lines]}")

        cfg = ExperimentConfig(model="vgg19_ae", dataset="shb", input_size=MODEL_SIZE,
                               reduction=8, truncation=4, count_loss="dmcount",
                               batch_size=MODEL_B).normalize()
        ds = CrowdDataset("shb", "train", data, transforms=make_train_transforms(cfg),
                          check_sizes=False)
        batch = next(iter(TrainLoader(ds, MODEL_B, 8, seed=0))).to(dev)
        vcfg = ExperimentConfig(model="vit_b_16", dataset="shb", input_size=VIT_SIZE,
                                reduction=8, truncation=4, count_loss="dmcount",
                                batch_size=MODEL_B).normalize()
        vds = CrowdDataset("shb", "train", data, transforms=make_train_transforms(vcfg),
                           check_sizes=False)
        vbatch = next(iter(TrainLoader(vds, MODEL_B, 8, seed=0))).to(dev)

    kernels["fused_ln_qkv_attention"]["launches_vit_serve"] = vit_serve["bf16"]
    kernels["fused_ln_qkv_attention_fp32"]["launches_vit_serve"] = vit_serve["fp32"]
    kernels["fused_ln_qkv_attention"]["launches_vit_train"] = vit_train["bf16"]["fused_ln_qkv_attention"]
    kernels["fused_ln_qkv_attention_fp32"]["launches_vit_train"] = vit_train["fp32"]["fused_ln_qkv_attention"]
    kernels["attention_bwd"]["launches_vit_train"] = vit_train["bf16"]["attention_bwd"]
    kernels["attention_bwd_fp32"]["launches_vit_train"] = vit_train["fp32"]["attention_bwd"]

    # vgg19_ae: whole-image ms and memory, and the training step against its bound
    bins, anchors = get_bins_and_anchors(8, 4, "shb")
    for dtype, peak in ((torch.bfloat16, PEAK_BF16), (torch.float32, PEAK_FP32)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        model = get_model("vgg19_ae", MODEL_SIZE, 8, bins, anchors, dtype=dtype, seed=0, device=dev)
        ev = Evaluator(model, reduction=8, pad_to_multiple=8)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_image(ev, image, reps=5)
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        flops, _ = image_flops(ev, image)
        model.requires_grad_(True)
        print(f"vgg19_ae whole image {IMAGE_HW[0]}x{IMAGE_HW[1]}, {tag}: {ms:.2f} ms/image (host "
              f"clock, upload to count), peak memory {mem:.2f} GiB; bound {flops / 1e12:.3f} TFLOP "
              f"(FlopCounterMode) / {peak / 1e12:.0f} TFLOP/s = {flops / peak * 1e3:.2f} ms "
              f"({ms / (flops / peak * 1e3):.1f}x)")
        trainer = Trainer(cfg, model.train(), make_loss_fn(cfg))
        trainer.set_epoch_lr(1)
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.train_step(batch)
        counter = FlopCounterMode(display=False)
        with counter:
            trainer.train_step(batch)
        step_flops = float(counter.get_total_flops())
        probe = host_probe_ms()
        (dev_ms, dev_lo, dev_hi), host = time_step_events(trainer, batch)
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        bnd = step_flops / peak * 1e3
        print(f"vgg19_ae training step {tag} ({MODEL_B} crops of {MODEL_SIZE} px), median of 20 "
              f"(min-max): {dev_ms:.2f} ms/step by CUDA events ({dev_lo:.2f}-{dev_hi:.2f}), "
              f"{host[0]:.2f} by the host clock ({host[1]:.2f}-{host[2]:.2f}); "
              f"{MODEL_B / dev_ms * 1e3:.1f} crops/s; host probe {probe:.2f} ms before, "
              f"{host_probe_ms():.2f} after; peak memory {mem:.2f} GiB; bound "
              f"{step_flops / 1e12:.3f} TFLOP (FlopCounterMode, forward + backward) / "
              f"{peak / 1e12:.0f} TFLOP/s = {bnd:.2f} ms ({dev_ms / bnd:.1f}x); card "
              f"{card_clocks()}")
        if profile:
            profile_step(trainer, batch, None, f"vgg19_ae {tag}")
        del model, trainer, ev

    # vit_b_16: the window count and the step's gradients against the plain path
    vloss = make_loss_fn(vcfg)
    ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        model, plain = vit_pair(dev, dtype, seed=1)
        evs = {m: Evaluator(m, reduction=8, sliding_window=True, window_size=VIT_SIZE,
                            stride=VIT_SIZE, pad_to_multiple=16) for m in (model, plain)}
        ms, plain_ms = (time_image(ev, image, reps=3) for ev in evs.values())
        out = vit_against_plain(model, plain, lambda m: evs[m].predict_count(image),
                                lambda m: vloss(*m(vbatch.images), vbatch)[0])
        count, plain_count = out["count"], out["plain_count"]
        rel = abs(count - plain_count) / abs(plain_count)
        print(f"vit_b_16 by windows ({B} x {VIT_L} tokens), {tag}: count {count:.4f}, plain path "
              f"{plain_count:.4f}, |diff|/count {rel:.2e} (tol {VIT_COUNT_TOL[dtype]:g}); "
              f"{ms:.2f} ms/image, plain path {plain_ms:.2f}")
        check(rel <= VIT_COUNT_TOL[dtype], f"vit_b_16 {tag}: the paths disagree on the count")
        check(out["serve"]["fused_ln_qkv_attention"] == 12, f"vit_b_16 {tag} count: {out['serve']}")
        n = out["train"]
        rows = (n["fused_ln_qkv_attention"], n["attention_bwd"], n["ln_qkv_bwd_frozen"])
        check(rows == (12, 12, 0),
              f"vit_b_16 {tag} step launches {n}: expected 12 of rows 2 and 4, none of row 5")
        ref32 = out["plain_grads"] if ref32 is None else ref32
        names = tuple(ref32)
        print(f"vit_b_16 step gradient {tag}: kernel vs plain path rel L2 {out['grad_err']:.3e} "
              f"(bound {VIT_GRAD_TOL[dtype]:g}); plain path vs plain fp32 "
              f"{_group_err(out['plain_grads'], ref32, names):.3e}")
        check(out["grad_err"] <= VIT_GRAD_TOL[dtype],
              f"vit_b_16 {tag} gradient disagrees with the plain path")
        del evs, model, plain, out

# phase 4c: the CLIP ResNets at the reference's run.sh flags (448 px crops,
# batch 8, reduction 8, word prompts, SHA bins), the other CLIP backbones
RN_SIZE, RN_B = 448, 8
OTHER_CLIP = ("resnet101", "resnet50x4", "resnet50x16", "resnet50x64", "vit_b_32")
CLIP_WINDOWS = 16  # windows of 224 px in the one batch each other backbone serves
L336_HW = (672, 1008)  # 2 x 3 windows of 336 px for ViT-L/14@336px


def _clip_cli(args: list, out: str) -> tuple:
    """The predict CLI with ``args``, counters zeroed just before and read
    just after: ``(count, launches, seconds)``."""
    from clip_ebc_tpu_torch.cli import predict

    _full_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(args + ["--out", out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _full_counters()
    _tally_off_path(f"predict CLI {' '.join(args[1:4])}")
    with open(out) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) >= 1 and all(math.isfinite(float(r["count"])) for r in rows),
          f"predict CLI {args[1:]}: no finite counts")
    return float(rows[0]["count"]), n, secs


def _set_plain(model, plain: bool) -> None:
    """Switch a CLIP-EBC model between its kernel paths and its plain twin
    (``attn_backend="sdpa"``, ``fused_head="off"``) in place: the same
    weights, no second build."""
    model.fused_head = "off" if plain else "auto"
    for m in model.modules():
        if hasattr(m, "attn_backend"):
            m.attn_backend = "sdpa" if plain else "auto"


def phase_clip_backbones(dev, kernels: dict, profile: bool) -> None:
    """The CLIP backbones beyond ViT-B/16 through the entry points: CLIP-EBC
    ``clip_resnet50`` serves the seeded 2048 x 3072 image whole and by
    224 px windows (bf16, fp32), the NWPU CLI two images, trains at the
    reference's run.sh flags on a synthetic ``sha`` (bf16, fp32; every
    parameter but the text tower's moves, the BatchNorm statistics with
    them) and its best checkpoint serves; each other CLIP ResNet and
    ``clip_vit_b_32`` serve one batch of 16 windows against their plain
    twins, ``clip_vit_b_32`` trains a 4-step VPT epoch; ``clip_vit_l_14``
    serves the image by windows (140 x 289 tokens: 24 launches of row 2 at
    D = 1024 a forward) in bf16 and fp32 against its plain twin, and whole
    in bf16 (24 tiled flash launches at 16 heads); ``clip_vit_l_14_336px``
    serves 336 px windows (609 tokens: the plain route in both packages).
    Row 1 is held to its plain version at C = 640, 768 and 1024."""
    from PIL import Image

    from clip_ebc_tpu_torch.cli import test_nwpu
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.ops.fused_head import ebc_head_plain, fused_ebc_head
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    # row 1 at the new widths (RN50x4 640, ViT-L and RN50x16 768, RN50 and
    # RN50x64 1024), 140 windows x 56 x 56 rows (reduction 8 at 448 px)
    _, anchors = get_bins_and_anchors(8, 4, "sha")
    g = torch.Generator(device=dev).manual_seed(40)
    anch = torch.tensor(anchors, device=dev)
    scale = torch.tensor(1 / 0.07, device=dev)
    for c in (640, 768, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            feats = torch.randn(B * 28 * 28, c, generator=g, device=dev).to(dtype)
            text = torch.randn(len(anchors), c, generator=g, device=dev)
            got, want = fused_ebc_head(feats, text, scale, anch), ebc_head_plain(feats, text, scale, anch)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-6), f"head at C = {c} disagrees")
            ms = time_spread(lambda: fused_ebc_head(feats, text, scale, anch))
            tag = str(dtype)[6:]
            print(f"head {tag} at C = {c} ({feats.shape[0]} rows): max abs err {err:.3e} (rtol 1e-4, "
                  f"atol 1e-6); {spread_str(ms)}")
            kernels["fused_ebc_head"][f"ms_c{c}" + ("_fp32" if dtype == torch.float32 else "")] = ms[0]
            del feats, got, want

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        image = normalize_image(_load_image(path))
        windows = ["--sliding_window", "--window_size", "224", "--stride", "224"]
        base = ["--reduction", "8", "--truncation", "4", "--seed", "0", "--device", str(dev)]

        # clip_resnet50: whole and by windows, bf16 and fp32
        for amp in (True, False):
            for extra in ([], windows):
                tag = f"{'bf16' if amp else 'fp32'}, {'windows' if extra else 'whole'}"
                count, n, secs = _clip_cli([img_dir, "--model", "clip_resnet50", *base, *extra]
                                           + (["--amp"] if amp else []),
                                           os.path.join(tmp, "rn.csv"))
                check(n["fused_ebc_head"] == 1 and n["fused_ln_qkv_attention"] == 0
                      and n["flash_tiled"] == 0, f"clip_resnet50 {tag}: launches {n}")
                kernels["fused_ebc_head"]["launches_resnet50"] = n["fused_ebc_head"]
                print(f"predict CLI, clip_resnet50, {tag}: count {count:.2f}, {secs:.1f} s (build, "
                      f"weights, one image); launches {n}")

        # the NWPU CLI, two images
        nwpu = os.path.join(tmp, "nwpu_data", "nwpu", "test", "images")
        os.makedirs(nwpu)
        rng = np.random.default_rng(3)
        for iid, hw in {3098: (768, 1024), 3099: (1024, 768)}.items():
            Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8), "RGB").save(
                os.path.join(nwpu, f"{iid}.jpg"))
        bins, anchors = get_bins_and_anchors(8, 4, "nwpu")
        weights = os.path.join(tmp, "nwpu_ckpt", "best", "1.pt")
        os.makedirs(os.path.dirname(weights))
        torch.save(get_model("clip_resnet50", 224, 8, bins, anchors, seed=6, device=dev).state_dict(),
                   weights)
        _full_counters(reset=True)
        test_nwpu.main(["--model", "clip_resnet50", "--data_root", os.path.join(tmp, "nwpu_data"),
                        "--weight_path", weights, "--result_dir", os.path.join(tmp, "res"), "--amp",
                        "--disable_size_check", "--device", str(dev)])
        n = _full_counters()
        with open(os.path.join(tmp, "res", "best_1.txt")) as f:
            lines = [line.split(" ") for line in f.read().split("\n")]
        check([r[0] for r in lines] == ["3098", "3099"] and n["fused_ebc_head"] == 2
              and all(math.isfinite(float(r[1])) for r in lines), f"test_nwpu clip_resnet50: {lines} {n}")
        print(f"test_nwpu CLI, clip_resnet50, 2 whole images, bf16: counts {[r[1] for r in lines]}; "
              f"launches {n}")

        # training at run.sh's flags, then the best checkpoint serves
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "sha", n_train=TRAIN_IMAGES,
                                            n_val=2, size=DATA_HW, seed=0)
        val = os.path.join(data, "sha", "val", "images")
        bins, anchors = get_bins_and_anchors(8, 4, "sha")
        init = {k: v.cpu() for k, v in get_model("clip_resnet50", RN_SIZE, 8, bins, anchors, seed=42,
                                                 device=dev).state_dict().items()}
        flags = ["--model", "clip_resnet50", "--dataset", "sha", "--input_size", str(RN_SIZE),
                 "--reduction", "8", "--truncation", "4", "--prompt_type", "word",
                 "--count_loss", "dmcount", "--batch_size", str(RN_B)]
        for amp in (True, False):
            ckpt = os.path.join(tmp, f"rn_ckpt_{amp}")
            n = run_model_trainer(dev, data, ckpt, flags, amp)
            check(n["fused_ln_qkv_attention"] == 0 and n["attention_bwd"] == 0,
                  f"clip_resnet50 training launched a trunk kernel: {n}")
            best = os.path.join(ckpt, "best", "1.pt")
            trained = torch.load(best, map_location="cpu", weights_only=True)
            text_same = all(torch.equal(trained[k], init[k]) for k in init if k.startswith("text_encoder."))
            still = [k for k in init if not k.startswith("text_encoder.") and "num_batches" not in k
                     and torch.equal(trained[k], init[k])]
            check(text_same and not still, f"clip_resnet50 training: text tower moved {not text_same}, "
                  f"still {still[:4]}")
            count, n, _ = _clip_cli([val, "--model", "clip_resnet50", "--input_size", str(RN_SIZE),
                                     "--bins_dataset", "sha", "--weight_path", best, *base]
                                    + (["--amp"] if amp else []), os.path.join(tmp, "rnval.csv"))
            print(f"predict CLI on the clip_resnet50 {'bf16' if amp else 'fp32'} checkpoint: "
                  f"count {count:.2f}; launches {n}")
            shutil.rmtree(ckpt)  # ~2 GB of weights and Adam moments

        # clip_resnet50: ms per whole image and per step against their bounds, peak memory
        from torch.utils.flop_counter import FlopCounterMode

        from clip_ebc_tpu_torch.config import ExperimentConfig
        from clip_ebc_tpu_torch.data.crowd import CrowdDataset
        from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
        from clip_ebc_tpu_torch.losses import make_loss_fn
        from clip_ebc_tpu_torch.training.trainer import Trainer

        cfg = ExperimentConfig(model="clip_resnet50", dataset="sha", input_size=RN_SIZE, reduction=8,
                               truncation=4, count_loss="dmcount", batch_size=RN_B).normalize()
        ds = CrowdDataset("sha", "train", data, transforms=make_train_transforms(cfg), check_sizes=False)
        batch = next(iter(TrainLoader(ds, RN_B, 8, seed=0))).to(dev)
        for dtype, peak in ((torch.bfloat16, PEAK_BF16), (torch.float32, PEAK_FP32)):
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            model = get_model("clip_resnet50", RN_SIZE, 8, cfg.bins, cfg.bin_anchors, dtype=dtype,
                              seed=0, device=dev)
            ev = Evaluator(model, reduction=8, pad_to_multiple=8)
            torch.cuda.reset_peak_memory_stats(dev)
            ms = time_image(ev, image, reps=3)
            mem = torch.cuda.max_memory_allocated(dev) / 2**30
            if profile:
                profile_image(ev, image, f"clip_resnet50 whole {tag}")
            flops, _ = image_flops(ev, image)
            for name, p in model.named_parameters():  # image_flops froze them all
                p.requires_grad_(not name.startswith("text_encoder."))
            print(f"clip_resnet50 whole image {IMAGE_HW[0]}x{IMAGE_HW[1]}, {tag}: {ms:.2f} ms/image "
                  f"(host clock, upload to count), peak memory {mem:.2f} GiB; bound "
                  f"{flops / 1e12:.3f} TFLOP (FlopCounterMode) / {peak / 1e12:.0f} TFLOP/s = "
                  f"{flops / peak * 1e3:.2f} ms ({ms / (flops / peak * 1e3):.1f}x)")
            trainer = Trainer(cfg, model.train(), make_loss_fn(cfg))
            trainer.set_epoch_lr(1)
            text = trainer.text_features()
            torch.cuda.reset_peak_memory_stats(dev)
            trainer.train_step(batch, text)
            counter = FlopCounterMode(display=False)
            with counter:
                trainer.train_step(batch, text)
            step_flops = float(counter.get_total_flops())
            (dev_ms, dev_lo, dev_hi), host = time_step_events(trainer, batch, reps=10, text=text)
            mem = torch.cuda.max_memory_allocated(dev) / 2**30
            bnd = step_flops / peak * 1e3
            print(f"clip_resnet50 training step {tag} ({RN_B} crops of {RN_SIZE} px), median of 10 "
                  f"(min-max): {dev_ms:.2f} ms/step by CUDA events ({dev_lo:.2f}-{dev_hi:.2f}), "
                  f"{host[0]:.2f} by the host clock ({host[1]:.2f}-{host[2]:.2f}); peak memory "
                  f"{mem:.2f} GiB; bound {step_flops / 1e12:.3f} TFLOP (FlopCounterMode, forward + "
                  f"backward) / {peak / 1e12:.0f} TFLOP/s = {bnd:.2f} ms ({dev_ms / bnd:.1f}x)")
            if profile:
                profile_step(trainer, batch, text, f"clip_resnet50 {tag}")
            del model, trainer, ev

        # one batch of 16 windows through each other CLIP ResNet and ViT-B/32, against
        # the plain twin (same weights); a 4-step VPT epoch of ViT-B/32
        bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
        x = torch.from_numpy(np.ascontiguousarray(
            np.stack([image[224 * (i // 8): 224 * (i // 8 + 1), 224 * (i % 8): 224 * (i % 8 + 1)]
                      for i in range(CLIP_WINDOWS)]), np.float32)
        ).to(dev)
        for name in OTHER_CLIP:
            model = get_model(f"clip_{name}", 224, 8, bins, anchors, dtype=torch.bfloat16, seed=0,
                              device=dev)
            with torch.no_grad():
                text = model.encode_text()
                _full_counters(reset=True)
                got = model(x, text_feats=text)
                torch.cuda.synchronize()
                n = _full_counters()
                _set_plain(model, True)
                want = model(x, text_feats=text)
            rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
            rows = 12 if name == "vit_b_32" else 0
            check(bool(torch.isfinite(got).all()) and got.shape == (CLIP_WINDOWS, 28, 28)
                  and n["fused_ebc_head"] == 1 and n["fused_ln_qkv_attention"] == rows
                  and rel <= 1e-2, f"clip_{name}: launches {n}, count vs plain {rel:.2e}")
            print(f"clip_{name}, {CLIP_WINDOWS} windows of 224 px, bf16: count {float(got.sum()):.3f}, "
                  f"plain twin {float(want.sum()):.3f} (|diff|/count {rel:.2e}, tol 1e-2); launches {n}")
            del model, got, want
        vdata = make_synthetic_crowd_dataset(os.path.join(tmp, "vdata"), "qnrf", n_train=TRAIN_IMAGES,
                                             n_val=2, size=DATA_HW, seed=0)
        vflags = ["--model", "clip_vit_b_32", "--dataset", "qnrf", "--input_size", "224",
                  "--reduction", "8", "--truncation", "4", "--num_vpt", "32", "--count_loss",
                  "dmcount", "--batch_size", str(TRAIN_B), "--num_crops", "2", "--sliding_window",
                  "--window_size", "224", "--stride", "224", "--warmup_lr", "1e-3"]
        n = run_model_trainer(dev, vdata, os.path.join(tmp, "vb32"), vflags, True)
        shutil.rmtree(os.path.join(tmp, "vb32"))
        steps = _steps()
        check(n["ln_qkv_bwd_frozen"] == 12 * steps and n["ln_bwd_dx"] == 12 * steps,
              f"clip_vit_b_32 VPT epoch: launches {n}, expected {12 * steps} of row 5")

        # ViT-L/14: windows (bf16, fp32) through the CLI, then against the plain twin; whole
        for amp in (True, False):
            count, n, secs = _clip_cli([img_dir, "--model", "clip_vit_l_14", *base, *windows]
                                       + (["--amp"] if amp else []), os.path.join(tmp, "vl.csv"))
            check(n["fused_ln_qkv_attention"] == 24 and n["fused_ebc_head"] == 1,
                  f"clip_vit_l_14 windows: launches {n}, expected 24 of row 2")
            row = kernels["fused_ln_qkv_attention_d1024" + ("" if amp else "_fp32")]
            row["launches"] = row["launches_vit_l"] = n["fused_ln_qkv_attention"]
            print(f"predict CLI, clip_vit_l_14, {'bf16' if amp else 'fp32'}, {VIT_L14.b} windows x "
                  f"{VIT_L14.l} tokens: count {count:.2f}, {secs:.1f} s; launches {n}")
        for dtype in (torch.bfloat16, torch.float32):
            model = get_model("clip_vit_l_14", 224, 8, bins, anchors, dtype=dtype, seed=0, device=dev)
            ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                           pad_to_multiple=14)
            _full_counters(reset=True)
            count = ev.predict_count(image)
            n = _full_counters()
            ms = time_image(ev, image, reps=3)
            _set_plain(model, True)
            ev._text_key = None
            plain = ev.predict_count(image)
            plain_ms = time_image(ev, image, reps=2)
            rel = abs(count - plain) / abs(plain)
            tol = VIT_COUNT_TOL[dtype]
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            check(rel <= tol and n["fused_ln_qkv_attention"] == 24,
                  f"clip_vit_l_14 {tag} windows: {rel:.2e} from the plain twin, launches {n}")
            print(f"clip_vit_l_14 by windows, {tag}: count {count:.4f}, plain twin {plain:.4f} "
                  f"(|diff|/count {rel:.2e}, tol {tol:g}); {ms:.1f} ms/image, plain {plain_ms:.1f}")
            if profile and dtype == torch.bfloat16:
                _set_plain(model, False)
                profile_image(ev, image, f"clip_vit_l_14 by windows {tag}")
            del model, ev
        count, n, secs = _clip_cli([img_dir, "--model", "clip_vit_l_14", *base, "--amp"],
                                   os.path.join(tmp, "vlw.csv"))
        check(n["flash_tiled"] == 24 and n["fused_ln_qkv_attention"] == 0,
              f"clip_vit_l_14 whole image: launches {n}, expected 24 tiled")
        kernels["flash_tiled"]["launches_vit_l"] = n["flash_tiled"]
        model = get_model("clip_vit_l_14", 224, 8, bins, anchors, dtype=torch.bfloat16, seed=0,
                          device=dev)
        ev = Evaluator(model, reduction=8, pad_to_multiple=14)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = time_image(ev, image, reps=2)
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"clip_vit_l_14 whole image, bf16: {ms:.1f} ms/image (host clock), peak memory "
              f"{mem:.2f} GiB")
        del model, ev
        # row 8 alone at ViT-L's whole image: 16 heads of 1 + 32 + 147 x 220 tokens
        from clip_ebc_tpu_torch.ops import flash_attention as fl

        vl = 1 + 32 + -(-IMAGE_HW[0] // 14) * -(-IMAGE_HW[1] // 14)
        q, k, v = _flash_inputs(dev, torch.bfloat16, 1, VIT_L14.h, vl, 44)
        got = fl.flash_tiled(q, k, v, 0.125)
        want = fl.flash_tiled_plain(q[:, :, :1024], k, v, 0.125, False)
        torch.cuda.synchronize()
        err = _check_scaled(f"flash_tiled at (1, {VIT_L14.h}, {vl}, 64), first 1024 queries",
                            got[:, :, :1024], want, 2e-2)
        tiled = time_spread(lambda: fl.flash_tiled(q, k, v, 0.125))
        sdpa = time_spread(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=0.125))
        bnd = bound_ms(4 * VIT_L14.h * vl * vl * 64, PEAK_BF16, 4 * VIT_L14.h * vl * 64 * 2)
        kernels["flash_tiled"].update(ms_vit_l=tiled[0], sdpa_ms_vit_l=sdpa[0], bound_ms_vit_l=bnd[0])
        print(f"flash_tiled at ViT-L's whole image (1, {VIT_L14.h}, {vl}, 64): max abs err {err:.3e}; "
              f"kernel {spread_str(tiled)}, SDPA forward {spread_str(sdpa)}, bound {bnd[0]:.3f} ms "
              f"({bnd[1]})")
        del q, k, v, got, want
        print(f"predict CLI, clip_vit_l_14, bf16, whole ({IMAGE_HW[0]}x{IMAGE_HW[1]}: "
              f"{1 + 32 + -(-IMAGE_HW[0] // 14) * -(-IMAGE_HW[1] // 14)} tokens): count {count:.2f}, "
              f"{secs:.1f} s; launches {n}")

        # ViT-L/14@336px: 336 px windows, 609 tokens, the plain route
        d336 = os.path.join(tmp, "img336")
        os.makedirs(d336)
        np.save(os.path.join(d336, "a.npy"),
                np.random.default_rng(1).integers(0, 256, L336_HW + (3,), dtype=np.uint8))
        count, n, secs = _clip_cli([d336, "--model", "clip_vit_l_14_336px", "--input_size", "336",
                                    "--sliding_window", "--window_size", "336", "--stride", "336",
                                    *base, "--amp"], os.path.join(tmp, "v336.csv"))
        check(n["fused_ln_qkv_attention"] == 0 and n["flash_tiled"] == 0 and n["fused_ebc_head"] == 1,
              f"clip_vit_l_14_336px: launches {n}, expected the plain route")
        print(f"predict CLI, clip_vit_l_14_336px, bf16, 6 windows of 336 px (609 tokens, plain "
              f"route): count {count:.2f}, {secs:.1f} s; launches {n}")


# ---- ViT-L's width: the D = 1024 kernels (phase 2) and phase 4d -----------------------


def _d1024(row: dict) -> dict:
    """A kernel row measured at ViT-L's shapes, named apart from its ViT-B row."""
    return dict(row, name=row["name"] + "_d1024")


def phase_kernels_d1024(dev) -> list:
    """The kernels widened to D = 1024 at ViT-L's shapes (``VIT_L14``),
    each against its plain version with the tolerance of its ViT-B check,
    timed by device time beside its bound and its yardstick, by the same
    phase functions as at D = 768: the frozen backward's dx launch and the
    whole row 5 at a training step (16 x 289 rows; ``torch.mm(d_qkv, W)``
    beside it), row 4 in bf16 and fp32 at 16 heads and 289 tokens (the
    SDPA backward beside it), the int8 LN + projection with both epilogues
    (``torch._int_mm`` on the bare product beside it), rows 2b, 2c (also at
    70 x 433 tokens) and 2d, the int8 attention body, the W8A8 MLP with its
    second launch bit-equal (``torch._int_mm`` beside it) and the dynamic
    scale pass, all at 140 x 289 tokens; and row 3 (the attention from a
    precomputed qkv, which ``--quant int8`` and every calibration batch
    run) at 140 and 16 x 289 tokens, bf16 and fp32 in one row (fp32 under
    ``*_fp32`` keys). Rows 2d, 6 and the scale pass are on no path, as at
    D = 768."""
    s = VIT_L14
    print(f"---- kernels at ViT-L's shapes: D = {s.d}, {s.h} heads, {s.b} x {s.l} tokens "
          f"({TRAIN_B} x {s.l} for the backward)")
    rows = [_d1024(phase_ln_bwd_dx(dev, s)), _d1024(phase_ln_qkv_bwd_frozen(dev, s)),
            _d1024(phase_attention_bwd(dev, s, torch.bfloat16)),
            _d1024(phase_attention_bwd(dev, s, torch.float32)),
            _d1024(phase_int8_proj(dev, s, torch.bfloat16)),
            _d1024(phase_attention_int8(dev, s, torch.bfloat16)),
            _d1024(phase_int8_attention_body(dev, s))]
    static = _d1024(phase_int8_attention_q(dev, s, torch.bfloat16, "static"))
    long = phase_int8_attention_q(dev, s._replace(b=LONG_B, l=LONG_L), torch.bfloat16, "static")
    static.update(ms_l433=long["ms"], bound_ms_l433=long["bound_ms"],
                  max_abs_err=max(static["max_abs_err"], long["max_abs_err"]))
    qkv = _d1024(phase_qkv_attention(dev, s, torch.bfloat16))
    qkv32 = phase_qkv_attention(dev, s, torch.float32)
    qkv.update({k + "_fp32": qkv32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "library_ms")})
    return rows + [static, _d1024(phase_int8_attention_q(dev, s, torch.bfloat16, "dynamic")),
                   *map(_d1024, phase_mlp_int8(dev, s, torch.bfloat16)),
                   _d1024(phase_qkv_quant_dynamic(dev, s, torch.bfloat16)), qkv]


def _set_quant_attn(model, mode) -> None:
    """Switch a static W8A8 model's attention mode in place (False, True
    for the int8 attention kernel, ``"xla"``): the same weights and scales,
    no second build."""
    from clip_ebc_tpu_torch.models.transformer import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.quant_attn = mode


VIT_L_STEPS = 2  # steps of the ViT-L VPT epoch: 16 train images of 2 crops


def _vit_l_model(dev, dtype, **kw):
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.models import get_model

    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    return get_model("clip_vit_l_14", TRAIN_SIZE, 8, bins, anchors, dtype=dtype, num_vpt=32,
                     device=dev, **dict(dict(seed=42), **kw))


def phase_vit_l(dev, kernels: dict, profile: bool) -> None:
    """ViT-L/14 trains by VPT and serves W8A8; the CLIP ResNets serve W8A8.

    1. The trainer CLI with the flagship flags on ``clip_vit_l_14`` (16
       windows of 224 px a step, 289 tokens, D = 1024; an epoch of
       VIT_L_STEPS steps on 16 synthetic ``qnrf`` images and one
       evaluation) in bf16 and fp32: 24 launches of row 5 (recompute, row 4,
       dx) a bf16 step, 24 of row 4 a fp32 step (the split path); the trunk
       and text tower unchanged, the prompts and the decoder moved.
    2. On one batch, the step's VPT and decoder gradients against the
       plain path (``attn_backend="sdpa"``, the same model switched in
       place): relative L2 <= 5e-2 bf16, <= 1e-3 fp32; 24 dx launches in
       the bf16 step; ms per step in turns (plain, kernels, kernels, plain)
       and peak memory.
    3. The predict CLI on the flagship image by 140 windows (289 tokens)
       under ``--quant int8_static``, ``--quant_attn kernel`` and ``xla``,
       ``--quant int8`` and unquantized, bf16: 24 launches of the int8
       projection a static forward, 24 of the int8 attention with
       ``kernel``, 24 of row 3 with ``int8``; then one model on one set of
       calibrated scales: the kernel path against its plain twin within
       1e-2 of the count, kernel against xla within 2e-2, each within 8e-2
       of bf16, and ms per image; and the ``int8`` model on the same
       weights against its plain twin within 1e-2.
    4. ``clip_resnet50`` by 224 px windows under ``--quant int8_static``
       (the Bottleneck decoder's convolutions in int8) beside bf16: within
       8e-2 of the bf16 count, the kernel path against its plain twin on one
       set of scales within 1e-2, ms per image."""
    import argparse

    from clip_ebc_tpu_torch.cli import predict
    from clip_ebc_tpu_torch.cli._common import calibrate_static_int8
    from clip_ebc_tpu_torch.config import ExperimentConfig, get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import CrowdDataset, _load_image, normalize_image
    from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.losses import make_loss_fn
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.ops.quant import load_quant_state, quant_state
    from clip_ebc_tpu_torch.training.evaluate import Evaluator
    from clip_ebc_tpu_torch.training.trainer import Trainer

    n_train = VIT_L_STEPS * TRAIN_B // 2
    flags = train_flags()
    flags[flags.index("clip_vit_b_16")] = "clip_vit_l_14"
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "qnrf", n_train=n_train,
                                            n_val=1, size=DATA_HW, seed=0)
        init = {k: v.cpu() for k, v in _vit_l_model(dev, torch.bfloat16).state_dict().items()}
        for amp in (True, False):
            ckpt = os.path.join(tmp, f"vl_{amp}")
            n = run_model_trainer(dev, data, ckpt, flags, amp, VIT_L_STEPS)
            if amp:
                check(n["ln_qkv_bwd_frozen"] == n["ln_bwd_dx"] == n["attention_bwd"]
                      == 24 * VIT_L_STEPS, f"clip_vit_l_14 bf16 epoch: launches {n}, expected "
                      f"{24 * VIT_L_STEPS} of row 5")
                kernels["ln_bwd_dx_d1024"]["launches"] = n["ln_bwd_dx"]
                kernels["ln_qkv_bwd_frozen_d1024"]["launches"] = n["ln_qkv_bwd_frozen"]
                kernels["attention_bwd_d1024"]["launches"] = n["attention_bwd"]
            else:
                check(n["attention_bwd"] == 24 * VIT_L_STEPS and n["ln_qkv_bwd_frozen"] == 0,
                      f"clip_vit_l_14 fp32 epoch: launches {n}, expected {24 * VIT_L_STEPS} of "
                      "row 4 and none of row 5")
                kernels["attention_bwd_fp32_d1024"]["launches"] = n["attention_bwd"]
            trained = torch.load(os.path.join(ckpt, "best", "1.pt"), map_location="cpu",
                                 weights_only=True)
            check(all(torch.equal(trained[k], init[k]) for k in init
                      if k.startswith(("image_encoder.", "text_encoder."))),
                  "clip_vit_l_14: a frozen trunk or text-tower parameter changed")
            for prefix in ("vpt_", "image_decoder.", "projection."):
                check(all(not torch.equal(trained[k], init[k]) for k in init
                          if k.startswith(prefix) and "num_batches" not in k),
                      f"clip_vit_l_14: a {prefix} parameter did not move")
            shutil.rmtree(ckpt)
        del init
        cfg = ExperimentConfig(model="clip_vit_l_14", dataset="qnrf", input_size=TRAIN_SIZE,
                               reduction=8, truncation=4, count_loss="dmcount",
                               batch_size=TRAIN_B, num_crops=2, warmup_lr=1e-3).normalize()
        ds = CrowdDataset("qnrf", "train", data, transforms=make_train_transforms(cfg),
                          num_crops=2, check_sizes=False)
        batch = next(iter(TrainLoader(ds, TRAIN_B, 8, seed=0))).to(dev)

    from torch.utils.flop_counter import FlopCounterMode

    groups = {"vpt": ("vpt_",), "decoder": ("image_decoder.", "projection.")}
    for dtype, peak in ((torch.bfloat16, PEAK_BF16), (torch.float32, PEAK_FP32)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        model = _vit_l_model(dev, dtype).train()
        loss_fn = make_loss_fn(cfg)
        with torch.no_grad():
            text = model.encode_text()
        grads = {}
        for plain in (False, True):
            _set_plain(model, plain)
            model.zero_grad(set_to_none=True)
            _train_counters(reset=True)
            logits, density = model(batch.images, text_feats=text)
            loss_fn(logits, density, batch)[0].backward()
            torch.cuda.synchronize()
            n = _train_counters()
            grads[plain] = {k: p.grad.clone() for k, p in model.named_parameters() if p.requires_grad}
            if not plain:
                want = ({"ln_bwd_dx": 24, "ln_qkv_bwd_frozen": 24, "attention_bwd": 24}
                        if dtype == torch.bfloat16 else {"ln_bwd_dx": 0, "attention_bwd": 24})
                check(all(n[k] == v for k, v in want.items()),
                      f"clip_vit_l_14 {tag} step: launches {n}, expected {want}")
        bound = VIT_GRAD_TOL[dtype]
        for gname, prefixes in groups.items():
            err = _group_err(grads[False], grads[True], prefixes)
            print(f"clip_vit_l_14 step gradient {tag}, {gname}: kernel vs plain path rel L2 "
                  f"{err:.3e} (bound {bound:g})")
            check(err <= bound, f"clip_vit_l_14 {tag} {gname} gradient disagrees with the plain path")
        del grads
        model.zero_grad(set_to_none=True)
        trainer = Trainer(cfg, model, loss_fn)
        trainer.set_epoch_lr(1)
        _set_plain(model, True)
        counter = FlopCounterMode(display=False)
        with counter:
            trainer.train_step(batch, text)
        flops = float(counter.get_total_flops())
        turns = []
        for plain in (True, False, False, True):
            _set_plain(model, plain)
            if not plain:
                torch.cuda.reset_peak_memory_stats(dev)
            turns.append(time_steps(trainer, batch, text, reps=3, warmup=1))
            if not plain:
                mem = torch.cuda.max_memory_allocated(dev) / 2**30
        ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        bnd = flops / peak * 1e3
        print(f"clip_vit_l_14 training step {tag} ({TRAIN_B} windows of {TRAIN_SIZE} px, "
              f"{VIT_L14.l} tokens): kernels {ms:.2f} ms/step, plain path {plain_ms:.2f} (turns "
              f"plain, kernels, kernels, plain: {', '.join(f'{t:.2f}' for t in turns)}); peak "
              f"memory {mem:.2f} GiB; bound {flops / 1e12:.3f} TFLOP / {peak / 1e12:.0f} TFLOP/s = "
              f"{bnd:.2f} ms ({ms / bnd:.1f}x)")
        if profile and dtype == torch.bfloat16:
            _set_plain(model, False)
            profile_step(trainer, batch, text, "clip_vit_l_14 bf16, kernel path")
        del model, trainer

    # W8A8 on ViT-L by windows, and on clip_resnet50
    bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        image = normalize_image(_load_image(path))
        base = [img_dir, "--model", "clip_vit_l_14", "--reduction", "8", "--truncation", "4",
                "--seed", "0", "--device", str(dev), "--amp", "--sliding_window", "--window_size",
                "224", "--stride", "224", "--calib_images", "1"]
        cli = {}
        for mode, extra in (("bf16", []), ("int8_static", ["--quant", "int8_static"]),
                            ("kernel", ["--quant", "int8_static", "--quant_attn"]),
                            ("xla", ["--quant", "int8_static", "--quant_attn", "xla"]),
                            ("int8", ["--quant", "int8"])):
            out = os.path.join(tmp, f"{mode}.csv")
            _quant_attn_counters(reset=True)
            t0 = time.perf_counter()
            predict.main(base + extra + ["--out", out])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = _quant_attn_counters()
            _tally_off_path(f"predict CLI, clip_vit_l_14 {mode}")
            with open(out) as f:
                cli[mode] = float(next(csv.DictReader(f))["count"])
            check(math.isfinite(cli[mode]), f"clip_vit_l_14 {mode}: count {cli[mode]}")
            # one forward of 140 windows (24 blocks), after a calibration
            # batch of 16 windows on the dynamic twin for the static modes
            static = mode in ("int8_static", "kernel", "xla")
            want = {"ln_qkv_proj_int8": 24 if mode in ("int8_static", "kernel") else 0,
                    "fused_ln_qkv_attention_int8": 24 if mode == "int8_static" else 0,
                    "int8_attention_static": 24 if mode == "kernel" else 0,
                    "int8_attention_body": 24 if mode == "kernel" else 0,
                    "int8_attention_dynamic": 0,
                    "fused_qkv_attention": 24 * static + 24 * (mode == "int8"),
                    "fused_ln_qkv_attention": 24 if mode == "bf16" else 0,
                    "fused_ebc_head": 2 if static else 1}
            check(n == want, f"clip_vit_l_14 {mode}: launches {n}, expected {want}")
            print(f"predict CLI, clip_vit_l_14, {mode}, bf16, {VIT_L14.b} windows x {VIT_L14.l} "
                  f"tokens: count {cli[mode]:.4f}, {secs:.1f} s; launches {n}")
            if mode == "int8_static":
                kernels["ln_qkv_proj_int8_d1024"]["launches"] = n["ln_qkv_proj_int8"]
                kernels["fused_ln_qkv_attention_int8_d1024"]["launches"] = \
                    n["fused_ln_qkv_attention_int8"]
            elif mode == "kernel":
                kernels["int8_attention_static_d1024"]["launches"] = n["int8_attention_static"]
                kernels["int8_attention_body_d1024"]["launches"] = n["int8_attention_body"]
            elif mode == "int8":
                kernels["fused_qkv_attention_d1024"]["launches"] = n["fused_qkv_attention"]
        rel_kx = abs(cli["kernel"] - cli["xla"]) / abs(cli["xla"])
        print(f"clip_vit_l_14 W8A8 CLI counts: kernel vs xla |diff|/count {rel_kx:.2e} (tol 2e-2); "
              + ", ".join(f"{k} {abs(v - cli['bf16']) / abs(cli['bf16']):.2e}" for k, v in cli.items()
                          if k != "bf16") + " from bf16 (tol 8e-2)")
        check(rel_kx <= 2e-2, "clip_vit_l_14: --quant_attn kernel and xla counts disagree")
        check(all(abs(v - cli["bf16"]) <= 8e-2 * abs(cli["bf16"]) for v in cli.values()),
              "clip_vit_l_14: a W8A8 count is more than 8e-2 from bf16")

    # one model on one set of scales: each mode against its plain twin, timed
    args = argparse.Namespace(model="clip_vit_l_14", input_size=224, reduction=8, window_size=224)
    kw = dict(dtype=torch.bfloat16, num_vpt=32, seed=0, device=dev, quant_int8=True,
              quant_attn=True)
    model = get_model("clip_vit_l_14", 224, 8, bins, anchors, quant_mode="static", **kw)
    calibrate_static_int8(args, kw, bins, anchors, model, [image])
    state = quant_state(model)
    check(len(state) == 24 * 5 + 2 and all(bool((v > 0).all()) for v in state.values()),
          "clip_vit_l_14: the quant state has zero or missing leaves")
    ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                   pad_to_multiple=14)
    counts, ms = {}, {}
    for mode, qa in (("int8_static", False), ("kernel", True), ("xla", "xla")):
        _set_quant_attn(model, qa)
        for plain in (False, True):
            _set_plain(model, plain)
            ev._text_key = None
            counts[(mode, plain)] = ev.predict_count(image)
        _set_plain(model, False)
        ev._text_key = None
        ms[mode] = time_image(ev, image, reps=3)
    del model, ev
    # --quant int8 (dynamic scales; row 3 after the int8 projection) on the same weights
    model = get_model("clip_vit_l_14", 224, 8, bins, anchors, quant_mode="dynamic",
                      **dict(kw, quant_attn=False))
    ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                   pad_to_multiple=14)
    for plain in (False, True):
        _set_plain(model, plain)
        ev._text_key = None
        _quant_attn_counters(reset=True)
        counts[("int8", plain)] = ev.predict_count(image)
        torch.cuda.synchronize()
        n = _quant_attn_counters()["fused_qkv_attention"]
        check(n == (0 if plain else 24), f"clip_vit_l_14 int8, plain={plain}: {n} launches of row 3")
    _set_plain(model, False)
    ev._text_key = None
    ms["int8"] = time_image(ev, image, reps=3)
    del model, ev
    for mode in ("int8_static", "xla", "int8"):
        rel = abs(counts[(mode, False)] - counts[(mode, True)]) / abs(counts[(mode, True)])
        print(f"clip_vit_l_14 {mode}: kernel path {counts[(mode, False)]:.4f}, plain twin "
              f"{counts[(mode, True)]:.4f} (|diff|/count {rel:.2e}, tol 1e-2)")
        check(rel <= 1e-2, f"clip_vit_l_14 {mode}: kernel path and plain path disagree")
    rel_kx = abs(counts[("kernel", False)] - counts[("xla", False)]) / abs(counts[("xla", False)])
    bf = get_model("clip_vit_l_14", 224, 8, bins, anchors, dtype=torch.bfloat16, num_vpt=32, seed=0,
                   device=dev)
    ev = Evaluator(bf, reduction=8, sliding_window=True, window_size=224, stride=224,
                   pad_to_multiple=14)
    bf_count = ev.predict_count(image)
    ms["bf16"] = time_image(ev, image, reps=3)
    del bf, ev
    print(f"clip_vit_l_14 by {VIT_L14.b} windows, one set of scales: kernel vs xla |diff|/count "
          f"{rel_kx:.2e} (tol 2e-2); "
          + ", ".join(f"{m} {counts[(m, False)]:.4f} ({abs(counts[(m, False)] - bf_count) / abs(bf_count):.2e}"
                      f" from bf16 {bf_count:.4f})" for m in ("int8_static", "kernel", "xla", "int8"))
          + "; ms/image " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    check(rel_kx <= 2e-2, "clip_vit_l_14: kernel and xla disagree on one set of scales")

    # clip_resnet50 W8A8: the Bottleneck decoder in int8, by 224 px windows
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        np.save(os.path.join(img_dir, "flagship.npy"),
                np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        rn = {}
        for mode, extra in (("bf16", []), ("int8_static", ["--quant", "int8_static"])):
            rn[mode], n, secs = _clip_cli(
                [img_dir, "--model", "clip_resnet50", "--reduction", "8", "--truncation", "4",
                 "--seed", "0", "--device", str(dev), "--amp", "--sliding_window", "--window_size",
                 "224", "--stride", "224", "--calib_images", "1", *extra], os.path.join(tmp, "rn.csv"))
            check(n["fused_ebc_head"] == (2 if extra else 1) and n["fused_ln_qkv_attention"] == 0,
                  f"clip_resnet50 {mode}: launches {n}")
            print(f"predict CLI, clip_resnet50, {mode}, bf16, by 224 px windows: count "
                  f"{rn[mode]:.4f}, {secs:.1f} s; launches {n}")
        rel = abs(rn["int8_static"] - rn["bf16"]) / abs(rn["bf16"])
        print(f"clip_resnet50 int8_static vs bf16 (CLI): |diff|/count {rel:.2e} (tol 8e-2)")
        check(rel <= 8e-2, "clip_resnet50: the int8_static count is more than 8e-2 from bf16")
    args = argparse.Namespace(model="clip_resnet50", input_size=224, reduction=8, window_size=224)
    kw = dict(dtype=torch.bfloat16, seed=0, device=dev, quant_int8=True)
    model = get_model("clip_resnet50", 224, 8, bins, anchors, quant_mode="static", **kw)
    calibrate_static_int8(args, kw, bins, anchors, model, [image])
    ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                   pad_to_multiple=8)
    count = ev.predict_count(image)
    ms_rn = time_image(ev, image, reps=3)
    _set_plain(model, True)
    plain = ev.predict_count(image)
    rel = abs(count - plain) / abs(plain)
    print(f"clip_resnet50 int8_static by windows: count {count:.4f}, plain twin {plain:.4f} "
          f"(|diff|/count {rel:.2e}, tol 1e-2); {ms_rn:.1f} ms/image")
    check(rel <= 1e-2, "clip_resnet50 int8_static: kernel path and plain path disagree")
    del model, ev


# phase 4e, data parallel: the flagship VPT step under DDP over NCCL (one
# rank), then two ranks sharing the card over gloo against one process on
# the global batch: the VPT step (16 windows, 8 a rank), clip_resnet50 at
# its run.sh flags (8 crops of 448 px, 4 a rank) and the flagship image by
# 140 windows (70 a rank)
DDP_WORLD, DDP_STEPS, DDP_TIMED, DDP_POINTS = 2, 2, 5, 64
DDP_GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}  # phase 4's
DDP_COUNT_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}  # phase 3's
DDP_STAT_TOL = 1e-4
DDP_CHILD_TIMEOUT = 240  # seconds, each rank


def _ddp_batch(n: int, size: int, seed: int):
    """A seeded global batch of ``n`` crops of ``size`` px with up to
    ``DDP_POINTS`` points each, on the CPU."""
    from clip_ebc_tpu_torch.data.loader import Batch

    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    points = np.zeros((n, DDP_POINTS, 2), np.float32)
    mask = np.zeros((n, DDP_POINTS), bool)
    density = np.zeros((n, size // 8, size // 8), np.float32)
    for i in range(n):
        k = int(rng.integers(0, DDP_POINTS + 1))
        points[i, :k] = rng.uniform(0, size, size=(k, 2))
        mask[i, :k] = True
        np.add.at(density[i], (points[i, :k, 1].astype(int) // 8,
                               points[i, :k, 0].astype(int) // 8), 1.0)
    return Batch(*map(torch.from_numpy, (images, points, mask, density)))


def _ddp_trainer(model_name: str, size: int, dataset: str, batch: int, model):
    from clip_ebc_tpu_torch.config import ExperimentConfig
    from clip_ebc_tpu_torch.losses import make_loss_fn
    from clip_ebc_tpu_torch.parallel import mesh
    from clip_ebc_tpu_torch.training.trainer import Trainer

    cfg = ExperimentConfig(model=model_name, dataset=dataset, input_size=size, reduction=8,
                           truncation=4, count_loss="dmcount", batch_size=batch,
                           warmup_lr=1e-3).normalize()
    trainer = Trainer(cfg, model.train(), make_loss_fn(cfg, mesh.get_world_size()))
    trainer.set_epoch_lr(1)
    return trainer


def _ddp_vpt(dev, dtype, timed: int = 0, save: str = "") -> dict:
    """``DDP_STEPS`` flagship VPT steps on this rank's shard of the global
    batch of ``TRAIN_B`` windows: the global losses, the launches, the
    first step's prompt and decoder gradients (saved to ``save``), then
    the median ms of ``timed`` more steps (host clock, synchronized)."""
    from clip_ebc_tpu_torch.losses import SUMMED_TERMS
    from clip_ebc_tpu_torch.models.blocks import BatchNorm
    from clip_ebc_tpu_torch.parallel import mesh

    model = _flagship_model(dev, dtype, axis_name=mesh.DATA_AXIS)
    trainer = _ddp_trainer("clip_vit_b_16", TRAIN_SIZE, "qnrf",
                           TRAIN_B // mesh.get_world_size(), model)
    check(mesh.get_world_size() == 1 or all(m.axis_name == mesh.DATA_AXIS for m in model.modules()
                                            if isinstance(m, BatchNorm)), "BatchNorm not synced")
    batch = mesh.shard_batch(_ddp_batch(TRAIN_B, TRAIN_SIZE, seed=1)).to(dev)
    text = trainer.text_features()
    _train_counters(reset=True)
    losses = []
    for step in range(DDP_STEPS):
        info = trainer.train_step(batch, text)
        losses.append(mesh.reduce_metrics(info, SUMMED_TERMS)["loss"])
        if step == 0 and save:
            torch.save({n: p.grad.float().cpu() for n, p in model.named_parameters()
                        if n.startswith(("vpt_", "image_decoder.", "projection."))}, save)
    torch.cuda.synchronize()
    out = {"losses": losses, "launches": _train_counters(),
           "ddp": type(trainer.net).__name__}
    if timed:
        out["ms"] = time_steps(trainer, batch, text, reps=timed, warmup=0)
    return out


def _ddp_rn50(dev, save: str = "") -> dict:
    """One fp32 ``clip_resnet50`` step at its run.sh flags on this rank's
    shard of ``RN_B`` crops: the BatchNorm running statistics after it
    (saved to ``save``) and the global loss."""
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.losses import SUMMED_TERMS
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.parallel import mesh

    bins, anchors = get_bins_and_anchors(8, 4, "sha")
    model = get_model("clip_resnet50", RN_SIZE, 8, bins, anchors, seed=42, device=dev,
                      axis_name=mesh.DATA_AXIS)
    trainer = _ddp_trainer("clip_resnet50", RN_SIZE, "sha",
                           RN_B // mesh.get_world_size(), model)
    batch = mesh.shard_batch(_ddp_batch(RN_B, RN_SIZE, seed=2)).to(dev)
    info = trainer.train_step(batch, trainer.text_features())
    loss = mesh.reduce_metrics(info, SUMMED_TERMS)["loss"]
    if save:
        torch.save({k: v.cpu() for k, v in model.state_dict().items() if "running_" in k}, save)
    return {"loss": loss}


def _ddp_counts(dev) -> dict:
    """The flagship image's count by 140 windows of 224 px in bf16 and
    fp32, the windows split over the ranks; the windows this rank ran and
    the head's launches. Then phase 4f's stream packed into batches of
    ``PACK_B`` windows, each batch split over the ranks: its counts, the
    windows of each forward on this rank, the head's launches, and the
    error a batch of 120 windows raises."""
    from clip_ebc_tpu_torch.ops.fused_head import fused_ebc_head
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    image, stream = _flagship_image(), stream_images()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = _flagship_model(dev, dtype)
        ran = []
        model.image_encoder.register_forward_pre_hook(lambda m, a: ran.append(a[0].shape[0]))
        ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                       pad_to_multiple=16)
        ev.text_features()  # the text tower's forward runs no window
        fused_ebc_head.launches = 0
        res = {"count": ev.predict_count(image), "windows": ran[:],
               "head_launches": fused_ebc_head.launches}
        ran.clear()
        fused_ebc_head.launches = 0
        res["packed"] = [float(d.sum()) for d in ev.predict_densities_packed(stream, PACK_B)]
        res["packed_windows"], res["packed_head_launches"] = ran[:], fused_ebc_head.launches
        try:
            next(ev.predict_densities_packed(stream, 120))
        except ValueError as e:
            res["error_120"] = str(e)
        out[str(dtype)] = res
        del model, ev
    return out


def _flagship_image() -> np.ndarray:
    """Phase 3's seeded 2048 x 3072 image, ImageNet-normalized."""
    from clip_ebc_tpu_torch.data.crowd import normalize_image

    pixels = np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8)
    return normalize_image(pixels.astype(np.float32) / 255.0)


def _ddp_child(rank: int, world: int, init: str, backend: str, out_dir: str, conn) -> None:
    """One rank (a spawned process) on ``cuda:{rank % devices}``: joins the
    group, runs the cases on its shards, sends one JSON line."""
    from clip_ebc_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.rank_device("cuda", rank)
    torch.cuda.set_device(dev)
    mesh.init_process_group(init, world, rank, backend, dev)
    try:
        res = {"rank": rank, "device": str(dev)}
        for dtype in (torch.bfloat16, torch.float32):
            save = os.path.join(out_dir, f"vpt_{dtype}_grads.pt") if rank == 0 else ""
            res[f"vpt {dtype}"] = _ddp_vpt(dev, dtype, DDP_TIMED if dtype == torch.bfloat16 else 0,
                                           save)
        res["rn50"] = _ddp_rn50(dev, os.path.join(out_dir, "rn50_stats.pt") if rank == 0 else "")
        res["counts"] = _ddp_counts(dev)
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        conn.send(json.dumps(res))
    finally:
        mesh.shutdown()


def ddp_references(dev, tmp: str) -> dict:
    """The one-process runs of the cases on the global batches (no group):
    the VPT step's gradients and the ResNet's statistics saved under
    ``tmp``, its losses, ms per step, counts and peak memory."""
    torch.cuda.reset_peak_memory_stats(dev)
    ref = {dtype: _ddp_vpt(dev, dtype, DDP_TIMED if dtype == torch.bfloat16 else 0,
                           os.path.join(tmp, f"ref_vpt_{dtype}.pt"))
           for dtype in (torch.bfloat16, torch.float32)}
    ref["rn50"] = _ddp_rn50(dev, os.path.join(tmp, "ref_rn50.pt"))
    ref["counts"] = _ddp_counts(dev)
    ref["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.empty_cache()
    return ref


def ddp_ranks(world: int, backend: str, ref: dict, tmp: str) -> list:
    """``world`` ranks spawned (this process holds a CUDA context, so no
    fork) over ``backend``, each ``_ddp_child``, held to the one-process
    references ``ref``: the VPT step's gradients and losses (phase 4's
    tolerances), its launches, the ResNet's BatchNorm statistics, the
    windowed counts (phase 3's). A rank's failure, non-zero exit or
    silence past ``DDP_CHILD_TIMEOUT`` fails the phase. Returns each
    rank's JSON result."""
    import multiprocessing as mp

    from clip_ebc_tpu_torch.parallel import mesh

    tag = f"DDP over {backend}, {world} ranks"
    ctx = mp.get_context("spawn")
    store = f"file://{os.path.join(tmp, backend + '_store')}"
    pipes, procs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_ddp_child, args=(r, world, store, backend, tmp, send))
        p.start()
        send.close()
        pipes.append(recv)
        procs.append(p)
    results = []
    try:
        for r, (p, recv) in enumerate(zip(procs, pipes)):
            left = DDP_CHILD_TIMEOUT - (time.perf_counter() - t0)
            check(recv.poll(max(left, 1)), f"{tag}: rank {r} sent no result within "
                  f"{DDP_CHILD_TIMEOUT} s (exit code {p.exitcode})")
            results.append(json.loads(recv.recv()))
            p.join(max(DDP_CHILD_TIMEOUT - (time.perf_counter() - t0), 1))
            check(p.exitcode == 0, f"{tag}: rank {r} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    spawn_s = time.perf_counter() - t0

    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        got = torch.load(os.path.join(tmp, f"vpt_{dtype}_grads.pt"))
        want = torch.load(os.path.join(tmp, f"ref_vpt_{dtype}.pt"))
        for gname, prefixes in (("vpt", ("vpt_",)),
                                ("decoder", ("image_decoder.", "projection."))):
            err = _group_err(got, want, prefixes)
            print(f"{tag}, VPT step {dt}, {gname} gradient: rel L2 {err:.3e} from one process "
                  f"at {TRAIN_B} (bound {DDP_GRAD_TOL[dtype]:g})")
            check(err <= DDP_GRAD_TOL[dtype], f"{tag} {dt} {gname} gradient disagrees")
        for res in results:
            run = res[f"vpt {dtype}"]
            n = run["launches"]
            check(run["ddp"] == "DistributedDataParallel", f"{tag}: rank {res['rank']}: no DDP")
            rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref[dtype]["losses"]))
            print(f"  rank {res['rank']} ({res['device']}) {dt}: launches {n}; global losses "
                  f"{run['losses']} (one process {ref[dtype]['losses']}, rel {rel:.2e})")
            check(rel <= DDP_GRAD_TOL[dtype], f"{tag}: rank {res['rank']} {dt}: loss differs")
            if dtype == torch.bfloat16:
                check(n["fused_ln_qkv_attention"] >= 12 * DDP_STEPS
                      and n["attention_bwd"] == n["ln_qkv_bwd_frozen"] == n["ln_bwd_dx"]
                      == 12 * DDP_STEPS, f"{tag}: rank {res['rank']} bf16: launches {n}")
    got = torch.load(os.path.join(tmp, "rn50_stats.pt"))
    want = torch.load(os.path.join(tmp, "ref_rn50.pt"))
    check(sorted(got) == sorted(want) and len(want) > 100, f"{tag}: clip_resnet50 statistics")
    errs = {k: float((got[k] - want[k]).norm() / want[k].norm()) for k in want}
    worst = max(errs, key=errs.get)
    print(f"{tag}, clip_resnet50 fp32 step ({RN_B} crops of {RN_SIZE} px): {len(want)} "
          f"BatchNorm statistics, worst rel L2 {errs[worst]:.3e} ({worst}; bound "
          f"{DDP_STAT_TOL:g}); losses {[r['rn50']['loss'] for r in results]} (one process "
          f"{ref['rn50']['loss']})")
    check(errs[worst] <= DDP_STAT_TOL, f"{tag}: clip_resnet50's synced statistics differ")
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype)
        want = ref["counts"][key]["count"]
        for res in results:
            c = res["counts"][key]
            rows = mesh.shard_rows(B, res["rank"], world)
            rel = abs(c["count"] - want) / abs(want)
            print(f"{tag}, rank {res['rank']}, flagship image {key}: count {c['count']:.4f} by "
                  f"windows {c['windows']} (one process {want:.4f}), rel {rel:.2e} (bound "
                  f"{DDP_COUNT_TOL[dtype]:g}); head launches {c['head_launches']}")
            share = rows.stop - rows.start  # a rank with no windows runs no forward
            check(sum(c["windows"]) == share and c["head_launches"] == int(share > 0)
                  and rel <= DDP_COUNT_TOL[dtype], f"{tag}: rank {res['rank']} {key}: count")
            # the packed stream: each batch of PACK_B split over the ranks
            want_packed = ref["counts"][key]["packed"]
            gap = max(abs(a - b) / abs(b) for a, b in zip(c["packed"], want_packed))
            print(f"{tag}, rank {res['rank']}, packed stream {key}: windows a forward "
                  f"{c['packed_windows']}, head launches {c['packed_head_launches']}; counts "
                  f"within {gap:.2e} of one process's (bound {DDP_COUNT_TOL[dtype]:g}); a batch "
                  f"of 120: {c.get('error_120')!r}")
            check(len(c["packed"]) == len(STREAM_HW) and gap <= DDP_COUNT_TOL[dtype]
                  and c["packed_windows"] == [PACK_B // world] * PACK_BATCHES
                  and c["packed_head_launches"] == PACK_BATCHES and "error_120" in c,
                  f"{tag}: rank {res['rank']} {key}: packed stream")
    print(f"{tag}: {spawn_s:.1f} s from spawn to join; bf16 VPT step "
          f"{[round(r['vpt torch.bfloat16']['ms'], 2) for r in results]} ms/step (median of "
          f"{DDP_TIMED}, host clock; one process at {TRAIN_B}: {ref[torch.bfloat16]['ms']:.2f}); "
          f"peak memory {[round(r['peak_gib'], 2) for r in results]} GiB a rank (the one-process "
          f"references {ref['peak_gib']:.2f}); {card_line()}")
    return results


def phase_data_parallel(dev, kernels: dict) -> None:
    from clip_ebc_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as tmp:
        # (a) one rank over NCCL: the flagship bf16 step under DDP, rows 2, 4, 5, 5 dx
        mesh.init_process_group(f"file://{os.path.join(tmp, 'nccl_store')}", 1, 0, "nccl", dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            nccl = _ddp_vpt(dev, torch.bfloat16, timed=DDP_TIMED)
        finally:
            mesh.shutdown()
        n = nccl["launches"]
        check(nccl["ddp"] == "DistributedDataParallel", f"NCCL rank: the step ran {nccl['ddp']}")
        check(n["fused_ln_qkv_attention"] >= 12 * DDP_STEPS
              and n["attention_bwd"] == n["ln_qkv_bwd_frozen"] == n["ln_bwd_dx"] == 12 * DDP_STEPS,
              f"NCCL DDP step: launches {n}, expected 12 a step of rows 2, 4, 5 and 5 dx")
        check(all(math.isfinite(v) for v in nccl["losses"]), f"NCCL DDP losses {nccl['losses']}")
        print(f"DDP over NCCL, 1 rank, flagship bf16 VPT step ({TRAIN_B} windows): "
              f"{nccl['ms']:.2f} ms/step (median of {DDP_TIMED}, host clock), peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches over "
              f"{DDP_STEPS} steps {n}; losses {nccl['losses']}")
        # (b) two ranks sharing the card over gloo against one process on the global batches
        results = ddp_ranks(DDP_WORLD, "gloo", ddp_references(dev, tmp), tmp)

    for row in ("fused_ln_qkv_attention", "attention_bwd", "ln_qkv_bwd_frozen", "ln_bwd_dx"):
        kernels[row]["launches_ddp_nccl"] = nccl["launches"][row]
        kernels[row]["launches_ddp_gloo"] = [r["vpt torch.bfloat16"]["launches"][row]
                                             for r in results]
    kernels["fused_ebc_head"]["launches_ddp_gloo"] = [
        r["counts"][str(torch.bfloat16)]["head_launches"] for r in results]


# phase 4f: a mixed-size stream by windows of 224 at stride 224: 140 + 20 +
# 12 + 20 + 6 + 70 + 12 + 4 = 284 windows, 352 slots in chunks of 16, so
# three forwards of PACK_B (the third a flush) where the per-image path runs 8
STREAM_HW = [(2048, 3072), (768, 1024), (512, 768), (1024, 768), (384, 512), (1536, 2048),
             (640, 896), (448, 448)]
PACK_B, PACK_BATCHES, NWPU_PACK_B = 128, 3, 48
PACK_COUNT_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}  # phase 3's
PACK_INT8_TOL = 2e-2
# the loader alone: (threads, worker processes)
LOADER_MODES = ((4, 0), (0, 2), (0, 4), (0, 8))


def _stream_pixels() -> list:
    rng = np.random.default_rng(18)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in STREAM_HW]


def stream_images() -> list:
    """Phase 4f's stream, ImageNet-normalized (seeded pixels)."""
    from clip_ebc_tpu_torch.data.crowd import normalize_image

    return [normalize_image(px.astype(np.float32) / 255.0) for px in _stream_pixels()]


def _stream_counters(reset: bool = False) -> dict:
    from clip_ebc_tpu_torch.ops import fused_attention as fa

    n = _quant_attn_counters(reset)
    if reset:
        fa.fused_ln_qkv_attention.launches_proj = 0
    n["ln_qkv_proj"] = fa.fused_ln_qkv_attention.launches_proj
    return n


def run_stream_cli(img_dir: str, tmp: str, flags: list, tag: str) -> tuple:
    """The predict CLI on the stream by windows of 224 at stride 224 with
    ``flags``, counters zeroed just before and read just after: ``(counts
    from the saved densities, launches)``."""
    from clip_ebc_tpu_torch.cli import predict

    dens = os.path.join(tmp, tag.replace(" ", "_") + "_dens")
    argv = [img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
            "--num_vpt", "32", "--sliding_window", "--window_size", "224", "--stride", "224",
            "--seed", "0", "--out", dens + ".csv", "--save_density", dens, *flags]
    _stream_counters(reset=True)
    t0 = time.perf_counter()
    predict.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _stream_counters()
    _tally_off_path(f"predict CLI, {tag}")
    counts = [float(np.load(os.path.join(dens, f"{i}.npy")).astype(np.float64).sum())
              for i in range(len(STREAM_HW))]
    check(all(math.isfinite(c) and c > 0 for c in counts), f"{tag}: counts {counts}")
    print(f"predict CLI, {tag}: {secs:.1f} s (model build, weights, {len(STREAM_HW)} images); "
          f"launches {n}")
    return counts, n


def _gap(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def time_stream(fn, reps: int = 2) -> tuple:
    """``fn()`` over the whole stream (ending in host reads of the counts)
    after one warm-up: the median of ``reps`` of CUDA events around the
    call and of the host clock, ms."""
    fn()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def packed_against_per_image(evaluator, images: list, batch_windows: int = PACK_B) -> tuple:
    """The stream's densities packed into batches of ``batch_windows``,
    queued with no host read between images (the host runs ahead of the
    forwards, so the gather of the next image into the staging slots is
    ordered after the forward reading them only by the stream), against
    the per-image path: ``(largest count gap, relative; largest density
    gap over the largest density)``."""
    packed = list(evaluator.predict_densities_packed(images, batch_windows=batch_windows))
    per_image = [evaluator.predict_density(im) for im in images]
    check(len(packed) == len(images), f"the packed stream gave {len(packed)} densities")
    count_gap = dens_gap = 0.0
    for got, want in zip(packed, per_image):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"packed density {tuple(got.shape)}, per image {tuple(want.shape)}")
        count_gap = max(count_gap, abs(float(got.sum() - want.sum())) / abs(float(want.sum())))
        dens_gap = max(dens_gap, float((got - want).abs().max() / want.abs().max()))
    return count_gap, dens_gap


def _loader_rate(loader, epoch: int) -> float:
    """Items per second of one epoch of ``loader`` alone (no model)."""
    loader.set_epoch(epoch)
    t0 = time.perf_counter()
    crops = sum(b.images.shape[0] for b in loader)
    return crops / loader.dataset.num_crops / (time.perf_counter() - t0)


def phase_packing(dev, kernels: dict) -> None:
    for part in (lambda: packing_clis(dev, kernels), lambda: packing_evaluator(dev),
                 lambda: packing_loader(dev, kernels)):
        t0 = time.perf_counter()
        part()
        print(f"  phase 4f part: {time.perf_counter() - t0:.1f} s")


def packing_clis(dev, kernels: dict) -> None:
    """Phase 4f through the serving CLIs: the stream by the predict CLI
    packed and per image (bf16, fp32, ``--quant int8_static --quant_attn``)
    and the NWPU CLI by windows, packed at ``NWPU_PACK_B``."""
    from clip_ebc_tpu_torch.cli import test_nwpu
    from clip_ebc_tpu_torch.ops.sliding_window import window_grid
    from PIL import Image

    n_win = [len(window_grid(hw, (224, 224), (224, 224))) for hw in STREAM_HW]
    slots = sum(-(-n // 16) * 16 for n in n_win)
    check(sum(n_win) == 284 and slots == 352 and -(-slots // PACK_B) == PACK_BATCHES,
          f"the stream has {n_win} windows, {slots} slots")
    pack = ["--packed_eval", "--batch_windows", str(PACK_B)]
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "stream")
        os.makedirs(img_dir)
        for i, px in enumerate(_stream_pixels()):
            Image.fromarray(px, "RGB").save(os.path.join(img_dir, f"{i}.jpg"))
        # (a) the predict CLI, packed and per image, bf16 and fp32
        for dtype in (torch.bfloat16, torch.float32):
            amp = dtype == torch.bfloat16
            dt = "bf16" if amp else "fp32"
            runs = {}
            for packed in (True, False):
                tag = f"stream {dt}" + (f", --packed_eval --batch_windows {PACK_B}" if packed
                                        else ", per image")
                runs[packed] = run_stream_cli(img_dir, tmp, (["--amp"] if amp else [])
                                              + (pack if packed else []), tag)
                fwd = PACK_BATCHES if packed else len(STREAM_HW)
                want = {"fused_ln_qkv_attention": 12 * fwd, "ln_qkv_proj": 12 * fwd if amp else 0,
                        "fused_ebc_head": fwd}
                n = runs[packed][1]
                check({k: n[k] for k in want} == want, f"{tag}: launches {n}, expected {want}")
            gap = _gap(runs[True][0], runs[False][0])
            print(f"stream {dt}: packed counts within {gap:.2e} of the per-image counts "
                  f"(bound {PACK_COUNT_TOL[dtype]:g}); packed {[round(c, 2) for c in runs[True][0]]}")
            check(gap <= PACK_COUNT_TOL[dtype], f"stream {dt}: packed and per-image counts differ")
            n = runs[True][1]
            kernels["fused_ln_qkv_attention" + ("" if amp else "_fp32")]["launches_packed"] = \
                n["fused_ln_qkv_attention"]
            if amp:
                kernels["ln_qkv_proj"]["launches_packed"] = n["ln_qkv_proj"]
                kernels["fused_ebc_head"]["launches_packed"] = n["fused_ebc_head"]
        # (b) --quant int8_static --quant_attn, bf16: two calibration batches
        # of 16 windows (row 3), then the static int8 attention a block
        runs = {}
        for packed in (True, False):
            tag = "stream int8_static --quant_attn bf16" + (", packed" if packed else ", per image")
            runs[packed] = run_stream_cli(img_dir, tmp, ["--amp", "--quant", "int8_static",
                                                         "--calib_images", "2", "--quant_attn"]
                                          + (pack if packed else []), tag)
            fwd = PACK_BATCHES if packed else len(STREAM_HW)
            want = {"int8_attention_static": 12 * fwd, "ln_qkv_proj_int8": 12 * fwd,
                    "int8_attention_body": 12 * fwd, "fused_qkv_attention": 24,
                    "fused_ln_qkv_attention_int8": 0, "fused_ln_qkv_attention": 0,
                    "fused_ebc_head": fwd + 2}
            n = runs[packed][1]
            check({k: n[k] for k in want} == want, f"{tag}: launches {n}, expected {want}")
        gap = _gap(runs[True][0], runs[False][0])
        print(f"stream int8_static --quant_attn bf16: packed counts within {gap:.2e} of the "
              f"per-image counts (bound {PACK_INT8_TOL:g})")
        check(gap <= PACK_INT8_TOL, "int8 stream: packed and per-image counts differ")
        n = runs[True][1]
        kernels["int8_attention_static"]["launches_packed"] = n["int8_attention_static"]
        kernels["int8_attention_body"]["launches_packed"] = n["int8_attention_body"]
        kernels["fused_ln_qkv_attention_int8"]["launches_packed"] = n["fused_ln_qkv_attention_int8"]
        # (c) the NWPU CLI by windows (stride 112: 54 windows, 64 slots an
        # image), packed at --batch_windows 48: three forwards, the last a flush
        nwpu_dir = os.path.join(tmp, "nwpu")
        os.makedirs(nwpu_dir)
        _, weights = nwpu_tree(dev, nwpu_dir)
        subs = {}
        for packed in (True, False):
            _stream_counters(reset=True)
            test_nwpu.main(["--data_root", os.path.join(nwpu_dir, "data"), "--weight_path", weights,
                            "--result_dir", os.path.join(nwpu_dir, str(packed)), "--amp",
                            "--disable_size_check", "--sliding_window"]
                           + (["--packed_eval", "--batch_windows", str(NWPU_PACK_B)] if packed else []))
            torch.cuda.synchronize()
            n = _stream_counters()
            _tally_off_path("test_nwpu CLI by windows")
            subs[packed] = read_submission(os.path.join(nwpu_dir, str(packed), "best_1.txt"))
            fwd = 3 if packed else len(NWPU_SIZES)
            check(n["fused_ln_qkv_attention"] == 12 * fwd and n["fused_ebc_head"] == fwd,
                  f"test_nwpu by windows (packed {packed}): launches {n}")
            if packed:
                kernels["fused_ln_qkv_attention"]["launches_packed_b48"] = n["fused_ln_qkv_attention"]
                kernels["fused_ebc_head"]["launches_packed_b48"] = n["fused_ebc_head"]
        check([r[0] for r in subs[True]] == [r[0] for r in subs[False]] == ["3098", "3099"],
              f"submission ids {subs}")
        gap = _gap([float(c) for _, c in subs[True]], [float(c) for _, c in subs[False]])
        print(f"test_nwpu CLI by windows, bf16, --packed_eval --batch_windows {NWPU_PACK_B}: "
              f"submission {subs[True]}, within {gap:.2e} of the per-image lines (bound 1e-2)")
        check(gap <= PACK_COUNT_TOL[torch.bfloat16], "test_nwpu: packed and per-image lines differ")


def packing_evaluator(dev) -> None:
    """Phase 4f through the Evaluator: the stream's densities packed with
    the host ahead of the device against per image; images/s by device
    time (the host clock beside) and peak memory, in turns."""
    from clip_ebc_tpu_torch.ops.sliding_window import window_grid
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    images = stream_images()
    n_win = sum(len(window_grid(hw, (224, 224), (224, 224))) for hw in STREAM_HW)
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        ev = Evaluator(_flagship_model(dev, dtype), reduction=8, sliding_window=True,
                       window_size=224, stride=224, pad_to_multiple=16)
        count_gap, dens_gap = packed_against_per_image(ev, images)
        print(f"stream {dt} through the Evaluator, host ahead of the device: packed counts within "
              f"{count_gap:.2e} of per image (bound {PACK_COUNT_TOL[dtype]:g}), densities within "
              f"{dens_gap:.2e} of the largest")
        check(count_gap <= PACK_COUNT_TOL[dtype], f"stream {dt}: packed densities differ")

        def per_image():
            return [ev.predict_count(im) for im in images]

        def packed():
            return [float(d.sum()) for d in ev.predict_densities_packed(images, PACK_B)]

        peak = {}
        for name, fn in (("per image", per_image), ("packed", packed)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fn()
            peak[name] = torch.cuda.max_memory_allocated(dev) / 2**30
        turns = [time_stream(f) for f in (per_image, packed, packed, per_image)]
        res = {"per image": (turns[0], turns[3]), "packed": (turns[1], turns[2])}
        n = len(images)
        print(f"stream {dt} ({n} images, {n_win} windows): " + "; ".join(
            f"{name} {', '.join(f'{d:.2f}' for d, _ in t)} ms device ({n / (sum(d for d, _ in t) / 2) * 1e3:.1f} "
            f"images/s), host {', '.join(f'{h:.2f}' for _, h in t)} ms, peak {peak[name]:.2f} GiB"
            for name, t in res.items()) + f"; turns per image, packed, packed, per image; {card_line()}")
        del ev


def packing_loader(dev, kernels: dict) -> None:
    """Phase 4f's loader pool: its first batch against the threads', the
    loader alone by threads and processes, the step's idle share with each,
    and the trainer CLI with ``--loader_procs 2``."""
    from clip_ebc_tpu_torch.config import ExperimentConfig
    from clip_ebc_tpu_torch.data.crowd import CrowdDataset
    from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.losses import make_loss_fn
    from clip_ebc_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "qnrf",
                                            n_train=TRAIN_IMAGES, n_val=2, size=DATA_HW, seed=0)
        cfg = ExperimentConfig(model="clip_vit_b_16", dataset="qnrf", input_size=TRAIN_SIZE,
                               reduction=8, truncation=4, count_loss="dmcount",
                               batch_size=TRAIN_B, num_crops=2, warmup_lr=1e-3).normalize()
        ds = CrowdDataset("qnrf", "train", data, transforms=make_train_transforms(cfg),
                          num_crops=2, check_sizes=False)
        loaders = {mode: TrainLoader(ds, TRAIN_B, 8, seed=cfg.seed, num_threads=mode[0] or 4,
                                     num_workers=mode[1]) for mode in LOADER_MODES}
        threads, pool = loaders[(4, 0)], loaders[(0, 2)]
        try:
            first = []
            for loader in (threads, pool):  # epoch 1's first batch, as the trainer draws it
                loader.set_epoch(1)
                it = iter(loader)
                first.append(next(it))
                it.close()
            check(all(torch.equal(getattr(first[0], f), getattr(first[1], f))
                      for f in ("images", "points", "point_mask", "density")),
                  "the loader pool's first batch differs from the threads'")
            rates = {}
            for mode, loader in loaders.items():
                if mode[1]:
                    _loader_rate(loader, 2)  # warm-up: the pool's start-up
                rates[mode] = _loader_rate(loader, 3)
                if mode not in ((4, 0), (0, 2)):
                    loader.close()
            cores = len(os.sched_getaffinity(0))
            print(f"loader alone ({TRAIN_IMAGES} images of {DATA_HW[0]}x{DATA_HW[1]}, 2 crops of "
                  f"{TRAIN_SIZE} px each, every augmentation of the flagship flags), items/s: "
                  + ", ".join((f"{t} threads" if t else f"{w} processes") + f" {r:.1f}"
                              for (t, w), r in rates.items())
                  + f"; {cores} host cores ({os.cpu_count()} in the machine); first batch of the "
                  "pool bit-equal to the threads'")
            model = _flagship_model(dev, torch.bfloat16).train()
            trainer = Trainer(cfg, model, make_loss_fn(cfg))
            trainer.train_epoch(threads, 4)  # warm-up
            for name, loader in (("threads", threads), ("2 processes", pool)):
                _, wall, busy, _ = profiled(lambda: trainer.train_epoch(loader, 5), cpu=False)
                print(f"profiled epoch of {_steps()} bf16 steps, loader of {name}: wall "
                      f"{wall:.1f} ms, device busy {busy:.1f} ms (idle share {1 - busy / wall:.2f})")
            del trainer, model
        finally:
            for loader in loaders.values():
                loader.close()
        res = run_trainer(dev, data, os.path.join(tmp, "ckpt_pool"), True, ("--loader_procs", "2"))
        n, steps = res["launches"], _steps()
        check(math.isfinite(res["loss"]) and n["ln_qkv_bwd_frozen"] == 12 * steps,
              f"trainer CLI --loader_procs 2: loss {res['loss']}, launches {n}")
        kernels["ln_qkv_bwd_frozen"]["launches_loader_procs"] = n["ln_qkv_bwd_frozen"]


PRETRAINED_TRAIN = 16  # phase 4g's train images: 2 steps of 8 images x 2 crops an epoch


def openai_vit_b16(seed: int) -> dict:
    """A full-size OpenAI-layout CLIP ViT-B/16 state dict (the visual
    tower, the text tower, ``logit_scale``; 149.6 M numbers), seeded
    random values in fp16, as OpenAI ships CLIP."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rand(std, *shape):
        return (torch.randn(shape, generator=g) * std).half()

    def norm(prefix, c):
        sd[f"{prefix}.weight"] = (1.0 + 0.1 * torch.randn(c, generator=g)).half()
        sd[f"{prefix}.bias"] = rand(0.02, c)

    def blocks(prefix, w):
        for i in range(12):
            p = f"{prefix}.{i}"
            norm(f"{p}.ln_1", w)
            norm(f"{p}.ln_2", w)
            sd[f"{p}.attn.in_proj_weight"] = rand(w ** -0.5, 3 * w, w)
            sd[f"{p}.attn.in_proj_bias"] = rand(0.02, 3 * w)
            sd[f"{p}.attn.out_proj.weight"] = rand(w ** -0.5, w, w)
            sd[f"{p}.attn.out_proj.bias"] = rand(0.02, w)
            sd[f"{p}.mlp.c_fc.weight"] = rand(w ** -0.5, 4 * w, w)
            sd[f"{p}.mlp.c_fc.bias"] = rand(0.02, 4 * w)
            sd[f"{p}.mlp.c_proj.weight"] = rand((4 * w) ** -0.5, w, 4 * w)
            sd[f"{p}.mlp.c_proj.bias"] = rand(0.02, w)

    sd["visual.conv1.weight"] = rand(768 ** -0.5, 768, 3, 16, 16)
    sd["visual.class_embedding"] = rand(0.02, 768)
    sd["visual.positional_embedding"] = rand(0.02, 197, 768)
    norm("visual.ln_pre", 768)
    blocks("visual.transformer.resblocks", 768)
    norm("visual.ln_post", 768)
    sd["visual.proj"] = rand(768 ** -0.5, 768, 512)
    sd["token_embedding.weight"] = rand(0.02, 49408, 512)
    sd["positional_embedding"] = rand(0.01, 77, 512)
    blocks("transformer.resblocks", 512)
    norm("ln_final", 512)
    sd["text_projection"] = rand(512 ** -0.5, 512, 512)
    sd["logit_scale"] = torch.tensor(math.log(100.0)).half()
    return sd


def save_torchscript(sd: dict, path: str) -> None:
    """``sd`` as a TorchScript archive (how OpenAI ships CLIP): empty
    modules nested along each key's path, every tensor a parameter at its
    leaf."""
    root = torch.nn.Module()
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


def torchvision_vgg19(seed: int) -> dict:
    """A torchvision VGG19 state dict, its ``classifier.*`` FC layers
    (123.6 M numbers) included, seeded fp32 values."""
    g = torch.Generator().manual_seed(seed)
    sd, idx, cin = {}, 0, 3
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"):
        if c == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn(c, cin, 3, 3, generator=g) * (cin * 9) ** -0.5
        sd[f"features.{idx}.bias"] = torch.randn(c, generator=g) * 0.02
        idx, cin = idx + 2, c
    for i, (o, k) in ((0, (4096, 25088)), (3, (4096, 4096)), (6, (1000, 4096))):
        sd[f"classifier.{i}.weight"] = torch.randn(o, k, generator=g) * k ** -0.5
        sd[f"classifier.{i}.bias"] = torch.zeros(o)
    return sd


def _towers_are(state: dict, sd: dict, tag: str) -> None:
    """Every tensor of the model's image and text towers is the OpenAI
    checkpoint's (the same names under ``visual.`` and at the top) cast to
    fp32."""
    n = 0
    for k, v in state.items():
        if k.startswith("image_encoder."):
            src = "visual." + k[len("image_encoder."):]
        elif k.startswith("text_encoder."):
            src = k[len("text_encoder."):]
        else:
            continue
        check(src in sd and torch.equal(v.cpu(), sd[src].float()),
              f"{tag}: {k} is not the checkpoint's {src}")
        n += 1
    check(n == 300, f"{tag}: {n} tower tensors, expected 300")


def _pretrained_counters(reset: bool = False) -> dict:
    n = _train_counters(reset)
    return {k: n[k] for k in ("fused_ln_qkv_attention", "ln_qkv_proj", "fused_ebc_head",
                              "attention_bwd", "ln_qkv_bwd_frozen", "ln_bwd_dx")}


def phase_pretrained(dev, kernels: dict) -> None:
    """Phase 4g: a full-width OpenAI-layout ViT-B/16 checkpoint through
    ``cli/prepare.py`` and the three CLIs' ``--pretrained``, and a
    torchvision VGG19 into ``vgg19_ae``."""
    from clip_ebc_tpu_torch.cli import predict, test_nwpu, trainer
    from clip_ebc_tpu_torch.config import get_bins_and_anchors
    from clip_ebc_tpu_torch.data.crowd import _load_image, normalize_image
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
    from clip_ebc_tpu_torch.models import get_model
    from clip_ebc_tpu_torch.models.pretrained import apply_pretrained
    from clip_ebc_tpu_torch.training.evaluate import Evaluator

    secs = {}
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sd = openai_vit_b16(seed=19)
        ckpt = os.path.join(tmp, "clip", "ViT-B-16.pt")
        os.makedirs(os.path.dirname(ckpt))
        save_torchscript(sd, ckpt)
        secs["write"] = time.perf_counter() - t0
        mb = os.path.getsize(ckpt) / 2 ** 20

        prep = os.path.join(tmp, "prepared")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "clip_ebc_tpu_torch.cli.prepare", "--src", ckpt,
                              "--no-verify", "--out", prep], cwd=root, capture_output=True,
                             text=True, timeout=600)
        secs["prepare"] = time.perf_counter() - t0
        check(out.returncode == 0, f"cli.prepare failed:\n{out.stderr[-3000:]}")
        stems = ("clip_vit_b_16", "clip_image_encoder_vit_b_16", "clip_text_encoder_vit_b_16")
        check(sorted(os.listdir(os.path.join(prep, "weights"))) == sorted(f"{s}.npz" for s in stems)
              and sorted(os.listdir(os.path.join(prep, "configs"))) == sorted(f"{s}.json" for s in stems),
              "cli.prepare did not write its six files")
        npz = os.path.join(prep, "weights", "clip_vit_b_16.npz")

        # serve: the predict CLI from the archive and from its prepared artifact
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        path = os.path.join(img_dir, "flagship.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, IMAGE_HW + (3,), dtype=np.uint8))
        dens = {}
        # the windows' overlap-average is an index_add_, whose CUDA atomics add a
        # cell's 3-4 overlapping windows in any order (two calls on the same
        # weights can differ in the last bits): deterministic algorithms for
        # the two runs compared
        torch.use_deterministic_algorithms(True, warn_only=True)
        for tag, src in (("pt", ckpt), ("npz", npz)):
            _pretrained_counters(reset=True)
            t0 = time.perf_counter()
            predict.main([img_dir, "--model", "clip_vit_b_16", "--reduction", "8", "--truncation", "4",
                          "--num_vpt", "32", "--sliding_window", "--window_size", "224", "--stride",
                          "224", "--seed", "0", "--amp", "--pretrained", src, "--allow_byte_tokenizer",
                          "--save_density", os.path.join(tmp, f"dens_{tag}"),
                          "--out", os.path.join(tmp, f"{tag}.csv")])
            torch.cuda.synchronize()
            secs[f"predict_{tag}"] = time.perf_counter() - t0
            n = _pretrained_counters()
            _tally_off_path(f"predict CLI --pretrained {tag}")
            check(n["fused_ln_qkv_attention"] == 12 and n["ln_qkv_proj"] == 12
                  and n["fused_ebc_head"] == 1, f"predict --pretrained {tag}: launches {n}")
            kernels["fused_ln_qkv_attention"][f"launches_pretrained_{tag}"] = n["fused_ln_qkv_attention"]
            kernels["fused_ebc_head"][f"launches_pretrained_{tag}"] = n["fused_ebc_head"]
            dens[tag] = np.load(os.path.join(tmp, f"dens_{tag}", "flagship.npy"))
        torch.use_deterministic_algorithms(False)
        check(np.array_equal(dens["pt"], dens["npz"]),
              "predict --pretrained: the .pt and the .npz give different densities")
        count = float(dens["pt"].astype(np.float64).sum())
        check(math.isfinite(count), f"pretrained count {count} is not finite")

        # the same model on the plain path and on the kernel path, loaded here
        bins, anchors = get_bins_and_anchors(8, 4, "qnrf")
        image = normalize_image(_load_image(path))
        counts, ms = {}, {}
        for tag, src, paths in (("plain", ckpt, {"attn_backend": "sdpa", "fused_head": "off"}),
                                ("kernels", npz, {})):
            model = get_model("clip_vit_b_16", 224, 8, bins, anchors, dtype=torch.bfloat16,
                              num_vpt=32, seed=0, device=dev, **paths)
            t0 = time.perf_counter()
            apply_pretrained(model, src, allow_byte_tokenizer=True)
            torch.cuda.synchronize()
            secs[f"load_{'pt' if src == ckpt else 'npz'}"] = time.perf_counter() - t0
            _towers_are(model.state_dict(), sd, f"apply_pretrained({os.path.basename(src)})")
            ev = Evaluator(model, reduction=8, sliding_window=True, window_size=224, stride=224,
                           pad_to_multiple=16)
            counts[tag] = ev.predict_count(image)
            ms[tag] = time_image(ev, image)
            del model, ev
        gap = abs(counts["plain"] - count) / max(abs(counts["plain"]), 1e-6)
        check(gap <= 1e-2, f"pretrained CLI count {count} vs the plain path's {counts['plain']}: {gap:.2e}")
        check(counts["kernels"] == count or abs(counts["kernels"] - count) <= 1e-5 * abs(count),
              f"pretrained Evaluator count {counts['kernels']} vs the CLI's {count}")

        # the NWPU CLI on the archive: the JAX CLI's file name keeps the extension
        nwpu_images(tmp)
        _full_counters(reset=True)
        t0 = time.perf_counter()
        test_nwpu.main(["--data_root", os.path.join(tmp, "data"), "--pretrained", ckpt,
                        "--allow_byte_tokenizer", "--result_dir", os.path.join(tmp, "results"),
                        "--amp", "--disable_size_check"])
        torch.cuda.synchronize()
        secs["nwpu"] = time.perf_counter() - t0
        nf = _full_counters()
        _tally_off_path("test_nwpu CLI --pretrained")
        lines = read_submission(os.path.join(tmp, "results", "clip_ViT-B-16.pt.txt"))
        check([r[0] for r in lines] == ["3098", "3099"] and all(math.isfinite(float(r[1])) for r in lines),
              f"test_nwpu --pretrained submission {lines}")
        check(nf["flash_tiled"] == 24, f"test_nwpu --pretrained launches {nf}, expected 24 tiled")

        # train: two epochs of two steps from the prepared artifact, traced and logged
        data = make_synthetic_crowd_dataset(os.path.join(tmp, "train"), "qnrf", n_train=PRETRAINED_TRAIN,
                                            n_val=2, size=DATA_HW, seed=3)
        ck, prof = os.path.join(tmp, "ck"), os.path.join(tmp, "prof")
        _pretrained_counters(reset=True)
        t0 = time.perf_counter()
        trainer.main(train_flags() + ["--total_epochs", "2", "--eval_start", "2", "--data_root", data,
                                      "--ckpt_dir", ck, "--eval_disable_size_check", "--device", str(dev),
                                      "--amp", "--pretrained", npz, "--allow_byte_tokenizer",
                                      "--profile_dir", prof])
        torch.cuda.synchronize()
        secs["train"] = time.perf_counter() - t0
        nt = _pretrained_counters()
        _tally_off_path("trainer CLI --pretrained")
        steps = 2 * PRETRAINED_TRAIN // (TRAIN_B // 2)
        check(nt["fused_ln_qkv_attention"] > 0 and nt["fused_ebc_head"] > 0
              and nt["attention_bwd"] == 12 * steps and nt["ln_qkv_bwd_frozen"] == 12 * steps
              and nt["ln_bwd_dx"] == 12 * steps, f"trainer --pretrained launches {nt} ({steps} steps)")
        for row, key in (("attention_bwd", "attention_bwd"), ("ln_qkv_bwd_frozen", "ln_qkv_bwd_frozen"),
                         ("ln_bwd_dx", "ln_bwd_dx")):
            kernels[row]["launches_pretrained_train"] = nt[key]
        latest = torch.load(os.path.join(ck, "latest.pt"), map_location="cpu", weights_only=True)
        _towers_are(latest["model"], sd, "the trained model")
        with open(os.path.join(ck, "scalars.tsv")) as f:
            rows = [line.split("\t") for line in f.read().splitlines()]
        check({r[0] for r in rows if r[1].startswith("train/")} == {"1", "2"}
              and any(r[1] == "val/mae" and r[0] == "2" for r in rows),
              f"scalars.tsv rows {[r[:2] for r in rows]}")
        traces = [t for t in os.listdir(prof) if t.endswith(".pt.trace.json")]
        check(len(traces) == 1 and traces[0].startswith("epoch2_"), f"--profile_dir holds {traces}")
        trace_mb = os.path.getsize(os.path.join(prof, traces[0])) / 2 ** 20

        # vgg19_ae from a torchvision VGG19 (its FC layers unread): one Adam step
        # at lr 1e-30 moves a weight by at most ~lr, below the rounding step of
        # every weight but an exact 0, so the features stay the file's within 1e-29
        vgg = os.path.join(tmp, "vgg19.pth")
        vsd = torchvision_vgg19(seed=23)
        torch.save(vsd, vgg)
        t0 = time.perf_counter()
        trainer.main(["--dataset", "qnrf", "--input_size", "448", "--reduction", "8", "--truncation",
                      "4", "--count_loss", "dmcount", "--batch_size", str(PRETRAINED_TRAIN),
                      "--total_epochs", "1", "--eval_start", "9", "--lr", "1e-30", "--warmup_lr",
                      "1e-30", "--eta_min", "1e-31", "--data_root", data, "--ckpt_dir",
                      os.path.join(tmp, "ck_vgg"), "--eval_disable_size_check", "--device",
                      str(dev), "--amp", "--pretrained", vgg])
        torch.cuda.synchronize()
        secs["vgg19_ae"] = time.perf_counter() - t0
        _tally_off_path("trainer CLI vgg19_ae --pretrained")
        latest = torch.load(os.path.join(tmp, "ck_vgg", "latest.pt"), map_location="cpu",
                            weights_only=True)
        feats = {k: v for k, v in latest["model"].items() if k.startswith("backbone.features.")}
        moved = {k: float((v - vsd[k[len("backbone."):]]).abs().max()) for k, v in feats.items()}
        check(len(feats) == 32 and max(moved.values()) <= 1e-29,
              f"vgg19_ae: the features after the step are not the torchvision checkpoint's "
              f"(max abs differences {moved})")
        exact = sum(d == 0.0 for d in moved.values())
        with open(os.path.join(tmp, "ck_vgg", "meta.json")) as f:
            vgg_loss = json.load(f)["loss_history"][-1]["loss"]
        check(latest["step"] == 1 and math.isfinite(vgg_loss),
              f"vgg19_ae: {latest['step']} steps (expected 1), loss {vgg_loss}")
    print(f"phase 4g, {card_line()}: OpenAI ViT-B/16 archive {mb:.0f} MiB (fp16) written in "
          f"{secs['write']:.1f} s; cli.prepare {secs['prepare']:.1f} s (process included); "
          f"apply_pretrained {secs['load_pt']:.2f} s from the .pt, {secs['load_npz']:.2f} s from "
          f"the .npz (on the card, bf16 model); predict CLI (build, load, one 2048x3072 image) "
          f"{secs['predict_pt']:.1f} s (.pt) / {secs['predict_npz']:.1f} s (.npz), the counts "
          f"bit-equal ({count:.4f}; plain path {counts['plain']:.4f}, {gap:.2e}); ms per image "
          f"(host clock, median of 5) kernels {ms['kernels']:.2f}, plain {ms['plain']:.2f}; "
          f"test_nwpu CLI {secs['nwpu']:.1f} s; trainer CLI (2 epochs of 2 steps, eval, trace "
          f"{trace_mb:.1f} MiB) {secs['train']:.1f} s, launches {nt}; vgg19_ae one step "
          f"{secs['vgg19_ae']:.1f} s, loss {vgg_loss:.4f}, {exact} of 32 feature tensors "
          f"bit-equal to the file, the rest within {max(moved.values()):.1e}")


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
    t0 = time.perf_counter()
    phase_build()
    f = FLAGSHIP
    kernels = [phase_attention(dev, torch.bfloat16), phase_attention(dev, torch.float32),
               phase_head(dev), phase_attention_bwd(dev, f, torch.bfloat16),
               phase_attention_bwd(dev, f, torch.float32), phase_ln_qkv_bwd_frozen(dev, f),
               phase_ln_bwd_dx(dev, f),
               phase_attention_int8(dev, f, torch.bfloat16), phase_attention_int8(dev, f, torch.float32),
               phase_int8_proj(dev, f, torch.bfloat16), phase_int8_proj(dev, f, torch.float32),
               phase_ln_qkv_proj(dev), phase_int8_attention_body(dev, f),
               phase_attention_vit_l(dev, torch.bfloat16), phase_attention_vit_l(dev, torch.float32),
               phase_qkv_attention(dev, f, torch.bfloat16), phase_qkv_attention(dev, f, torch.float32),
               phase_flash(dev, "tiled", torch.bfloat16), phase_flash(dev, "tiled", torch.float32),
               phase_flash(dev, "short", torch.bfloat16), phase_flash(dev, "short", torch.float32),
               phase_int8_attention_q(dev, f, torch.bfloat16, "static"),
               phase_int8_attention_q(dev, f, torch.float32, "static"),
               phase_int8_attention_q(dev, LONG_WINDOWS, torch.bfloat16, "static"),
               phase_int8_attention_q(dev, f, torch.bfloat16, "dynamic"),
               phase_int8_attention_q(dev, f, torch.float32, "dynamic"),
               *phase_mlp_int8(dev, f, torch.bfloat16), *phase_mlp_int8(dev, f, torch.float32),
               phase_qkv_quant_dynamic(dev, f, torch.bfloat16), phase_qkv_quant_dynamic(dev, f, torch.float32),
               *phase_kernels_d1024(dev)]
    phase_packed_shapes(dev, {k["name"]: k for k in kernels})
    phase_int8_products(dev)
    print(f"phases 1-2: {time.perf_counter() - t0:.1f} s")
    by_name = {k["name"]: k for k in kernels}
    t0 = time.perf_counter()
    phase_main_path(dev, by_name, "--profile" in argv)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_int8_path(dev, by_name, "--profile" in argv)
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_full_image(dev, by_name, "--profile" in argv)
    print(f"phase 3c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_nwpu(dev)
    print(f"phase 3d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_quant_attn(dev, by_name, "--profile" in argv)
    print(f"phase 3e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_training(dev, by_name, "--profile" in argv)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_vit_kernels(dev)
    phase_models(dev, by_name, "--profile" in argv)
    print(f"phase 4b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_clip_backbones(dev, by_name, "--profile" in argv)
    print(f"phase 4c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_vit_l(dev, by_name, "--profile" in argv)
    print(f"phase 4d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_data_parallel(dev, by_name)
    print(f"phase 4e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_packing(dev, by_name)
    print(f"phase 4f: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_pretrained(dev, by_name)
    print(f"phase 4g: {time.perf_counter() - t0:.1f} s")
    phase_library_kernels_apart()
    off_path = [k for k in kernels if k["name"].removesuffix("_d1024") in OFF_PATH]
    for k in off_path:
        k["launches"] = OFF_PATH_LAUNCHES[k["name"].removesuffix("_d1024").removesuffix("_fp32")]
    check(all(k.get("launches", 0) > 0 for k in kernels if k not in off_path),
          "a kernel of the path was never launched: "
          + ", ".join(k["name"] for k in kernels if k not in off_path and not k.get("launches")))
    check(all("launches" in k for k in kernels), "a kernel has no launch count")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
