"""Training entry point: counterpart of ``clip_ebc_tpu/cli/trainer.py`` with
the same flags and defaults, plus ``--device`` (default ``cuda``).

    python -m clip_ebc_tpu_torch.cli.trainer --model clip_vit_b_16 --dataset qnrf \\
        --input_size 224 --reduction 8 --truncation 4 --num_vpt 32 --prompt_type word \\
        --count_loss dmcount --batch_size 16 --num_crops 2 --sliding_window \\
        --window_size 224 --stride 224 --warmup_lr 1e-3 --amp

One process trains on one device from random weights (``--seed``). A
``clip_*`` ViT model (ViT-B/16, ViT-B/32, ViT-L/14 and its 336 px
variant) trains by VPT prompt tuning with the trunk and the text tower
frozen; a CLIP ResNet (``clip_resnet50``, ``clip_resnet101``,
``clip_resnet50x{4,16,64}``) trains end to end with the text tower
frozen, its BatchNorm in train mode, as at the reference's ``run.sh``
flags:

    python -m clip_ebc_tpu_torch.cli.trainer --model clip_resnet50 --dataset sha \
        --input_size 448 --reduction 8 --truncation 4 --prompt_type word --batch_size 8

Every other model the JAX factory builds (the default
``vgg19_ae``, the VGG, ResNet, CSRNet/CANNet, MobileNetV2, DenseNet,
plain-ViT and registered backbones) trains every parameter, as a
Classifier over the bins or, with ``--regression``, as a density
Regressor under plain DMCount:

    python -m clip_ebc_tpu_torch.cli.trainer --model vgg19_ae --dataset shb \\
        --input_size 448 --reduction 8 --truncation 4 --count_loss dmcount --amp

Each epoch trains, evaluates on the val split from ``--eval_start`` on
(MAE, RMSE), keeps the best ``--save_best_k`` weights under
``{ckpt_dir}/best/{epoch}.pt`` (which ``cli.predict --weight_path``
loads) and the full state (BatchNorm statistics included) in
``{ckpt_dir}/latest.pt``, from which a rerun resumes.

Data parallel: ``--num_hosts N`` processes, one a device, each started
with its own ``--host_id`` (0..N-1) and the same ``--coordinator
host:port`` (rank 0 listens there), train one model. ``--batch_size`` is
per process: the N processes take the step one process takes on a global
batch of N x ``--batch_size`` (DDP over NCCL on CUDA, gloo on the CPU;
BatchNorm statistics over the global batch), as the JAX trainer does
with one process a host. Process r drives ``cuda:{r % devices}``. Every
process trains and evaluates (the windows split over the processes);
process 0 alone writes ``train.log`` and the checkpoints:

    python -m clip_ebc_tpu_torch.cli.trainer --coordinator 10.0.0.1:29500 \
        --num_hosts 2 --host_id 0 ...   # and --host_id 1 in a second process

``--loader_procs N`` loads the training items in N spawned worker
processes in place of the ``--num_workers`` threads (the same batches),
and decodes the validation images in N more; each process of a data
parallel run owns its pools.

Not ported yet, and refused: ``--pretrained`` and ``--profile_dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train an EBC crowd-counting model (PyTorch/CUDA).")
    # Model
    p.add_argument("--model", type=str, default="vgg19_ae")
    p.add_argument("--input_size", type=int, default=448)
    p.add_argument("--reduction", type=int, default=8, choices=[8, 16, 32])
    p.add_argument("--regression", action="store_true")
    p.add_argument("--truncation", type=int, default=None)
    p.add_argument("--anchor_points", type=str, default="average", choices=["average", "middle"])
    p.add_argument("--prompt_type", type=str, default="word", choices=["word", "number"])
    p.add_argument("--granularity", type=str, default="fine", choices=["fine", "dynamic", "coarse"])
    p.add_argument("--num_vpt", type=int, default=32)
    p.add_argument("--vpt_drop", type=float, default=0.0)
    p.add_argument("--shallow_vpt", action="store_true")
    # Dataset
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_crops", type=int, default=1)
    p.add_argument("--min_scale", type=float, default=1.0)
    p.add_argument("--max_scale", type=float, default=2.0)
    p.add_argument("--brightness", type=float, default=0.1)
    p.add_argument("--contrast", type=float, default=0.1)
    p.add_argument("--saturation", type=float, default=0.1)
    p.add_argument("--hue", type=float, default=0.0)
    p.add_argument("--kernel_size", type=int, default=5)
    p.add_argument("--saltiness", type=float, default=1e-3)
    p.add_argument("--spiciness", type=float, default=1e-3)
    p.add_argument("--jitter_prob", type=float, default=0.2)
    p.add_argument("--blur_prob", type=float, default=0.2)
    p.add_argument("--noise_prob", type=float, default=0.5)
    # Evaluation
    p.add_argument("--sliding_window", action="store_true")
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--window_size", type=int, default=None)
    p.add_argument("--strategy", type=str, default="average", choices=["average", "max"])
    p.add_argument("--resize_to_multiple", action="store_true")
    p.add_argument("--zero_pad_to_multiple", action="store_true")
    p.add_argument("--pad_to_multiple", type=int, default=0,
                   help="pad eval images up to this multiple; 0 disables")
    # Loss
    p.add_argument("--weight_count_loss", type=float, default=1.0)
    p.add_argument("--count_loss", type=str, default="mae", choices=["mae", "mse", "dmcount"])
    # Optimizer / schedule
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_epochs", type=int, default=50)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--T_0", type=int, default=5)
    p.add_argument("--T_mult", type=int, default=2)
    p.add_argument("--eta_min", type=float, default=1e-7)
    # Training
    p.add_argument("--total_epochs", type=int, default=2600)
    p.add_argument("--eval_start", type=int, default=50)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--save_freq", type=int, default=5)
    p.add_argument("--save_best_k", type=int, default=3)
    p.add_argument("--amp", action="store_true", help="bf16 compute (fp32 parameters)")
    p.add_argument("--num_workers", type=int, default=4, help="loader decode threads")
    p.add_argument("--loader_procs", type=int, default=0,
                   help="worker processes that load the training items and decode the "
                   "validation images (0: threads)")
    p.add_argument("--seed", type=int, default=42, help="seed of the weights, data order and dropout")
    # Paths
    p.add_argument("--pretrained", type=str, default=None)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--max_points", type=int, default=0,
                   help="per-image point pad for the OT loss; 0 sizes it from the dataset")
    p.add_argument("--eval_disable_size_check", action="store_true")
    # Multi-host
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    # Observability
    p.add_argument("--profile_dir", type=str, default=None)
    # Paths of the model
    p.add_argument("--attn_backend", type=str, default="auto",
                   choices=["auto", "fused", "flash", "sdpa"])
    p.add_argument("--fused_head", type=str, default="auto", choices=["auto", "on", "off"])
    p.add_argument("--decoder_before_upsample", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _check_ported(args) -> None:
    todo = {
        "--pretrained (ROADMAP Queue 1, remaining tooling)": args.pretrained is not None,
        "--profile_dir (ROADMAP Queue 1, remaining tooling)": args.profile_dir is not None,
    }
    missing = [k for k, asked in todo.items() if asked]
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def config_from_args(args):
    from ..config import ExperimentConfig

    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in vars(args).items() if k in names}).normalize()


def _logger(path: Optional[str]) -> logging.Logger:
    """The trainer's log, to stdout and ``path``; silent without a path
    (the processes other than rank 0)."""
    log = logging.getLogger("clip_ebc_tpu_torch.trainer")
    log.setLevel(logging.INFO)
    log.propagate = False
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    handlers = (logging.StreamHandler(sys.stdout), logging.FileHandler(path)) if path else (
        logging.NullHandler(),)
    for h in handlers:
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _check_ported(args)
    cfg = config_from_args(args)

    from ..parallel import mesh

    mesh.initialize_distributed(args.coordinator, args.num_hosts, args.host_id,
                                device=args.device)
    try:
        _train(args, cfg)
    finally:
        mesh.shutdown()


def _train(args, cfg) -> None:
    import torch

    from ..data.crowd import CrowdDataset
    from ..data.loader import TrainLoader, make_eval_transforms, make_train_transforms
    from ..losses import make_loss_fn
    from ..models import get_model
    from ..parallel import mesh
    from ..training.checkpoint import CheckpointManager
    from ..training.evaluate import Evaluator, evaluate
    from ..training.trainer import Trainer

    device = mesh.rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world, primary = mesh.get_world_size(), mesh.is_primary()
    if primary:
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
    log = _logger(os.path.join(cfg.ckpt_dir, "train.log") if primary else None)
    log.info("config: %s", cfg)
    if world > 1:
        log.info("data parallel: %d processes, global batch %d", world,
                 world * cfg.batch_size)

    model = get_model(
        cfg.model, cfg.input_size, cfg.reduction, cfg.bins, cfg.bin_anchors,
        dtype=torch.bfloat16 if cfg.amp else torch.float32, prompt_type=cfg.prompt_type,
        num_vpt=cfg.num_vpt, deep_vpt=not cfg.shallow_vpt, vpt_drop=cfg.vpt_drop,
        attn_backend=args.attn_backend, fused_head=args.fused_head,
        decoder_before_upsample=args.decoder_before_upsample, seed=cfg.seed, device=device,
        axis_name=mesh.DATA_AXIS if world > 1 else None,
    )
    trainer = Trainer(cfg, model, make_loss_fn(cfg, world))
    train_ds = CrowdDataset(
        cfg.dataset, "train", data_root=cfg.data_root, transforms=make_train_transforms(cfg),
        num_crops=cfg.num_crops, check_sizes=not args.eval_disable_size_check,
    )
    loader = TrainLoader(
        train_ds, batch_size=cfg.batch_size, reduction=cfg.reduction,
        max_points=args.max_points or None, seed=cfg.seed, num_threads=cfg.num_workers,
        host_id=mesh.get_rank(), num_hosts=world, num_workers=args.loader_procs,
    )
    val_ds = CrowdDataset(
        cfg.dataset, "val", data_root=cfg.data_root, transforms=make_eval_transforms(cfg),
        check_sizes=not args.eval_disable_size_check,
    )
    evaluator = Evaluator(
        model, reduction=cfg.reduction, sliding_window=cfg.sliding_window,
        window_size=cfg.window_size, stride=cfg.stride, strategy=args.strategy,
        pad_to_multiple=args.pad_to_multiple,
    )
    ckpt = CheckpointManager(cfg.ckpt_dir, cfg.save_best_k)
    start_epoch = 1
    resumed = ckpt.restore_latest()
    if resumed is not None:
        state, start_epoch = resumed
        trainer.load_state_dict(state)
        log.info("resumed from %s at epoch %d", cfg.ckpt_dir, start_epoch)

    # every process trains and evaluates (an evaluation on rank 0 alone
    # would wait forever on the others' share of the windows)
    try:
        for epoch in range(start_epoch, cfg.total_epochs + 1):
            t0 = time.time()
            metrics, steps = trainer.train_epoch(loader, epoch)
            log.info("epoch %d/%d (%.1fs, %d steps): %s", epoch, cfg.total_epochs,
                     time.time() - t0, steps, " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            if epoch >= cfg.eval_start and (epoch - cfg.eval_start) % cfg.eval_freq == 0:
                scores = evaluate(evaluator, val_ds, decode_procs=args.loader_procs)
                best = ckpt.update_best(scores, epoch, model.state_dict())
                log.info("eval epoch %d: mae=%.2f rmse=%.2f | best mae=%s", epoch,
                         scores["mae"], scores["rmse"], [f"{s:.2f}@{e}" for s, e in best["mae"]])
            if epoch % cfg.save_freq == 0 or epoch == cfg.total_epochs:
                ckpt.save_latest(trainer.state_dict(), epoch, metrics)
    finally:
        loader.close()
        evaluator.close()


if __name__ == "__main__":
    main()
