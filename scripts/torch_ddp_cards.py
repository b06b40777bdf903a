#!/usr/bin/env python3
"""Data-parallel training across the cards of one machine over NCCL.

    python3 scripts/torch_ddp_cards.py

One rank a card (``torch.cuda.device_count()`` ranks, two or more):
``chip_smoke.py`` phase 4e's cases (the flagship VPT step, ``clip_resnet50``'s
synced BatchNorm statistics, the flagship image by 140 windows) over NCCL,
held to one process on the same global batches at phase 4e's tolerances;
then the trainer CLI as one process a card (``--coordinator 127.0.0.1:<free
port> --num_hosts N --host_id r``) with the flagship flags, the global batch
split over the ranks, for one epoch on a synthetic ``qnrf`` dataset, and a
resume for a second: rank 0 alone logs each epoch. Builds the kernels first.
Prints the cases' readings and ms per step a rank beside the card line;
exits 1 on any failure.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def trainer_ranks(world: int, data: str, ckpt: str, epochs: int) -> list:
    """The trainer CLI as ``world`` processes; their outputs."""
    port = _free_port()
    flags = cs.train_flags()
    flags[flags.index("--batch_size") + 1] = str(cs.TRAIN_B // world)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clip_ebc_tpu_torch.cli.trainer", *flags, "--amp",
         "--coordinator", f"127.0.0.1:{port}", "--num_hosts", str(world), "--host_id", str(r),
         "--total_epochs", str(epochs), "--eval_start", "1", "--data_root", data,
         "--ckpt_dir", ckpt, "--eval_disable_size_check"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        cs.check(p.returncode == 0, f"trainer rank {r} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_ddp_cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    world = torch.cuda.device_count()
    print(cs.card_line(), "x", world)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)  # the allocator's statistics exist once it has a context
    cs.phase_build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cs.ddp_ranks(world, "nccl", cs.ddp_references(dev, tmp), tmp)
        print(f"the cases over NCCL, {world} ranks: {time.perf_counter() - t0:.1f} s")
        from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset

        data = make_synthetic_crowd_dataset(os.path.join(tmp, "data"), "qnrf",
                                            n_train=cs.TRAIN_IMAGES, n_val=2, size=cs.DATA_HW,
                                            seed=0)
        ckpt = os.path.join(tmp, "ckpt")
        for epochs in (1, 2):
            t1 = time.perf_counter()
            outs = trainer_ranks(world, data, ckpt, epochs)
            lines = [line for line in outs[0].splitlines()
                     if "epoch" in line or "parallel" in line or "resumed" in line]
            print(f"trainer CLI, {world} ranks over NCCL, to epoch {epochs}: "
                  f"{time.perf_counter() - t1:.1f} s\n" + "\n".join(lines))
            cs.check(not any("epoch" in line for out in outs[1:] for line in out.splitlines()),
                     "a rank other than 0 logged")
            cs.check(f"epoch {epochs}/{epochs} (" in outs[0], f"epoch {epochs} did not run")
        cs.check("resumed" in outs[0], "the second run did not resume")
        with open(os.path.join(ckpt, "train.log")) as f:
            log = f.read()
        cs.check(log.count("epoch 1/1 (") == 1 and log.count("epoch 2/2 (") == 1,
                 "the log does not hold each epoch once")
    print(f"{world} cards: {time.perf_counter() - t0:.1f} s; {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
