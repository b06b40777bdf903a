"""The trainer CLI as two processes (``--coordinator/--num_hosts/--host_id``).

Two processes of ``python -m clip_ebc_tpu_torch.cli.trainer --coordinator
127.0.0.1:<free port> --num_hosts 2 --host_id r --device cpu`` (gloo, one
CPU thread each, a 120 s limit each) train ``vgg11_bn`` (its BatchNorms
synced over the ranks) for 2 epochs on a tiny synthetic ``shb`` (8 train
images, 4 a rank, 2 per rank and step; 2 val images of 64 x 96 evaluated
by 6 windows of 32 px, 3 a rank), then resume for a third. Rank 0 alone
writes ``train.log`` and the checkpoints; the best checkpoint serves
through ``cli/predict.py``. The data-parallel flags that name no process
of a group raise ``ValueError`` before anything starts. The file takes
about 30 s serial on 8 CPU cores.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli import trainer as trainer_cli
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--model", "vgg11_bn", "--dataset", "shb", "--input_size", "32", "--reduction", "8",
         "--truncation", "4", "--count_loss", "dmcount", "--batch_size", "2",
         "--warmup_lr", "1e-3", "--eval_start", "1", "--save_freq", "1", "--sliding_window",
         "--window_size", "32", "--stride", "32", "--eval_disable_size_check",
         "--num_workers", "1", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(data: str, ckpt: str, epochs: int) -> list:
    """Both processes' output; each must exit 0 within 120 s."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clip_ebc_tpu_torch.cli.trainer", *FLAGS,
         "--coordinator", f"127.0.0.1:{port}", "--num_hosts", "2", "--host_id", str(r),
         "--total_epochs", str(epochs), "--data_root", data, "--ckpt_dir", ckpt],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a trainer process did not finish within 120 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_cli")
    data = make_synthetic_crowd_dataset(str(root / "data"), "shb", n_train=8, n_val=2,
                                        size=(64, 96), max_count=40, seed=0)
    ckpt = str(root / "ckpt")
    first = _run_pair(data, ckpt, epochs=2)
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(ckpt, "train.log")) as f:
        log = f.read()
    resumed = _run_pair(data, ckpt, epochs=3)
    return {"root": root, "data": data, "ckpt": ckpt, "first": first, "resumed": resumed,
            "meta": meta, "log": log}


def test_rank0_alone_writes_the_log_and_checkpoints(runs):
    log, meta = runs["log"], runs["meta"]
    assert "data parallel: 2 processes, global batch 4" in log
    for epoch in (1, 2):  # each line once: one writer
        assert log.count(f"epoch {epoch}/2 (") == 1 and log.count(f"eval epoch {epoch}:") == 1
    assert "epoch 1/2 (" in runs["first"][0] and "epoch" not in runs["first"][1]
    # 8 images over 2 ranks, 2 a step: 2 steps an epoch; one history entry an epoch
    assert "2 steps" in log and [h["epoch"] for h in meta["loss_history"]] == [1, 2]
    assert meta["epoch"] == 2 and meta["best_scores"]["mae"]
    assert all(np.isfinite(h["loss"]) for h in meta["loss_history"])
    best = os.listdir(os.path.join(runs["ckpt"], "best"))
    assert best and all(n.endswith(".pt") for n in best)
    assert not [n for n in os.listdir(runs["ckpt"]) if n.endswith(".tmp")]


def test_resume_runs_one_more_epoch(runs):
    out0, out1 = runs["resumed"]
    assert "resumed from" in out0 and "at epoch 3" in out0
    assert "epoch 3/3 (" in out0 and "epoch 1/3" not in out0 and "epoch" not in out1
    with open(os.path.join(runs["ckpt"], "meta.json")) as f:
        meta = json.load(f)
    assert [h["epoch"] for h in meta["loss_history"]] == [1, 2, 3] and meta["epoch"] == 3
    with open(os.path.join(runs["ckpt"], "train.log")) as f:
        assert f.read().count("epoch 3/3 (") == 1


def test_checkpoint_serves_through_predict(runs):
    with open(os.path.join(runs["ckpt"], "meta.json")) as f:
        epoch = json.load(f)["best_scores"]["mae"][0][1]
    out = runs["root"] / "counts.csv"
    val = os.path.join(runs["data"], "shb", "val", "images")
    predict.main([val, "--model", "vgg11_bn", "--bins_dataset", "shb", "--device", "cpu",
                  "--reduction", "8", "--truncation", "4", "--sliding_window",
                  "--window_size", "32", "--stride", "32",
                  "--weight_path", os.path.join(runs["ckpt"], "best", f"{epoch}.pt"),
                  "--out", str(out)])
    rows = out.read_text().splitlines()[1:]
    assert len(rows) == 2 and all(np.isfinite(float(r.split(",")[1])) for r in rows)


@pytest.mark.parametrize("extra, match", [
    (["--num_hosts", "2", "--host_id", "2", "--coordinator", "127.0.0.1:1"], "outside"),
    (["--num_hosts", "2", "--host_id", "-1", "--coordinator", "127.0.0.1:1"], "outside"),
    (["--host_id", "1"], "outside"),  # one process is rank 0
    (["--num_hosts", "2", "--host_id", "1"], "--coordinator"),
    (["--num_hosts", "0"], "--num_hosts"),
])
def test_data_parallel_flags_must_name_a_process(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        trainer_cli.main(FLAGS + ["--data_root", str(tmp_path), "--ckpt_dir",
                                  str(tmp_path / "ck"), *extra])
    assert not (tmp_path / "ck").exists()  # raised before anything was written
