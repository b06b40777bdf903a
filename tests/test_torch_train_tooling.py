"""The trainer CLI's scalar log, ``--profile_dir`` and ``--pretrained``; the
serving CLIs' ``--pretrained`` beside ``--weight_path``.

On a tiny synthetic ``shb`` (8 train images of 64 x 96, batch 8: one step
an epoch; 2 val images) the port's trainer and the JAX package's
(``clip_ebc_tpu.cli.trainer``, its 8-device CPU mesh) train ``vgg11`` for
2 epochs from the same flags: the port's ``scalars.tsv`` holds the JAX
file's (step, tag) lines in its order, every value finite (the two inits
differ, so the values are not compared). The port's run starts from a
torchvision VGG11 ``features.*`` checkpoint (``--pretrained``) at a
learning rate of 1e-30, below every weight's rounding step: its
checkpoint then holds the checkpoint's convolutions bit for bit; it
leaves a ``torch.profiler`` trace of epoch 2 under ``--profile_dir``, and
a one-epoch run leaves none. A resumed run keeps
its ``latest.pt`` over another ``--pretrained``. The predict CLI with
``--pretrained`` and ``--weight_path`` gives the ``--weight_path``
weights' counts. Two gloo processes (``--num_hosts 2``, one CPU thread
each) overlay the same file and hold equal weights, the file's, after the
DDP wrap (their ``train_epoch`` replaced by one that saves the model; the
port and the 120 s limit of ``tests/test_torch_distributed_cli.py``).
"""

import glob
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli import trainer as trainer_cli
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from test_torch_distributed_cli import _free_port
from test_torch_pretrained import _vgg_features_sd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
FLAGS = ["--model", "vgg11", "--dataset", "shb", "--input_size", "32", "--reduction", "8",
         "--truncation", "4", "--count_loss", "mae", "--batch_size", "8", "--num_workers", "1",
         "--eval_start", "1", "--save_freq", "1", "--eval_disable_size_check"]
# a learning rate far below every weight's rounding step: a step leaves the weights as they are
FROZEN = ["--lr", "1e-30", "--warmup_lr", "1e-30", "--eta_min", "1e-31"]


def _scalars(ckpt: str) -> list:
    with open(os.path.join(ckpt, "scalars.tsv")) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _features(path: str) -> dict:
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("model", state)
    return {k: v for k, v in state.items() if k.startswith("backbone.features.")}


def _held(features: dict, ckpt: dict) -> bool:
    """Every convolution of the model is the checkpoint's, bit for bit."""
    return bool(features) and all(torch.equal(v, ckpt[k[len("backbone."):]])
                                  for k, v in features.items())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tooling")
    data = make_synthetic_crowd_dataset(str(root / "data"), "shb", n_train=8, n_val=2,
                                        size=(64, 96), max_count=20, seed=0)
    ckpts = {}
    for name, seed in (("p", 1), ("q", 2)):
        ckpts[name] = _vgg_features_sd(np.random.default_rng(seed), VGG11)
        torch.save(ckpts[name], str(root / f"{name}.pt"))
    common = FLAGS + FROZEN + ["--data_root", data]

    from clip_ebc_tpu.cli.trainer import main as jax_main

    jax_main(common + ["--total_epochs", "2", "--ckpt_dir", str(root / "jax")])
    run = str(root / "run")
    trainer_cli.main(common + [
        "--total_epochs", "2", "--ckpt_dir", run, "--pretrained", str(root / "p.pt"),
        "--profile_dir", str(root / "prof"), "--device", "cpu"])
    first = {"scalars": _scalars(run), "latest": _features(os.path.join(run, "latest.pt"))}
    trainer_cli.main(common + [  # resumed: one more epoch
        "--total_epochs", "3", "--ckpt_dir", run, "--pretrained", str(root / "q.pt"),
        "--profile_dir", str(root / "prof_resumed"), "--device", "cpu"])
    trainer_cli.main(common + [
        "--total_epochs", "1", "--ckpt_dir", str(root / "one"),
        "--profile_dir", str(root / "prof_one"), "--device", "cpu"])
    yield {"root": root, "data": data, "ckpts": ckpts, "run": run, "first": first}
    shutil.rmtree(root)  # checkpoints, optimizer states and traces: ~0.6 GB


def test_scalar_log_has_the_jax_tags_and_steps(runs):
    want = _scalars(str(runs["root"] / "jax"))
    got = runs["first"]["scalars"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert {t for _, t, _ in got} >= {"train/loss", "train/lr", "val/mae", "val/rmse"}
    assert all(math.isfinite(float(v)) for _, _, v in got)
    assert {s for s, _, _ in got} == {"1", "2"}


def test_profile_dir_traces_the_second_epoch(runs):
    traces = glob.glob(str(runs["root"] / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.basename(traces[0]).startswith("epoch2_rank0")
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    for one_epoch in ("prof_one", "prof_resumed"):  # a run of one epoch traces nothing
        assert not glob.glob(str(runs["root"] / one_epoch / "*.pt.trace.json"))


def test_pretrained_lands_in_the_checkpoint(runs):
    assert _held(runs["first"]["latest"], runs["ckpts"]["p"])


def test_resumed_run_keeps_its_checkpoint_over_pretrained(runs):
    latest = _features(os.path.join(runs["run"], "latest.pt"))
    assert _held(latest, runs["ckpts"]["p"]) and not _held(latest, runs["ckpts"]["q"])
    scalars = _scalars(runs["run"])
    assert scalars[:len(runs["first"]["scalars"])] == runs["first"]["scalars"]
    assert {s for s, _, _ in scalars[len(runs["first"]["scalars"]):]} == {"3"}


def test_weight_path_wins_over_pretrained(runs, tmp_path):
    val = os.path.join(runs["data"], "shb", "val", "images")
    best = sorted(glob.glob(os.path.join(runs["run"], "best", "*.pt")))[0]

    def counts(*flags):
        out = tmp_path / "counts.csv"
        predict.main([val, "--model", "vgg11", "--bins_dataset", "shb", "--device", "cpu",
                      "--out", str(out), *flags])
        return [r.split(",")[1] for r in out.read_text().splitlines()[1:]]

    q = str(runs["root"] / "q.pt")
    both = counts("--pretrained", q, "--weight_path", best)
    assert both == counts("--weight_path", best) and both != counts("--pretrained", q)


WORKER = """
import sys, torch
from clip_ebc_tpu_torch.cli import trainer
from clip_ebc_tpu_torch.parallel import mesh
from clip_ebc_tpu_torch.training.trainer import Trainer

def save_model(self, loader, epoch):
    assert self.net is not self.model  # wrapped for data parallel
    torch.save(self.net.module.state_dict(), f"{sys.argv[1]}/rank{mesh.get_rank()}.pt")
    return {"loss": 0.0}, 0

Trainer.train_epoch = save_model
trainer.main(sys.argv[2:])
"""


def test_two_ranks_hold_the_pretrained_weights(runs, tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path), *FLAGS, "--batch_size", "4",
         "--eval_start", "9", "--total_epochs", "1", "--data_root", runs["data"],
         "--ckpt_dir", str(tmp_path / "ck"), "--pretrained", str(runs["root"] / "p.pt"),
         "--coordinator", f"127.0.0.1:{port}", "--num_hosts", "2", "--host_id", str(r),
         "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a trainer process did not finish within 120 s")
        assert p.returncode == 0, f"process {r} failed:\n{out[-4000:]}"
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=True) for r in range(2)]
    assert ranks[0].keys() == ranks[1].keys()
    assert all(torch.equal(ranks[0][k], ranks[1][k]) for k in ranks[0])
    assert _held({k: v for k, v in ranks[1].items() if k.startswith("backbone.features.")},
                 runs["ckpts"]["p"])
