"""The two process pools: ``TrainLoader(num_workers=...)``
(``data/loader.py``) and the decode pool behind ``evaluate(...,
decode_procs=...)`` (``training/evaluate.py``), and the trainer CLI's
``--loader_procs``.

- The loader's pool gives the thread path's batches bit for bit, and the
  JAX loader's from the same seed, over two epochs of a synthetic
  ``qnrf`` split with every augmentation on (7 images of 64 x 96, 2 crops
  each, batch 2): the item seeds are drawn up front.
- Items that finish out of order (a dataset whose loads sleep 10 or 120
  ms) are delivered in order, also after an epoch abandoned after its
  first batch.
- A worker that dies (``os._exit``, as an OOM kill would) surfaces as a
  ``RuntimeError`` and the pool is dropped; the next epoch makes a new one.
  A Python exception in a worker propagates with its type, the pool intact.
- ``evaluate(..., decode_procs=2)`` gives the thread path's metrics, and
  one pool serves two calls; ``close`` shuts it down.
- The workers of both pools import neither ``jax`` nor ``clip_ebc_tpu``
  (``sys.modules`` read in a worker). This module imports JAX only inside
  the test that needs it, since a worker imports this module to unpickle
  the datasets defined here.
- The trainer CLI (``vgg19_ae``, 32 px crops, one epoch of two steps and an
  evaluation) with ``--loader_procs 1`` writes the thread run's losses,
  scores and weights.

Measured: 34.9 s in pytest serial (~43 s wall with the interpreter's
start), most of it the workers' start-up (each imports torch; eight
pools start) and the two trainer runs.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from clip_ebc_tpu_torch.cli import trainer as trainer_cli
from clip_ebc_tpu_torch.config import ExperimentConfig
from clip_ebc_tpu_torch.data.crowd import CrowdDataset
from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from clip_ebc_tpu_torch.training import evaluate as E
from clip_ebc_tpu_torch.training.evaluate import Evaluator, evaluate

FIELDS = ("images", "points", "point_mask", "density")


def foreign_modules(_=None) -> list:
    """The modules of JAX or the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "clip_ebc_tpu"))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), err_msg=name)


def test_loader_pool_matches_threads_and_jax(tmp_path, monkeypatch):
    from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
    from clip_ebc_tpu.data import native as jax_native
    from clip_ebc_tpu.data.crowd import CrowdDataset as JaxCrowdDataset
    from clip_ebc_tpu.data.loader import TrainLoader as JaxTrainLoader
    from clip_ebc_tpu.data.loader import make_train_transforms as jax_train_transforms

    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)
    aug = dict(model="clip_vit_b_16", dataset="qnrf", input_size=48, reduction=8, truncation=4,
               min_scale=0.75, max_scale=2.0, hue=0.1, jitter_prob=1.0, blur_prob=1.0,
               noise_prob=1.0)
    root = make_synthetic_crowd_dataset(str(tmp_path), "qnrf", n_train=7, n_val=1,
                                        size=(64, 96), max_count=60, seed=3)
    ds = CrowdDataset("qnrf", "train", root,
                      transforms=make_train_transforms(ExperimentConfig(**aug).normalize()),
                      num_crops=2, check_sizes=False)
    jds = JaxCrowdDataset("qnrf", "train", root,
                          transforms=jax_train_transforms(JaxConfig(**aug).normalize()),
                          num_crops=2, check_sizes=False)
    threads = TrainLoader(ds, batch_size=2, reduction=8, seed=5, num_threads=2)
    pool = TrainLoader(ds, batch_size=2, reduction=8, seed=5, num_workers=2)
    ref = JaxTrainLoader(jds, batch_size=2, reduction=8, seed=5)
    try:
        for epoch in (1, 2):  # the second epoch reuses the pool
            for loader in (threads, pool, ref):
                loader.set_epoch(epoch)
            got = list(pool)
            assert len(got) == 7
            _assert_same_batches(got, list(threads))
            _assert_same_batches(got, list(ref))
        assert pool._pool is not None
        assert pool._pool.submit(foreign_modules).result(timeout=60) == []
    finally:
        pool.close()
    assert pool._pool is None


class _JitterDataset:
    """Picklable items whose loads take 120 ms (every third) or 10 ms, so
    they finish out of order inside the pool's window."""

    num_crops = 1

    def __init__(self, n=10, size=32):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, idx, rng=None):
        import time

        time.sleep(0.12 if idx % 3 == 0 else 0.01)
        rng = rng or np.random.default_rng(idx)
        s = self.size
        img = rng.normal(size=(1, s, s, 3)).astype(np.float32)
        pts = [rng.uniform(0, s, size=(idx % 4, 2)).astype(np.float32)]
        dens = np.zeros((1, s, s), np.float32)
        for x, y in pts[0]:
            dens[0, int(y), int(x)] += 1.0
        return img, pts, dens


class _CrashingDataset(_JitterDataset):
    """Kills its worker (``os._exit``, not an exception) on item 3 while the
    flag file exists."""

    def __init__(self, flag_path, n=8, size=32):
        super().__init__(n, size)
        self.flag_path = flag_path

    def __getitem__(self, idx, rng=None):
        if idx == 3 and os.path.exists(self.flag_path):
            os._exit(1)
        return super().__getitem__(idx, rng)


class _RaisingDataset(_JitterDataset):
    def __getitem__(self, idx, rng=None):
        if idx == 2:
            raise ValueError("bad label file xyz")
        return super().__getitem__(idx, rng)


def test_loader_pool_delivers_in_order():
    ds = _JitterDataset()
    threads = TrainLoader(ds, batch_size=2, reduction=8, max_points=8, seed=1, num_threads=1)
    pool = TrainLoader(ds, batch_size=2, reduction=8, max_points=8, seed=1, num_workers=3)
    threads.set_epoch(2)
    pool.set_epoch(2)
    try:
        want = list(threads)
        first = iter(pool)
        _assert_same_batches([next(first)], want[:1])
        first.close()  # an abandoned epoch: its in-flight items are cancelled
        got = list(pool)
        assert len(got) == 5
        _assert_same_batches(got, want)
    finally:
        pool.close()


def test_loader_worker_death_drops_the_pool_and_the_next_epoch_recovers(tmp_path):
    flag = tmp_path / "crash_on"
    flag.touch()
    loader = TrainLoader(_CrashingDataset(str(flag)), batch_size=2, reduction=8, max_points=8,
                         seed=0, num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="worker process died"):
            list(loader)
        assert loader._pool is None
        flag.unlink()
        loader.set_epoch(1)
        assert len(list(loader)) == 4  # a new pool
    finally:
        loader.close()


def test_loader_worker_exception_propagates_and_the_pool_survives():
    loader = TrainLoader(_RaisingDataset(), batch_size=2, reduction=8, max_points=8, seed=0,
                         num_workers=2)
    try:
        with pytest.raises(ValueError, match="bad label file"):
            list(loader)
        assert loader._pool is not None
        assert len(loader._pool.submit(foreign_modules).result(timeout=60)) == 0
    finally:
        loader.close()


class _Labeled:
    """Three labeled images of different sizes, as ``CrowdDataset`` items."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.items = []
        for i, (h, w) in enumerate([(32, 48), (48, 32), (32, 32)]):
            img = rng.normal(size=(1, h, w, 3)).astype(np.float32)
            pts = rng.uniform(0, 32, (i + 1, 2)).astype(np.float32)
            self.items.append((img, [pts], np.zeros((1, h, w), np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _BlockSum(torch.nn.Module):
    """A per-block model: each 8 x 8 block's channels, weighted and summed."""

    def __init__(self):
        super().__init__()
        self.k = torch.nn.Parameter(torch.tensor([1.0, 0.5, -0.25]))

    def forward(self, x):
        b, h, w, c = x.shape
        return (x.reshape(b, h // 8, 8, w // 8, 8, c).mean((2, 4)) * self.k).sum(-1)


def test_evaluate_decode_pool_matches_threads_and_is_reused(monkeypatch):
    ds = _Labeled()
    ev = Evaluator(_BlockSum(), reduction=8)
    base = evaluate(ev, ds)
    made = []
    real = E._make_decode_pool

    def counting(dataset, procs):
        made.append(procs)
        return real(dataset, procs)

    monkeypatch.setattr(E, "_make_decode_pool", counting)
    try:
        first = evaluate(ev, ds, decode_procs=2)
        second = evaluate(ev, ds, decode_procs=2, prefetch=1)
        assert made == [2]  # the second call took the same pool
        assert first == second
        for k in ("mae", "rmse"):
            assert first[k] == pytest.approx(base[k], rel=1e-6)
        assert ev._decode_pool.submit(foreign_modules).result(timeout=60) == []
    finally:
        ev.close()
    assert ev._decode_pool is None


def _train(tmp_path, data, tag, extra):
    ckpt = tmp_path / tag
    trainer_cli.main([
        "--dataset", "shb", "--input_size", "32", "--reduction", "8", "--truncation", "4",
        "--count_loss", "dmcount", "--batch_size", "2", "--total_epochs", "1", "--eval_start",
        "1", "--data_root", data, "--ckpt_dir", str(ckpt), "--eval_disable_size_check",
        "--device", "cpu", "--num_workers", "2", *extra])
    meta = json.loads((ckpt / "meta.json").read_text())
    state = torch.load(ckpt / "latest.pt", map_location="cpu", weights_only=True)["model"]
    return meta, state


def test_trainer_cli_with_loader_procs_matches_threads(tmp_path):
    data = make_synthetic_crowd_dataset(str(tmp_path / "data"), "shb", n_train=4, n_val=2,
                                        size=(64, 96), max_count=40, seed=0)
    meta, state = _train(tmp_path, data, "procs", ["--loader_procs", "1"])
    want_meta, want_state = _train(tmp_path, data, "threads", [])
    assert meta["loss_history"] == want_meta["loss_history"]
    assert meta["best_scores"] == want_meta["best_scores"]
    assert sorted(state) == sorted(want_state)
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k
