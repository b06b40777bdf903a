"""The port's data pipeline against the JAX package's: the synthetic
dataset writer, ``CrowdDataset``, the augmentations and ``TrainLoader``.

Both are numpy (and PIL), so the batches must be exactly equal: images,
points, masks and block-summed densities, over two epochs, with every
augmentation switched on (the scale jitter reaches both the crop and the
upscale branch of ``RandomResizedCrop``). The JAX package's optional
native host kernels are switched off for the comparison: the port copies
its numpy path, and the native resize is documented to differ from it in
the last bits.
"""

import os

import numpy as np
import pytest
import torch

from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
from clip_ebc_tpu.data import native as jax_native
from clip_ebc_tpu.data.crowd import CrowdDataset as JaxCrowdDataset
from clip_ebc_tpu.data.loader import TrainLoader as JaxTrainLoader
from clip_ebc_tpu.data.loader import make_eval_transforms as jax_eval_transforms
from clip_ebc_tpu.data.loader import make_train_transforms as jax_train_transforms
from clip_ebc_tpu.data.synthetic import make_synthetic_crowd_dataset as jax_synthetic
from clip_ebc_tpu_torch.config import ExperimentConfig
from clip_ebc_tpu_torch.data.crowd import CrowdDataset
from clip_ebc_tpu_torch.data.loader import TrainLoader, make_eval_transforms, make_train_transforms
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset

AUG = dict(model="clip_vit_b_16", dataset="qnrf", input_size=48, reduction=8, truncation=4,
           min_scale=0.75, max_scale=2.0, hue=0.1, jitter_prob=1.0, blur_prob=1.0,
           noise_prob=1.0, sliding_window=True, window_size=32, stride=32,
           zero_pad_to_multiple=True)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("syn")
    make_synthetic_crowd_dataset(str(root), "qnrf", n_train=6, n_val=2, size=(64, 96),
                                 max_count=60, seed=3)
    return str(root)


def test_synthetic_writer_matches_jax(data_root, tmp_path):
    jax_synthetic(str(tmp_path), "qnrf", n_train=6, n_val=2, size=(64, 96), max_count=60, seed=3)
    for split in ("train", "val"):
        for sub in ("images", "labels"):
            names = sorted(os.listdir(os.path.join(data_root, "qnrf", split, sub)))
            assert names == sorted(os.listdir(tmp_path / "qnrf" / split / sub))
            for name in names:
                with open(os.path.join(data_root, "qnrf", split, sub, name), "rb") as f:
                    assert f.read() == (tmp_path / "qnrf" / split / sub / name).read_bytes()


@pytest.fixture
def numpy_jax(monkeypatch):
    monkeypatch.setattr(jax_native, "HAVE_NATIVE", False)


def _loaders(data_root, **loader_kw):
    cfg = ExperimentConfig(**AUG).normalize()
    jcfg = JaxConfig(**AUG).normalize()
    ds = CrowdDataset("qnrf", "train", data_root, transforms=make_train_transforms(cfg),
                      num_crops=2, check_sizes=False)
    jds = JaxCrowdDataset("qnrf", "train", data_root, transforms=jax_train_transforms(jcfg),
                          num_crops=2, check_sizes=False)
    return (TrainLoader(ds, batch_size=4, reduction=8, seed=5, **loader_kw),
            JaxTrainLoader(jds, batch_size=4, reduction=8, seed=5, **loader_kw))


@pytest.mark.parametrize("num_threads", [1, 3])
def test_train_loader_batches_equal_jax(data_root, numpy_jax, num_threads):
    port, jax_loader = _loaders(data_root, num_threads=num_threads)
    assert len(port) == len(jax_loader) == 3 and port.max_points == jax_loader.max_points
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        batches = list(port)
        want = list(jax_loader)
        assert len(batches) == len(want) == 3
        for got, ref in zip(batches, want):
            assert got.images.shape == (4, 48, 48, 3) and got.density.shape == (4, 6, 6)
            for name in ("images", "points", "point_mask", "density"):
                a, b = getattr(got, name), np.asarray(getattr(ref, name))
                assert isinstance(a, torch.Tensor) and a.dtype == torch.from_numpy(b).dtype, name
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
            np.testing.assert_array_equal(got.gt_counts.numpy(), ref.gt_counts)


def test_eval_dataset_matches_jax(data_root, numpy_jax):
    cfg = ExperimentConfig(**AUG).normalize()
    jcfg = JaxConfig(**AUG).normalize()
    ds = CrowdDataset("qnrf", "val", data_root, transforms=make_eval_transforms(cfg),
                      check_sizes=False)
    jds = JaxCrowdDataset("qnrf", "val", data_root, transforms=jax_eval_transforms(jcfg),
                          check_sizes=False)
    assert len(ds) == len(jds) == 2
    for i in range(len(ds)):
        for a, b in zip(ds[i], jds[i]):
            if isinstance(a, list):
                assert all(np.array_equal(x, y) for x, y in zip(a, b))
            else:
                np.testing.assert_array_equal(a, b)


def test_loader_surfaces_item_errors(data_root):
    class Broken(CrowdDataset):
        def __getitem__(self, index, rng=None):
            raise OSError(f"unreadable item {index}")

    ds = Broken("qnrf", "train", data_root, num_crops=2, check_sizes=False)
    with pytest.raises(OSError, match="unreadable item"):
        next(iter(TrainLoader(ds, batch_size=4, reduction=8, num_threads=2)))
