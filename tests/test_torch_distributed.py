"""Data parallelism across processes (``parallel/mesh.py``) against one
process on the global batch and against the JAX package.

Two ranks over gloo, joined by a ``file://`` store under the test's
temporary directory, are this file run as a script (``python
tests/test_torch_distributed.py --rank r ...``: the worker below, which
imports no JAX and runs one CPU thread); one spawn of the pair serves
every case. Each rank takes half of a seeded global batch of 4 (32 px,
the sizes of ``tests/test_torch_train.py`` and
``tests/test_torch_vgg_slice.py``) and runs:

- a BatchNorm with ``axis_name`` on a channel-shifted input: its output,
  input gradient, the ranks' summed weight and bias gradients and its
  running statistics against one process on the whole input (1e-5
  relative on the values, 1e-6 on the statistics);
- 2 optimizer steps of ``vgg19_ae`` (DACE with the DMCount count loss)
  and of CLIP-EBC ViT-B/16 with deep VPT-32 (DMCount, its decoder's
  BatchNorms synced), both under DDP, and one CLIP step with prompt
  dropout 0.3 and one with the OT term's world-size factor dropped. The
  first step is held to the port's one process at the global batch (the
  loss and the averaged gradient of each parameter within 1e-5 relative,
  the parameters after it within 1e-5 relative L2 where Adam's step is
  not decided by rounding (``_check_adam_step``), the running statistics
  within 1e-6); without dropout both steps are held to the JAX
  ``make_train_step`` on the global batch at the tolerances of the two
  files above (each loss 1e-4 relative; each trained tensor's update
  within 1e-2 (CLIP) or 5e-2 (VGG) relative L2 of the JAX update, no
  element further than 2 x steps x lr; the running statistics 1e-3);
  the step without the factor must miss the one-process gradient by more
  than 100 x the tolerance (the points make the OT gradient comparable
  to the count loss's);
- ``sliding_window_predict`` on 15 overlapping windows (8
  and 7 a rank), both strategies, against the JAX
  ``sliding_window_predict`` on its 8-device mesh and the numpy oracle of
  ``tests/test_sliding_window.py``, within 1e-5.

``TrainLoader(host_id=r, num_hosts=2)`` is held to the JAX loader's
shards in this process, batch for batch and bit for bit. The file takes
about 45 s serial on 8 CPU cores, most of it the JAX step's compile.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script
    sys.path.insert(0, REPO)

from clip_ebc_tpu_torch.config import ExperimentConfig  # noqa: E402
from clip_ebc_tpu_torch.data.loader import Batch  # noqa: E402
from clip_ebc_tpu_torch.losses import SUMMED_TERMS, make_loss_fn  # noqa: E402
from clip_ebc_tpu_torch.models import get_model  # noqa: E402
from clip_ebc_tpu_torch.models.blocks import BatchNorm  # noqa: E402
from clip_ebc_tpu_torch.ops.sliding_window import sliding_window_predict  # noqa: E402
from clip_ebc_tpu_torch.parallel import mesh  # noqa: E402
from clip_ebc_tpu_torch.training.trainer import Trainer  # noqa: E402

WORLD, GLOBAL_B, SIZE, RED, STEPS, LR = 2, 4, 32, 8, 2, 1e-3
POINTS = (12, 0, 16, 5)  # per image of the global batch: rank 0 takes 0-1, rank 1 takes 2-3
CFGS = {
    "vgg": dict(model="vgg19_ae", input_size=SIZE, reduction=RED, truncation=4, dataset="shb",
                count_loss="dmcount", warmup_lr=LR, batch_size=GLOBAL_B // WORLD, seed=0),
    "clip": dict(model="clip_vit_b_16", input_size=SIZE, reduction=RED, truncation=4,
                 dataset="qnrf", count_loss="dmcount", warmup_lr=LR,
                 batch_size=GLOBAL_B // WORLD, seed=0),
}
# (config, prompt dropout, the loss's world size (None: the real one), steps)
STEP_CASES = {"vgg": ("vgg", 0.0, None, STEPS), "clip": ("clip", 0.0, None, STEPS),
              "clip_drop": ("clip", 0.3, None, 1), "clip_no_factor": ("clip", 0.0, 1, 1)}
WINDOW_IMAGE, WINDOW, STRIDE = (80, 128), (32, 32), (24, 24)  # 3 x 5 = 15 windows
REL_TOL, STAT_TOL = 1e-5, 1e-6


def _batches():
    """``STEPS`` global batches of ``GLOBAL_B``, seeded numpy."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        images = rng.normal(size=(GLOBAL_B, SIZE, SIZE, 3)).astype(np.float32)
        points = np.zeros((GLOBAL_B, 16, 2), np.float32)
        mask = np.zeros((GLOBAL_B, 16), bool)
        density = np.zeros((GLOBAL_B, SIZE // RED, SIZE // RED), np.float32)
        for i, n in enumerate(POINTS):
            points[i, :n] = rng.uniform(0, SIZE, size=(n, 2))
            mask[i, :n] = True
            for x, y in points[i, :n]:
                density[i, int(y) // RED, int(x) // RED] += 1.0
        out.append((images, points, mask, density))
    return out


def _bn_case() -> dict:
    """A synced BatchNorm on this rank's half of a seeded input: output
    and input gradient of its rows, the weight and bias gradients summed
    over the ranks, the running statistics."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(2.0, 3.0, size=(GLOBAL_B, 6, 5, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    bn = BatchNorm(6, mesh.DATA_AXIS).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
    xl = mesh.shard_batch(x).clone().requires_grad_()
    y = bn(xl)
    (y * mesh.shard_batch(g)).sum().backward()
    return {"y": y.detach(), "dx": xl.grad, "dw": mesh.all_reduce_sum(bn.weight.grad.clone()),
            "db": mesh.all_reduce_sum(bn.bias.grad.clone()), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def _step_case(name: str, steps: int = 0) -> dict:
    """Steps (``steps``, else the case's) of this rank's shard (the whole
    batch alone) through the port's ``Trainer``: the global losses, the
    first step's averaged gradients and the states after the first and
    the last step."""
    kind, drop, loss_world, case_steps = STEP_CASES[name]
    cfg = ExperimentConfig(vpt_drop=drop, **CFGS[kind]).normalize()
    model = get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, num_vpt=32,
                      vpt_drop=drop, seed=0, device="cpu", attn_backend="fused",
                      axis_name=mesh.DATA_AXIS)
    world = mesh.get_world_size()
    trainer = Trainer(cfg, model, make_loss_fn(cfg, world if loss_world is None else loss_world))
    trainer.set_epoch_lr(1)
    model.train()
    text = trainer.text_features()
    out = {"losses": []}
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    for b in _batches()[:steps or case_steps]:
        info = trainer.train_step(mesh.shard_batch(Batch(*map(torch.from_numpy, b))), text)
        out["losses"].append(mesh.reduce_metrics(info, SUMMED_TERMS)["loss"])
        # what moves: the trained parameters and the BatchNorm statistics
        out["state"] = {k: v.clone() for k, v in model.state_dict().items()
                        if k in trained or "running_" in k or "num_batches" in k}
        if "grads" not in out:
            out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.requires_grad}
            out["state1"] = out["state"]
    return out


def fake_apply(windows: torch.Tensor) -> torch.Tensor:
    """``tests/test_sliding_window.py``'s fake model: the block sums of
    channel 0."""
    n, wh, ww, _ = windows.shape
    return windows[..., 0].reshape(n, wh // RED, RED, ww // RED, RED).sum(dim=(2, 4))


def _window_image() -> np.ndarray:
    return np.random.default_rng(3).uniform(0, 1, WINDOW_IMAGE + (3,)).astype(np.float32)


def _window_case() -> dict:
    ran = []

    def apply(windows):
        ran.append(windows.shape[0])
        return fake_apply(windows)

    image = torch.from_numpy(_window_image())
    out = {s: sliding_window_predict(apply, image, WINDOW, STRIDE, RED, s)
           for s in ("average", "max")}
    return {"density": out, "ran": ran}


def worker(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    mesh.init_process_group(init, world, rank, "gloo")
    try:
        results = {"bn": _bn_case(), "window": _window_case(),
                   "replicated": mesh.replicate(torch.tensor([rank + 1.0])).item(),
                   "metrics": mesh.reduce_metrics(
                       {"ot_loss": torch.tensor(rank + 1.0), "loss": torch.tensor(rank + 1.0)},
                       SUMMED_TERMS)}
        for name in STEP_CASES:
            results[name] = _step_case(name)
        results["jax_loaded"] = sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "flax", "clip_ebc_tpu"))
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


# -- the tests -----------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results; the pair runs while this process computes the
    one-process references (the ``one_process`` fixture)."""
    tmp = tmp_path_factory.mktemp("ddp")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(WORLD),
         "--init", f"file://{tmp / 'store'}", "--out", str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    return procs, tmp


@pytest.fixture(scope="module")
def one_process(ranks):
    torch.set_num_threads(4)
    refs = {"bn": _bn_case(), "window": _window_case()}
    for name in ("vgg", "clip", "clip_drop"):
        refs[name] = _step_case(name, steps=1)
    return refs


@pytest.fixture(scope="module")
def results(ranks, one_process, jax_steps):
    procs, tmp = ranks
    deadline = time.monotonic() + 120
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank did not finish within 120 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    out = []
    for r in range(WORLD):  # ~0.5 GB a rank: read, then freed from the disk
        out.append(torch.load(tmp / f"rank{r}.pt", weights_only=False))
        os.remove(tmp / f"rank{r}.pt")
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def _rows(rank: int) -> slice:
    per = GLOBAL_B // WORLD
    return slice(rank * per, (rank + 1) * per)


def test_workers_import_no_jax(results):
    assert [r["jax_loaded"] for r in results] == [[], []]


def test_replicate_and_metric_reduction(results):
    """``replicate`` broadcasts rank 0's value; ``reduce_metrics`` sums the
    terms that are sums over the batch (the OT loss) and averages the
    means."""
    for r in results:
        assert r["replicated"] == 1.0
        assert r["metrics"] == {"loss": 1.5, "ot_loss": 3.0}


def test_batchnorm_statistics_are_global(results, one_process):
    want = one_process["bn"]
    for rank, got in enumerate(results):
        got = got["bn"]
        assert _rel(got["y"], want["y"][_rows(rank)]) <= REL_TOL
        assert _rel(got["dx"], want["dx"][_rows(rank)]) <= REL_TOL
        for k in ("dw", "db"):
            assert _rel(got[k], want[k]) <= REL_TOL, k
        for k in ("mean", "var"):
            assert _rel(got[k], want[k]) <= STAT_TOL, k
    # the shards' own statistics would differ: the sync is what makes them equal
    x = np.random.default_rng(7).normal(2.0, 3.0, size=(GLOBAL_B, 6, 5, 5))
    assert np.abs(x[:2].var(axis=(0, 2, 3)) - x.var(axis=(0, 2, 3))).max() > 0.1


@pytest.mark.parametrize("case", ["vgg", "clip", "clip_drop"])
def test_two_ranks_step_as_one_process(results, one_process, case):
    """N ranks of B take the step of one process at N x B: the loss, the
    DDP-averaged gradient, the trained weights and the synced BatchNorm
    statistics (the CLIP decoder's) after the step; with prompt dropout,
    each rank's rows of the global batch's mask. (One step: over two, Adam
    turns rounding into lr-sized moves of the decoder's BatchNorm shifts
    that the second forward carries everywhere; one process on 1 and on 4
    threads lands 7.5e-3 apart in relative L2. The second step is held to
    the JAX package at its files' tolerances below.)"""
    want = one_process[case]
    for got in results:
        got = got[case]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=REL_TOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            assert _rel(got["grads"][k], g) <= REL_TOL, (k, _rel(got["grads"][k], g))
        for k, v in want["state1"].items():
            if "num_batches" in k:
                assert torch.equal(got["state1"][k], v)
                continue
            if "running_" in k:
                assert _rel(got["state1"][k], v) <= STAT_TOL, (k, _rel(got["state1"][k], v))
            else:
                _check_adam_step(k, got["state1"][k], v, want["grads"][k])
    assert any("running_var" in k for k in want["state1"]) == (case != "vgg")


def _check_adam_step(name: str, got: torch.Tensor, want: torch.Tensor, grad: torch.Tensor):
    """Parameters after Adam's first step (lr x g / (|g| + eps)): within
    1e-5 relative L2, leaving out the components whose gradient is below
    1e-3 of the tensor's RMS gradient, whose step rounding alone can turn
    by up to lr either way (one process on 1 and on 4 threads moves 178 of
    the decoder's first convolution's 5.3M so, 5.9e-5 apart in relative
    L2 over the whole tensor); those within 2 lr. (The gradients
    themselves, these components included, are held to 1e-5.)"""
    loose = grad.abs() <= 1e-3 * grad.pow(2).mean().sqrt()
    assert _rel(got[~loose], want[~loose]) <= REL_TOL, (name, _rel(got[~loose], want[~loose]))
    assert float((got - want).abs().max()) <= 2 * LR, name


def test_ot_term_needs_the_world_size_factor(results, one_process):
    """Without the world-size weight on its OT sum, each rank's loss is
    not its share of the global DMCount loss and the averaged gradient
    misses the one-process gradient by far more than the tolerance."""
    want = one_process["clip"]["grads"]
    for got in results:
        got = got["clip_no_factor"]["grads"]
        errs = {k: _rel(got[k], want[k]) for k in want}
        assert max(errs.values()) > 100 * REL_TOL, errs
        assert errs["image_decoder.0.conv1.weight"] > 100 * REL_TOL, errs


@pytest.fixture(scope="module")
def jax_steps(ranks):
    """The JAX ``make_train_step`` on the global batch from the port's
    initial weights (as ``tests/test_torch_train.py`` and
    ``tests/test_torch_vgg_slice.py`` run it; the CLIP trunk on the JAX
    package's plain attention, whose trace and compile take 10 s less than
    its interpreted kernels': the kernels are held to the JAX package in
    those files): ``{case: (losses, initial state, state after)}``."""
    import jax
    import jax.numpy as jnp

    from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
    from clip_ebc_tpu.data.loader import Batch as JaxBatch
    from clip_ebc_tpu.losses import make_loss_fn as jax_make_loss_fn
    from clip_ebc_tpu.models import convert as jax_convert
    from clip_ebc_tpu.models import get_model as jax_get_model
    from clip_ebc_tpu.training.optim import make_optimizer as jax_make_optimizer
    from clip_ebc_tpu.training.optim import make_schedule as jax_make_schedule
    from clip_ebc_tpu.training.state import TrainState
    from clip_ebc_tpu.training.trainer import make_train_step
    from clip_ebc_tpu_torch.models.convert import from_jax_params, head_state_from_jax

    out = {}
    for case in ("vgg", "clip"):
        cfg = ExperimentConfig(**CFGS[case]).normalize()
        jcfg = JaxConfig(**CFGS[case]).normalize()
        port = get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, num_vpt=32, seed=0,
                         device="cpu")
        init = port.state_dict()
        if case == "clip":
            model = jax_get_model(jcfg.model, SIZE, RED, jcfg.bins, jcfg.bin_anchors,
                                  num_vpt=32, attn_backend="sdpa")
            params, stats = jax_convert.convert_reference_clip_ebc(init)
            tx = jax_make_optimizer(jcfg.weight_decay,
                                    frozen_predicate=model.frozen_param_predicate)
            text = model.apply({"params": params, "batch_stats": stats}, method="encode_text")
        else:
            model = jax_get_model(jcfg.model, SIZE, RED, jcfg.bins, jcfg.bin_anchors)
            params, stats = jax_convert.convert_reference_classifier(init)
            tx, text = jax_make_optimizer(jcfg.weight_decay), None
        state = TrainState.create(params=params, batch_stats=stats, tx=tx)
        step = jax.jit(make_train_step(model, jax_make_loss_fn(jcfg)))
        lr = jnp.asarray(jax_make_schedule(jcfg)(0), jnp.float32)
        losses = []
        for b in _batches():
            args = (text,) if text is not None else ()
            state, info = step(state, JaxBatch(*map(jnp.asarray, b)), lr, *args)
            losses.append(float(info["loss"]))
        params = jax.tree_util.tree_map(np.asarray, state.params)
        stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
        got = (from_jax_params(params, stats) if case == "clip"
               else head_state_from_jax(port, params, {}))
        out[case] = (losses, init, got)
    return out


@pytest.mark.parametrize("case", ["vgg", "clip"])
def test_two_ranks_step_as_jax_global_batch(results, jax_steps, case):
    """The ranks' step against the JAX package's on the global batch,
    which its ``Trainer`` computes under a mesh."""
    jax_losses, init, want = jax_steps[case]
    update_tol = 1e-2 if case == "clip" else 5e-2
    for got in results:
        got_losses, got = got[case]["losses"], got[case]["state"]
        np.testing.assert_allclose(got_losses, jax_losses, rtol=1e-4)
        trained = [k for k in got if k in want and "running" not in k and "num_batches" not in k
                   and not torch.equal(want[k], init[k])]
        assert len(trained) == (21 if case == "clip" else 38)
        for k in trained:
            step_got, step_want = got[k] - init[k], want[k] - init[k]
            assert _rel(step_got, step_want) <= update_tol, (k, _rel(step_got, step_want))
            assert float((got[k] - want[k]).abs().max()) <= 2 * STEPS * LR, k
        for k in (k for k in want if "running_" in k):
            assert _rel(got[k], want[k]) <= 1e-3, k


def test_sharded_sliding_window_matches_jax_mesh_and_oracle(results, one_process):
    import jax.numpy as jnp

    from clip_ebc_tpu.ops.sliding_window import sliding_window_predict as jax_sliding
    from clip_ebc_tpu.parallel.mesh import make_mesh
    from tests.test_sliding_window import fake_apply as jax_fake_apply
    from tests.test_sliding_window import numpy_sliding_oracle

    # ceil(15 / 2) windows a rank, in each of the two strategies
    assert [r["window"]["ran"] for r in results] == [[8, 8], [7, 7]]
    image = _window_image()
    for strategy in ("average", "max"):
        want = np.asarray(jax_sliding(jax_fake_apply, None, jnp.asarray(image), window=WINDOW,
                                      stride=STRIDE, reduction=RED, strategy=strategy,
                                      mesh=make_mesh()))
        oracle = numpy_sliding_oracle(image, WINDOW, STRIDE, strategy)
        for got in [r["window"]["density"][strategy] for r in results] + [
                one_process["window"]["density"][strategy]]:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_loader_shards_equal_jax(tmp_path, monkeypatch):
    """Each rank's ``TrainLoader`` shard equals the JAX loader's for that
    host: 7 images cut to 6, 3 a rank, every augmentation on."""
    from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
    from clip_ebc_tpu.data import native as jax_native
    from clip_ebc_tpu.data.crowd import CrowdDataset as JaxCrowdDataset
    from clip_ebc_tpu.data.loader import TrainLoader as JaxTrainLoader
    from clip_ebc_tpu.data.loader import make_train_transforms as jax_train_transforms
    from clip_ebc_tpu_torch.data.crowd import CrowdDataset
    from clip_ebc_tpu_torch.data.loader import TrainLoader, make_train_transforms
    from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset

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
    seen = []
    for host in range(2):
        port = TrainLoader(ds, batch_size=2, reduction=8, seed=5, host_id=host, num_hosts=2)
        ref = JaxTrainLoader(jds, batch_size=2, reduction=8, seed=5, host_id=host, num_hosts=2)
        assert len(port) == len(ref) == 3 and port.max_points == ref.max_points
        for epoch in (1, 2):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                for name in ("images", "points", "point_mask", "density"):
                    np.testing.assert_array_equal(getattr(a, name).numpy(),
                                                  np.asarray(getattr(b, name)), err_msg=name)
            seen.append(port._epoch_indices())
    # the two shards of an epoch are disjoint
    assert not set(seen[0]) & set(seen[2]) and not set(seen[1]) & set(seen[3])
    with pytest.raises(ValueError, match="host_id"):
        TrainLoader(ds, batch_size=2, reduction=8, host_id=2, num_hosts=2)


def test_shard_batch_needs_a_batch_the_world_divides():
    batch = Batch(*map(torch.from_numpy, _batches()[0]))
    halves = [mesh.shard_batch(batch, rank=r, world=2) for r in range(2)]
    assert torch.equal(torch.cat([h.images for h in halves]), batch.images)
    assert mesh.shard_rows(15, rank=1, world=2) == slice(8, 15)
    assert mesh.shard_rows(1, rank=1, world=2) == slice(1, 1)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(batch, rank=0, world=3)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="One rank of the data-parallel cases.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    worker(a.rank, a.world, a.init, a.out)
