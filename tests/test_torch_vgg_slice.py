"""The port's ``vgg19_ae`` slice (the trainer's default model) against the
JAX package's: train steps of the Classifier (DACE with the DMCount count
loss) and of the Regressor (``--regression``: plain DMCount), then the
trainer, predict and NWPU CLIs end to end.

Weights: the port's seeded init, carried into the JAX package by its own
``convert_reference_classifier``, which reads the reference's torch names
(``backbone.features.{i}``, ``backbone.reg_layer.{0,2}``, ``classifier``,
``regressor.0``): the port's names are those. Batches: seeded numpy, 32 px,
batch 2, the second image without points.

Tolerances (fp32): each step's loss 1e-4 relative; the first step's
gradient of each parameter 1e-4 relative L2 (measured 2.4e-6); each
parameter's update over the steps (after - before) within 5e-2 relative
L2 of the JAX update, and no element further than 2 x steps x lr from the
JAX value. Adam divides each gradient by its own running RMS, so a
component whose gradient is at the level of summation noise steps by up
to lr either way: the Regressor's first conv (1,728 weights) moved 1.8%
apart in relative L2 with gradients 2.4e-6 apart. CLI counts: 1e-4
relative against the JAX ``Evaluator`` on the same weights and images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
from clip_ebc_tpu.data.crowd import _load_image as jax_load_image
from clip_ebc_tpu.data.crowd import normalize_image as jax_normalize
from clip_ebc_tpu.data.loader import Batch as JaxBatch
from clip_ebc_tpu.losses import make_loss_fn as jax_make_loss_fn
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu.training.optim import make_optimizer as jax_make_optimizer
from clip_ebc_tpu.training.optim import make_schedule as jax_make_schedule
from clip_ebc_tpu.training.state import TrainState
from clip_ebc_tpu.training.trainer import make_train_step
from clip_ebc_tpu_torch.cli import predict, test_nwpu
from clip_ebc_tpu_torch.cli import trainer as trainer_cli
from clip_ebc_tpu_torch.config import ExperimentConfig
from clip_ebc_tpu_torch.data.loader import Batch
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from clip_ebc_tpu_torch.losses import make_loss_fn
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.convert import head_state_from_jax
from clip_ebc_tpu_torch.training.trainer import Trainer

torch.set_num_threads(4)
SIZE, RED, BATCH, STEPS, LR = 32, 8, 2, 2, 1e-3
CFG = dict(model="vgg19_ae", input_size=SIZE, reduction=RED, truncation=4, dataset="shb",
           count_loss="dmcount", warmup_lr=LR, batch_size=BATCH, seed=0)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        images = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        points = np.zeros((BATCH, 16, 2), np.float32)
        mask = np.zeros((BATCH, 16), bool)
        density = np.zeros((BATCH, SIZE // RED, SIZE // RED), np.float32)
        for i, n in enumerate((int(rng.integers(1, 16)), 0)):
            points[i, :n] = rng.uniform(0, SIZE, size=(n, 2))
            mask[i, :n] = True
            for x, y in points[i, :n]:
                density[i, int(y) // RED, int(x) // RED] += 1.0
        out.append((images, points, mask, density))
    return out


def _run_both(regression: bool):
    """``STEPS`` steps through the port's ``Trainer`` and the JAX
    ``make_train_step`` from the same weights; returns (initial port state,
    port state after, JAX params after as a port state, both loss lists,
    both first-step gradients)."""
    cfg = ExperimentConfig(regression=regression, **CFG).normalize()
    model = get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, seed=0, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, make_loss_fn(cfg))
    trainer.set_epoch_lr(1)
    model.train()
    losses, grads = [], None
    for b in _batches():
        losses.append(float(trainer.train_step(Batch(*map(torch.from_numpy, b)))["loss"]))
        grads = grads or {n: p.grad.clone() for n, p in model.named_parameters()}

    jcfg = JaxConfig(regression=regression, **CFG).normalize()
    jmodel = jax_get_model(jcfg.model, SIZE, RED, jcfg.bins, jcfg.bin_anchors)
    params, stats = jax_convert.convert_reference_classifier(init)
    state = TrainState.create(params=params, batch_stats=stats,
                              tx=jax_make_optimizer(jcfg.weight_decay))
    step = jax.jit(make_train_step(jmodel, jax_make_loss_fn(jcfg)))
    jax_loss = jax_make_loss_fn(jcfg)
    first = JaxBatch(*map(jnp.asarray, _batches()[0]))

    def loss_of(p):
        (logits, dens), _ = jmodel.apply({"params": p}, first.images, train=True, mutable=[])
        return jax_loss(logits, dens, first)[0]

    jax_grads = head_state_from_jax(
        model, jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_of))(params)), {})
    lr = jnp.asarray(jax_make_schedule(jcfg)(0), jnp.float32)
    jax_losses = []
    for b in _batches():
        state, info = step(state, JaxBatch(*map(jnp.asarray, b)), lr)
        jax_losses.append(float(info["loss"]))
    want = head_state_from_jax(model, jax.tree_util.tree_map(np.asarray, state.params), {})
    return init, model.state_dict(), want, losses, jax_losses, grads, jax_grads


@pytest.mark.parametrize("regression", [False, True], ids=["dace_dmcount", "regression"])
def test_train_steps_match_jax(regression):
    init, got, want, losses, jax_losses, grads, jax_grads = _run_both(regression)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert sorted(got) == sorted(want) == sorted(grads) == sorted(jax_grads)
    for k in grads:
        rel = float((grads[k] - jax_grads[k]).norm() / jax_grads[k].norm())
        assert rel <= 1e-4, (k, rel)
    # 16 VGG convs, 2 reg_layer convs, the head's conv: weight and bias each
    assert len(got) == 2 * (16 + 2 + 1)
    for k in got:
        step_got, step_want = got[k] - init[k], want[k] - init[k]
        assert float(step_want.norm()) > 0, f"{k} did not train"
        rel = float((step_got - step_want).norm() / step_want.norm())
        assert rel <= 5e-2, (k, rel)
        assert float((got[k] - want[k]).abs().max()) <= 2 * STEPS * LR, k


def _jax_counts(weights: str, regression: bool, paths, pad: int):
    """The JAX Evaluator's whole-image counts on ``paths`` with the weights
    of a port checkpoint, read by ``convert_reference_classifier``."""
    cfg = JaxConfig(regression=regression, **CFG).normalize()
    model = jax_get_model("vgg19_ae", SIZE, RED, cfg.bins, cfg.bin_anchors)
    params, stats = jax_convert.convert_reference_classifier(
        torch.load(weights, map_location="cpu", weights_only=True))
    ev = JaxEvaluator(model, reduction=RED, pad_to_multiple=pad)
    return [ev.predict_count({"params": params}, jax_normalize(jax_load_image(str(p))))
            for p in paths]


def _train(tmp_path, data, regression: bool):
    ckpt = tmp_path / ("ckpt_reg" if regression else "ckpt")
    trainer_cli.main([  # no --model: the CLI's default, vgg19_ae
        "--dataset", "shb", "--input_size", str(SIZE), "--reduction", str(RED),
        "--truncation", "4", "--count_loss", "dmcount", "--batch_size", "2",
        "--warmup_lr", "1e-3", "--total_epochs", "1", "--eval_start", "1", "--data_root", data,
        "--ckpt_dir", str(ckpt), "--eval_disable_size_check", "--device", "cpu",
        "--num_workers", "2", *(["--regression"] if regression else []),
    ])
    assert (ckpt / "latest.pt").exists()
    return ckpt / "best" / "1.pt"


def test_cli_slice_matches_jax(tmp_path):
    """The trainer CLI with its defaults (``vgg19_ae``) and with
    ``--regression`` for one epoch on a tiny synthetic ``shb``; the predict
    CLI on the Classifier's best checkpoint (whole images) and the NWPU CLI
    on the Regressor's, each count against the JAX Evaluator."""
    data = make_synthetic_crowd_dataset(str(tmp_path / "data"), "shb", n_train=4, n_val=2,
                                        size=(64, 96), max_count=40, seed=0)
    best = _train(tmp_path, data, regression=False)
    latest = torch.load(best.parent.parent / "latest.pt", map_location="cpu", weights_only=True)
    assert latest["step"] == 2 and "backbone.features.0.weight" in latest["model"]
    val = sorted((tmp_path / "data" / "shb" / "val" / "images").iterdir())
    out = tmp_path / "counts.csv"
    predict.main([str(val[0].parent), "--model", "vgg19_ae", "--bins_dataset", "shb",
                  "--device", "cpu", "--weight_path", str(best), "--out", str(out)])
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    assert [r[0] for r in rows] == [p.name for p in val]
    want = _jax_counts(str(best), False, val, pad=RED)
    np.testing.assert_allclose([float(r[1]) for r in rows], want, rtol=1e-4, atol=0.01)

    best_reg = _train(tmp_path, data, regression=True)
    nwpu = tmp_path / "data" / "nwpu" / "test" / "images"
    nwpu.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in (3098, 3099):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(nwpu / f"{i}.jpg")
    test_nwpu.main(["--model", "vgg19_ae", "--regression", "--data_root", data,
                    "--weight_path", str(best_reg), "--result_dir", str(tmp_path / "res"),
                    "--disable_size_check", "--device", "cpu"])
    lines = (tmp_path / "res" / "best_1.txt").read_text().split("\n")
    assert [line.split(" ")[0] for line in lines] == ["3098", "3099"]
    want = _jax_counts(str(best_reg), True, sorted(nwpu.iterdir()), pad=0)
    np.testing.assert_allclose([float(line.split(" ")[1]) for line in lines], want,
                               rtol=1e-4, atol=1e-4)


def test_quant_is_refused_for_vgg(tmp_path):
    """``--quant`` quantizes the CLIP trunk only, as in the JAX CLIs."""
    with pytest.raises(SystemExit, match="only supported for clip_"):
        predict.main([str(tmp_path), "--model", "vgg19_ae", "--quant", "int8", "--device", "cpu"])
