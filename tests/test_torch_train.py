"""The port's VPT training against the JAX package's, and its trainer CLI.

Three optimizer steps of CLIP-EBC ViT-B/16 (12 layers, width 768, deep
VPT-32, the 12-layer text tower, the 768-channel decoder) on 32 px
windows (L = 1 + 32 + 4 = 37 tokens), batch 2, fp32, DACE + DMCount loss,
from the same weights (the port's seeded init carried into the JAX
package by its own ``convert_reference_clip_ebc``) and the same seeded
batches. The port runs its ``Trainer`` with the fused attention path
(its plain versions on the CPU: the forward, the split backward of an
fp32 frozen block); the JAX side runs its ``make_train_step`` with the
Pallas kernels interpreting (the frozen LN + QKV backward included).

Tolerances: the loss of each step 1e-4 relative (fp32, sums in another
order). The trained parameters: the update of each tensor over the 3
steps (after - before) within 1e-2 relative L2 of the JAX update, and no
element further than 2 x 3 x lr from it. Adam divides each gradient by
its own running RMS, so a component whose gradient is at the level of
fp32 summation noise steps by up to lr in either direction on each side
(measured: 0.01% of the decoder's first convolution); the relative L2
over the tensor stays small while such components are rare. The
BatchNorm running statistics 1e-3 relative L2 (they average batch
statistics of the slightly different convolutions; measured 1.5e-4); the
frozen trunk and text tower bit-identical to the initial weights on the
port side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from clip_ebc_tpu.config import ExperimentConfig as JaxConfig
from clip_ebc_tpu.data.loader import Batch as JaxBatch
from clip_ebc_tpu.losses import make_loss_fn as jax_make_loss_fn
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.training.optim import make_optimizer as jax_make_optimizer
from clip_ebc_tpu.training.optim import make_schedule as jax_make_schedule
from clip_ebc_tpu.training.state import TrainState
from clip_ebc_tpu.training.trainer import make_train_step
from clip_ebc_tpu_torch.cli import predict, trainer as trainer_cli
from clip_ebc_tpu_torch.config import ExperimentConfig
from clip_ebc_tpu_torch.data.loader import Batch
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from clip_ebc_tpu_torch.losses import make_loss_fn
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.convert import from_jax_params
from clip_ebc_tpu_torch.training.trainer import Trainer

torch.set_num_threads(4)
SIZE, RED, BATCH, STEPS = 32, 8, 2, 3
CFG = dict(model="clip_vit_b_16", input_size=SIZE, reduction=RED, truncation=4, dataset="qnrf",
           count_loss="dmcount", warmup_lr=1e-3, batch_size=BATCH, seed=0)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        images = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        points = np.zeros((BATCH, 16, 2), np.float32)
        mask = np.zeros((BATCH, 16), bool)
        density = np.zeros((BATCH, SIZE // RED, SIZE // RED), np.float32)
        for i, n in enumerate((int(rng.integers(1, 16)), 0)):  # the second image has no points
            points[i, :n] = rng.uniform(0, SIZE, size=(n, 2))
            mask[i, :n] = True
            for x, y in points[i, :n]:
                density[i, int(y) // RED, int(x) // RED] += 1.0
        out.append((images, points, mask, density))
    return out


@pytest.fixture(scope="module")
def port_run():
    cfg = ExperimentConfig(**CFG).normalize()
    model = get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, num_vpt=32, seed=0,
                      device="cpu", attn_backend="fused")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, make_loss_fn(cfg))
    trainer.set_epoch_lr(1)
    model.train()
    text = trainer.text_features()
    losses = [float(trainer.train_step(Batch(*map(torch.from_numpy, b)), text)["loss"])
              for b in _batches()]
    return init, model.state_dict(), losses


@pytest.fixture(scope="module")
def jax_run(port_run):
    init = port_run[0]
    cfg = JaxConfig(**CFG).normalize()
    model = jax_get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, num_vpt=32,
                          attn_backend="fused")
    params, stats = jax_convert.convert_reference_clip_ebc(init)
    tx = jax_make_optimizer(cfg.weight_decay, frozen_predicate=model.frozen_param_predicate)
    state = TrainState.create(params=params, batch_stats=stats, tx=tx)
    text = model.apply({"params": params, "batch_stats": stats}, method="encode_text")
    step = jax.jit(make_train_step(model, jax_make_loss_fn(cfg)))
    lr = jnp.asarray(jax_make_schedule(cfg)(0), jnp.float32)
    losses = []
    for b in _batches():
        state, info = step(state, JaxBatch(*map(jnp.asarray, b)), lr, text)
        losses.append(float(info["loss"]))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return from_jax_params(params, stats), losses


def test_losses_match_jax(port_run, jax_run):
    np.testing.assert_allclose(port_run[2], jax_run[1], rtol=1e-4)


def test_trained_parameters_match_jax(port_run, jax_run):
    init, got, _ = port_run
    want = jax_run[0]
    lr = 1e-3
    trained = [k for k in got if k.startswith(("vpt_", "image_decoder.", "projection.", "logit_scale"))
               and "running" not in k and "num_batches" not in k]
    assert len(trained) == 12 + 6 + 2 + 1  # prompts, BasicBlock(768), projection, logit scale
    for k in trained:
        step_got, step_want = got[k] - init[k], want[k] - init[k]
        assert float(step_want.norm()) > 0, f"{k} did not train"
        rel = float((step_got - step_want).norm() / step_want.norm())
        assert rel <= 1e-2, (k, rel)
        assert float((got[k] - want[k]).abs().max()) <= 2 * STEPS * lr, k
    for k in (k for k in got if "running_" in k):
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel <= 1e-3, (k, rel)
    frozen = [k for k in got if k.startswith(("image_encoder.", "text_encoder."))]
    assert frozen and all(torch.equal(got[k], init[k]) for k in frozen)


def test_vpt_drop_follows_flax_dropout():
    """Prompt dropout (``vpt_drop``), read at every block's input (rows
    ``[1, 1 + num_vpt)``): in training mode each window's prompt entries
    are kept with probability 1 - rate and scaled by 1 / (1 - rate), as
    flax ``Dropout`` does to the JAX package's broadcast prompts; the noise
    comes from the caller's generator (same seed, same mask); eval mode
    leaves the prompts as they are. Tolerances: the share of dropped
    entries within 0.01 of the rate (1.2e6 entries: 0.01 is ~20 standard
    deviations); the kept values equal to flax's within 1e-6 relative (one
    fp32 division on each side)."""
    rate, n = 0.3, 4
    cfg = ExperimentConfig(**CFG).normalize()
    model = get_model(cfg.model, SIZE, RED, cfg.bins, cfg.bin_anchors, num_vpt=32, seed=0,
                      device="cpu", vpt_drop=rate)
    enc = model.image_encoder
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32))

    def prompts_seen(seed):
        seen = []
        hooks = [b.register_forward_pre_hook(lambda m, a: seen.append(a[0][:, 1:33].clone()))
                 for b in enc.transformer.resblocks]
        with torch.no_grad():
            enc(x, model.vpt(), torch.Generator().manual_seed(seed))
        for h in hooks:
            h.remove()
        return torch.stack(seen)  # (layers, windows, num_vpt, width)

    vpt = torch.stack([p.detach() for p in model.vpt()])[:, None].expand(-1, n, -1, -1)
    model.eval()
    assert torch.equal(prompts_seen(0), vpt)
    model.train()
    got, again, other = prompts_seen(0), prompts_seen(0), prompts_seen(1)
    assert torch.equal(got, again) and not torch.equal(got, other)
    kept = got != 0
    assert abs(1 - float(kept.float().mean()) - rate) <= 0.01
    assert not torch.equal(kept[:, 0], kept[:, 1])  # each window draws its own mask
    flax_out = np.asarray(flax_nn.Dropout(rate).apply(
        {}, jnp.asarray(vpt.numpy()), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    flax_kept = flax_out != 0
    assert abs(1 - flax_kept.mean() - rate) <= 0.01
    both = kept.numpy() & flax_kept
    np.testing.assert_allclose(got.numpy()[both], flax_out[both], rtol=1e-6)
    np.testing.assert_allclose(got[kept].numpy(), vpt[kept].numpy() / (1 - rate), rtol=1e-6)


def _tiny_dataset(root):
    make_synthetic_crowd_dataset(str(root), "qnrf", n_train=4, n_val=2, size=(64, 96),
                                 max_count=40, seed=0)
    return str(root)


def test_trainer_cli_writes_a_checkpoint_that_predict_loads(tmp_path):
    data = _tiny_dataset(tmp_path / "data")
    ckpt = tmp_path / "ckpt"
    trainer_cli.main([
        "--model", "clip_vit_b_16", "--dataset", "qnrf", "--input_size", "32", "--reduction", "8",
        "--truncation", "4", "--num_vpt", "32", "--count_loss", "dmcount", "--batch_size", "4",
        "--num_crops", "2", "--sliding_window", "--window_size", "32", "--stride", "32",
        "--warmup_lr", "1e-3", "--total_epochs", "1", "--eval_start", "1", "--data_root", data,
        "--ckpt_dir", str(ckpt), "--eval_disable_size_check", "--device", "cpu",
        "--num_workers", "2",
    ])
    best = ckpt / "best" / "1.pt"
    assert best.exists() and (ckpt / "latest.pt").exists()
    out = tmp_path / "counts.csv"
    predict.main([str(tmp_path / "data" / "qnrf" / "val" / "images"), "--device", "cpu",
                  "--sliding_window", "--window_size", "32", "--stride", "32",
                  "--weight_path", str(best), "--out", str(out)])
    rows = out.read_text().splitlines()[1:]
    assert len(rows) == 2 and all(np.isfinite(float(r.split(",")[1])) for r in rows)


@pytest.mark.parametrize("extra", [
    ["--pretrained", "clip.pt"], ["--profile_dir", "p"],
])
def test_trainer_cli_refuses_unported_options(tmp_path, extra):
    argv = ["--model", "clip_vit_b_16", "--dataset", "qnrf", "--truncation", "4",
            "--data_root", str(tmp_path), "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        trainer_cli.main(argv + extra)
