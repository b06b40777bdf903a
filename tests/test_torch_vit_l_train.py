"""ViT-L/14 training by VPT on the port against the JAX package: the
frozen backward's plain versions at ViT-L's width, a VPT step's
gradients, and the trainer CLI.

* ``ln_qkv_bwd_frozen_plain`` (the plain version of row 5: the
  recompute, ``attention_bwd_plain`` and ``ln_bwd_dx_plain``) at a ViT-L
  window's shape (289 tokens, D = 1024, 16 heads; all keys and keys past
  250 masked) against the JAX kernel ``_ln_qkv_bwd_frozen``, interpreted
  on the CPU; ``ln_bwd_dx_plain`` alone at D = 1024 against float64 numpy
  on rows of mean 50 +- 0.1. Tolerances of ``tests/test_torch_attention_bwd.py``:
  fp32 1e-4, bf16 2e-2 of the largest magnitude (1e-4 of it in fp32 on
  the large-mean rows).
* A VPT train step of ``clip_vit_l_14`` in fp32 (two blocks at width
  1024 and 16 heads, 56 px windows: 1 + 32 + 16 tokens) against the JAX
  float64 gradient, as ``tests/test_torch_clip_vit.py`` holds ViT-B/32's:
  5e-3 over all, 2e-2 a tensor. Both attention backends the trainer may
  route through: ``"auto"`` (plain on the CPU) and ``"fused"``, whose
  autograd takes the split path (fp32) around ``attention_bwd_plain``.
* The trainer CLI on ``clip_vit_l_14`` (two blocks) with ``--device cpu``
  for one epoch of two steps on a synthetic ``qnrf``: the trunk and the
  text tower bit-identical, the prompts and the decoder moved, the
  checkpoint served by the predict CLI.

The trunk is cut to two blocks in both packages (``VIT_CONFIGS`` patched
for the test), at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_ie
from clip_ebc_tpu.ops.fused_attention import _ln_qkv_bwd_frozen
from clip_ebc_tpu_torch.cli import predict
from clip_ebc_tpu_torch.cli import trainer as trainer_cli
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip import image_encoder as ie
from clip_ebc_tpu_torch.models.convert import from_jax_params
from clip_ebc_tpu_torch.ops.fused_attention import (
    ln_bwd_dx_plain,
    ln_qkv_bwd_frozen,
    ln_qkv_bwd_frozen_plain,
)
from test_torch_attention_bwd import _close, _close_scaled, _t
from test_torch_models import _seeded_variables, _train_variables, rel

torch.set_num_threads(4)
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
B, L, D, H = 1, 289, 1024, 16  # a ViT-L window: 1 + 32 + 16 x 16 tokens
SM = (D // H) ** -0.5
DEPTH, SIZE = 2, 56


@pytest.fixture
def cut_depth(monkeypatch):
    for table in (jax_ie.VIT_CONFIGS, ie.VIT_CONFIGS):
        patch, width, _, heads, embed = table["vit_l_14"]
        monkeypatch.setitem(table, "vit_l_14", (patch, width, DEPTH, heads, embed))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    g = rng.normal(size=(B, L, D)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)  # JAX (in, out)
    bias = (0.02 * rng.normal(size=3 * D)).astype(np.float32)
    return x, g, ln_w, ln_b, w, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [L, 250])
def test_ln_qkv_bwd_frozen_plain_matches_jax_kernel_at_vit_l_width(dtype, kv_len):
    x, g, ln_w, ln_b, w, bias = _inputs(seed=kv_len)
    jdt = getattr(jnp, dtype)
    want = _ln_qkv_bwd_frozen(
        jnp.asarray(x, jdt), jnp.asarray(g, jdt), jnp.asarray(ln_w), jnp.asarray(ln_b),
        jnp.asarray(w, jdt), jnp.asarray(bias), H, kv_len, SM, 1e-5, 1, True,
    )
    args = (_t(x, dtype), _t(g, dtype), _t(ln_w), _t(ln_b), _t(w.T, dtype), _t(bias))
    got = ln_qkv_bwd_frozen_plain(*args, H, kv_len, SM)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, L, D)
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    before = ln_qkv_bwd_frozen.launches
    assert torch.equal(ln_qkv_bwd_frozen(*args, H, kv_len, SM), got)  # a CPU tensor: uncounted
    assert ln_qkv_bwd_frozen.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_bwd_dx_plain_at_vit_l_width(dtype):
    """dy = d_qkv W and the frozen LayerNorm's backward at D = 1024 (the
    shape of the dx kernel's cluster of 8) on rows of mean 50 +- 0.1,
    against float64 numpy."""
    rng = np.random.default_rng(5)
    m = 3 * 64 + 5  # rows past a 128-row tile, ragged
    x = (50.0 + 0.1 * rng.normal(size=(m, D))).astype(np.float32)
    dqkv = rng.normal(size=(m, 3 * D)).astype(np.float32)
    gam = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    w = (rng.normal(size=(3 * D, D)) * D**-0.5).astype(np.float32)  # nn.Linear (out, in)
    xt, dt_, wt = _t(x, dtype), _t(dqkv, dtype), _t(w, dtype)
    got = ln_bwd_dx_plain(xt, dt_, _t(gam), wt)
    x64 = xt.double().numpy()
    mu = x64.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    xhat = (x64 - mu) * rstd
    dyh = (dt_.double().numpy() @ wt.double().numpy()) * gam
    want = rstd * (dyh - dyh.mean(-1, keepdims=True) - xhat * (dyh * xhat).mean(-1, keepdims=True))
    assert got.dtype == getattr(torch, dtype)
    _close_scaled(got.float().numpy(), want, dtype)


_STEP: dict = {}


def _vpt_step_case() -> dict:
    """The inputs, weights and JAX float64 gradient of one VPT step, made
    once for every backend the port is held to it on."""
    if _STEP:
        return _STEP
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    text = rng.normal(size=(len(BINS), 768)).astype(np.float32)
    r_logits = rng.normal(size=(2, SIZE // 8, SIZE // 8, len(BINS))).astype(np.float32)
    r_dens = rng.normal(size=(2, SIZE // 8, SIZE // 8)).astype(np.float32)
    v = _train_variables(_seeded_variables(
        jax_get_model("clip_vit_l_14", SIZE, 8, BINS, ANCHORS), jnp.asarray(x)))

    def jax_grads(dt):
        jm = jax_get_model("clip_vit_l_14", SIZE, 8, BINS, ANCHORS, dtype=dt)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), t)  # noqa: E731

        def loss(params):
            (lg, dens), _ = jm.apply({"params": params, "batch_stats": cast(v["batch_stats"])},
                                     jnp.asarray(x, dt), train=True,
                                     text_feats=jnp.asarray(text, dt), mutable=["batch_stats"])
            return jnp.sum(lg * r_logits) + jnp.sum(dens * r_dens)

        g = jax.jit(jax.grad(loss))(cast(v["params"]))
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
        sd = from_jax_params(g, v["batch_stats"], (1024,))
        return {k: t.double().numpy() for k, t in sd.items()}

    with jax.enable_x64():
        want = jax_grads(jnp.float64)
    _STEP.update(x=x, text=text, r_logits=r_logits, r_dens=r_dens, v=v, want=want)
    return _STEP


@pytest.mark.parametrize("attn_backend", ["auto", "fused"])
def test_clip_vit_l_14_vpt_step_gradients_match_jax(cut_depth, attn_backend):
    """A VPT train step of ``clip_vit_l_14`` in fp32 (a seeded linear
    function of the logits and the density): the prompts, the decoder, the
    projection and the logit scale against the JAX float64 gradient; the
    trunk and the text tower frozen, with no gradient in the port."""
    case = _vpt_step_case()
    x, text, r_logits, r_dens, v, want = (case[k] for k in ("x", "text", "r_logits", "r_dens", "v",
                                                            "want"))
    pm = get_model("clip_vit_l_14", SIZE, 8, BINS, ANCHORS, device="cpu", attn_backend=attn_backend)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"], pm.decoder_cfg), strict=True)
    pm.train()
    lg, dens = pm(torch.from_numpy(x), text_feats=torch.from_numpy(text))
    (torch.sum(lg * torch.from_numpy(r_logits)) + torch.sum(dens * torch.from_numpy(r_dens))).backward()
    got, ref, trained = [], [], set()
    for name, p in pm.named_parameters():
        if name.startswith(("image_encoder.", "text_encoder.")):
            assert not p.requires_grad and p.grad is None, name
            continue
        assert p.requires_grad and p.grad is not None, name
        trained.add(name.split(".")[0])
        got.append(p.grad.double().numpy().ravel())
        ref.append(want[name].ravel())
        assert rel(got[-1], ref[-1]) <= 2e-2, (name, rel(got[-1], ref[-1]))
    assert trained == {"vpt_0", "vpt_1", "image_decoder", "projection", "logit_scale"}
    assert rel(np.concatenate(got), np.concatenate(ref)) <= 5e-3


def test_trainer_cli_trains_vit_l_14_on_the_cpu(cut_depth, tmp_path):
    data = make_synthetic_crowd_dataset(str(tmp_path / "data"), "qnrf", n_train=4, n_val=1,
                                        size=(64, 96), max_count=40, seed=0)
    ckpt = tmp_path / "ckpt"
    trainer_cli.main([
        "--model", "clip_vit_l_14", "--dataset", "qnrf", "--input_size", str(SIZE),
        "--reduction", "8", "--truncation", "4", "--num_vpt", "32", "--count_loss", "dmcount",
        "--batch_size", "2", "--num_crops", "1", "--sliding_window", "--window_size", str(SIZE),
        "--stride", str(SIZE), "--warmup_lr", "1e-3", "--total_epochs", "1", "--eval_start", "1",
        "--data_root", data, "--ckpt_dir", str(ckpt), "--eval_disable_size_check",
        "--device", "cpu", "--num_workers", "2",
    ])
    latest = torch.load(ckpt / "latest.pt", map_location="cpu", weights_only=True)
    assert latest["step"] == 2
    init = get_model("clip_vit_l_14", SIZE, 8, BINS, ANCHORS, seed=42, device="cpu").state_dict()
    trained = latest["model"]
    for k in init:
        if k.startswith(("image_encoder.", "text_encoder.")):
            assert torch.equal(init[k], trained[k]), k  # frozen
    moved = {k.split(".")[0] for k in init if not torch.equal(init[k], trained[k])}
    assert {"vpt_0", "vpt_1", "image_decoder"} <= moved, moved
    out = tmp_path / "counts.csv"
    val = tmp_path / "data" / "qnrf" / "val" / "images"
    predict.main([str(val), "--model", "clip_vit_l_14", "--input_size", str(SIZE), "--device", "cpu",
                  "--sliding_window", "--window_size", str(SIZE), "--stride", str(SIZE),
                  "--weight_path", str(ckpt / "best" / "1.pt"), "--out", str(out)])
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    assert len(rows) == 1 and np.isfinite(float(rows[0][1]))
