"""The port's losses against the JAX package: the batched Sinkhorn solvers
against ``jax.vmap`` of the per-image ones, and ``dmcount_loss`` and
``dace_loss`` (mae, dmcount) in value and gradient, on seeded densities
and padded point sets that include an image with no points and images
that converge at different iterations.

Tolerances: the solvers' scalings and duals 1e-4 relative (fp32 products
summed in another order; the iteration counts must be equal); loss values
and gradients 1e-4 relative, fp32 throughout on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.losses import DMCountConfig as JaxDMCfg
from clip_ebc_tpu.losses import dace_loss as jax_dace
from clip_ebc_tpu.losses import dmcount_loss as jax_dmcount
from clip_ebc_tpu.losses import sinkhorn as jax_sinkhorn
from clip_ebc_tpu.losses import sinkhorn_separable as jax_sinkhorn_sep
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.losses import DMCountConfig, dace_loss, dmcount_loss, sinkhorn, sinkhorn_separable

torch.set_num_threads(2)
RTOL = 1e-4
SIZE, RED = 64, 8  # an 8 x 8 density grid
H = SIZE // RED


def _points(seed, counts, pmax=24):
    """(B, pmax, 2) padded points, (B, pmax) mask; ``counts`` per image."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((len(counts), pmax, 2), np.float32)
    mask = np.zeros((len(counts), pmax), bool)
    for i, n in enumerate(counts):
        pts[i, :n] = rng.uniform(0, SIZE, size=(n, 2))
        mask[i, :n] = True
    return pts, mask


def _density(seed, b):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.5, size=(b, H, H)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("reg,stop_thr,max_iters", [(10.0, 1e-9, 100), (100.0, 1e-6, 300)])
def test_sinkhorn_separable_matches_jax_vmap(reg, stop_thr, max_iters):
    """DMCount's settings, then a smoother kernel and a looser threshold
    under which the images converge at different iterations (30 to 300);
    each must stop where its JAX loop stops."""
    pts, mask = _points(0, [5, 0, 17, 24, 1])
    b = len(mask)
    src = _density(1, b)
    src = src / src.sum((1, 2), keepdims=True)
    n = mask.sum(1)
    a = np.where(mask, 1.0 / np.maximum(n, 1)[:, None], 0.0).astype(np.float32)
    cood = np.arange(0, SIZE, RED, dtype=np.float32) + RED / 2
    kx = np.exp(-((pts[..., 0:1] - cood) ** 2) / reg).astype(np.float32)
    ky = np.exp(-((pts[..., 1:2] - cood) ** 2) / reg).astype(np.float32)
    want = jax.vmap(
        lambda a_, b_, y_, x_, m_: jax_sinkhorn_sep(
            a_, b_, y_, x_, reg=reg, max_iters=max_iters, stop_thr=stop_thr, a_mask=m_)
    )(a, src, ky, kx, mask)
    got = sinkhorn_separable(*(torch.from_numpy(t) for t in (a, src, ky, kx)), reg=reg,
                             max_iters=max_iters, stop_thr=stop_thr,
                             a_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    if reg == 100.0:
        assert len(set(np.asarray(want.iters).tolist())) > 1  # images stop apart
    for name in ("u", "v", "beta", "alpha"):
        _close(getattr(got, name).numpy(), getattr(want, name))
    finite = np.isfinite(np.asarray(want.err))
    _close(got.err.numpy()[finite], np.asarray(want.err)[finite], rtol=1e-3)


def test_dense_sinkhorn_matches_jax_vmap():
    rng = np.random.default_rng(3)
    b, na, nb = 3, 7, 20
    mask = np.ones((b, na), bool)
    mask[1, 4:] = False
    a = np.where(mask, 1.0 / mask.sum(1, keepdims=True), 0.0).astype(np.float32)
    bb = rng.uniform(size=(b, nb)).astype(np.float32)
    bb /= bb.sum(1, keepdims=True)
    cost = rng.uniform(0, 30, size=(b, na, nb)).astype(np.float32)
    want = jax.vmap(lambda a_, b_, c_, m_: jax_sinkhorn(a_, b_, c_, a_mask=m_))(a, bb, cost, mask)
    got = sinkhorn(*(torch.from_numpy(t) for t in (a, bb, cost)), a_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for name in ("plan", "u", "v", "beta"):
        _close(getattr(got, name).numpy(), getattr(want, name))


def _batch(seed):
    pts, mask = _points(seed, [9, 0, 20, 3])
    pred = _density(seed + 1, len(mask))
    target = np.zeros_like(pred)
    for i in range(len(mask)):  # block-summed dot map of the points
        for x, y in pts[i, mask[i]]:
            target[i, int(y) // RED, int(x) // RED] += 1.0
    return pred, target, pts, mask


def _jax_value_and_grad(fn, pred):
    (loss, info), grad = jax.value_and_grad(fn, has_aux=True)(jnp.asarray(pred))
    return float(loss), {k: float(v) for k, v in info.items()}, np.asarray(grad)


def _port_value_and_grad(fn, pred):
    p = torch.from_numpy(pred).requires_grad_(True)
    loss, info = fn(p)
    loss.backward()
    return float(loss.detach()), {k: float(v) for k, v in info.items()}, p.grad.numpy()


def _compare(got, want):
    assert sorted(got[1]) == sorted(want[1])
    _close(got[0], want[0])
    for k in want[1]:
        _close(got[1][k], want[1][k])
    _close(got[2], want[2])


def test_dmcount_loss_matches_jax():
    pred, target, pts, mask = _batch(10)
    want = _jax_value_and_grad(
        lambda p: jax_dmcount(p, target, pts, mask, JaxDMCfg(SIZE, RED)), pred)
    t = [torch.from_numpy(a) for a in (target, pts, mask)]
    got = _port_value_and_grad(lambda p: dmcount_loss(p, *t, DMCountConfig(SIZE, RED)), pred)
    _compare(got, want)


@pytest.mark.parametrize("count_loss", ["mae", "dmcount"])
def test_dace_loss_matches_jax(count_loss):
    bins, _ = get_bins_and_anchors(8, 4, "qnrf")
    pred, target, pts, mask = _batch(20)
    logits = np.random.default_rng(21).normal(size=pred.shape + (len(bins),)).astype(np.float32)
    want_l = jax.grad(
        lambda lg: jax_dace(lg, pred, target, pts, mask, bins, count_loss=count_loss,
                            dm_cfg=JaxDMCfg(SIZE, RED))[0])(jnp.asarray(logits))
    want = _jax_value_and_grad(
        lambda p: jax_dace(logits, p, target, pts, mask, bins, count_loss=count_loss,
                           dm_cfg=JaxDMCfg(SIZE, RED)), pred)
    t = [torch.from_numpy(a) for a in (target, pts, mask)]
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = _port_value_and_grad(
        lambda p: dace_loss(lg, p, *t, bins, count_loss=count_loss, dm_cfg=DMCountConfig(SIZE, RED)),
        pred)
    _compare(got, want)
    _close(lg.grad.numpy(), np.asarray(want_l))
