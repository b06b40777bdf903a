"""Cross-image window packing (``ops/packed_eval.py``) and the packed
Evaluator against the JAX package.

The packer: the port's ``WindowPacker`` and the JAX one on the seeded
mixed-size stream of ``tests/test_packed_eval.py`` (six images of 32 x 32
to 128 x 160, windows of 32 at stride 24, reduction 8), each with the same
per-window function written once in torch and once in jax, at the three
packing geometries of that file, with the ``max`` strategy, with images
added after a flush and with one image spanning several batches; the
output batches it holds over a 30-image stream; the geometry it refuses.

The Evaluator: CLIP-EBC ViT-B/16 at its width with two trunk blocks
(``VIT_CONFIGS["vit_b_16"]`` patched in both packages), deep VPT-32, 32 px
windows at stride 24, the port's seeded weights carried into the JAX
package by ``convert_reference_clip_ebc``, fp32. A stream of four images,
one smaller than a window and three padded to ``pad_to_multiple`` 16,
packed into batches of 16 windows (three batches, the last a flush):
``predict_densities_packed`` and ``evaluate_packed`` against the JAX
Evaluator's, and against the port's own per-image path; the predict and
NWPU CLIs with ``--packed_eval`` against their per-image runs.

Tolerances: the packer 1e-5 (the JAX file's); the model's densities
within 1e-4 of the largest magnitude and its counts and metrics 1e-4
relative (fp32, sums in another order); a CLI's packed counts within
1e-4 of its per-image counts.

Measured: 28.6 s in pytest serial (~37 s wall with the interpreter's
start), most of it the JAX side's compiles of the two-block model and
its text tower.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models.clip import image_encoder as jax_image_encoder
from clip_ebc_tpu.ops.packed_eval import WindowPacker as JaxWindowPacker
from clip_ebc_tpu.ops.packed_eval import packed_predict_densities as jax_packed
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu.training.evaluate import evaluate_packed as jax_evaluate_packed
from clip_ebc_tpu_torch.cli import predict, test_nwpu
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip import image_encoder as port_image_encoder
from clip_ebc_tpu_torch.ops.packed_eval import WindowPacker, packed_predict_densities
from clip_ebc_tpu_torch.ops.sliding_window import sliding_window_predict
from clip_ebc_tpu_torch.training.evaluate import Evaluator, evaluate, evaluate_packed
from tests.test_packed_eval import RED, STRIDE, WINDOW
from tests.test_packed_eval import _forward as jax_forward
from tests.test_packed_eval import _images

torch.set_num_threads(4)


def forward(windows: torch.Tensor) -> torch.Tensor:
    """``tests/test_packed_eval.py``'s per-window function in torch."""
    w = windows.float()
    b, wh, ww, c = w.shape
    blocks = w.reshape(b, wh // RED, RED, ww // RED, RED, c).mean((2, 4))
    return blocks[..., 0] + 0.3 * torch.tanh(blocks[..., 1] * blocks[..., 2])


def _stream(seed):
    """The JAX test's stream, as numpy (H, W, 3) float32 arrays."""
    return [np.array(im) for im in _images(seed)]


def _jax_packed(images, **kw):
    return [np.asarray(d) for d in jax_packed(jax_forward, None, [jnp.asarray(im) for im in images],
                                              WINDOW, STRIDE, RED, dtype=jnp.float32, **kw)]


def _port_packed(images, **kw):
    return [d.numpy() for d in packed_predict_densities(
        forward, [torch.from_numpy(im) for im in images], WINDOW, STRIDE, RED, **kw)]


def _per_image(images, strategy="average"):
    return [sliding_window_predict(forward, torch.from_numpy(im), WINDOW, STRIDE, RED,
                                   strategy).numpy() for im in images]


def _close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("batch_windows,chunk", [(16, 4), (8, 8), (32, 16)])
def test_packer_matches_jax(batch_windows, chunk):
    images = _stream(0)
    got = _port_packed(images, batch_windows=batch_windows, chunk=chunk)
    _close(got, _jax_packed(images, batch_windows=batch_windows, chunk=chunk))
    _close(got, _per_image(images))


def test_packer_max_strategy_matches_jax():
    images = _stream(3)
    kw = dict(strategy="max", batch_windows=16, chunk=4)
    got = _port_packed(images, **kw)
    _close(got, _jax_packed(images, **kw))
    _close(got, _per_image(images, "max"))


def _drain(packer):
    return [d for _, d in packer.ready()]


def test_packer_streams_and_adds_after_flush():
    """Densities come in submission order; a flush drains what was queued
    and the packer takes more images after it, as the JAX one does."""
    images = _stream(5)
    port = WindowPacker(forward, WINDOW, STRIDE, RED, batch_windows=16, chunk=4)
    ref = JaxWindowPacker(jax_forward, None, WINDOW, STRIDE, RED, batch_windows=16, chunk=4,
                          dtype=jnp.float32)
    got, want = [], []
    for part, total in ((images[:3], 3), (images[3:], len(images))):
        for im in part:
            port.add(torch.from_numpy(im))
            ref.add(jnp.asarray(im))
            got += _drain(port)
            want += _drain(ref)
            assert len(got) == len(want)  # the same images become ready at the same time
        port.flush()
        ref.flush()
        got += _drain(port)
        want += _drain(ref)
        assert len(got) == total
    _close([g.numpy() for g in got], [np.asarray(w) for w in want])
    assert port._stream_pos == ref._stream_pos and port._batch_idx == ref._batch_idx


def test_packer_one_image_spans_batches():
    img = np.random.default_rng(7).normal(size=(160, 256, 3)).astype(np.float32)
    got = _port_packed([img], batch_windows=8, chunk=4)
    assert len(got) == 1
    _close(got, _jax_packed([img], batch_windows=8, chunk=4))


def test_packer_prunes_outputs_no_image_needs():
    """Over a 30-image stream the packer holds at most two forward batches
    (the one running and the one an image straddles into), and none once
    every density is out; the staging buffer is 2 x batch_windows slots in
    the first image's dtype."""
    rng = np.random.default_rng(9)
    images = [rng.normal(size=(int(rng.integers(32, 97)), int(rng.integers(32, 97)), 3))
              .astype(np.float32) for _ in range(30)]
    packer = WindowPacker(forward, WINDOW, STRIDE, RED, batch_windows=16, chunk=4)
    got, held = [], []
    for im in images:
        packer.add(torch.from_numpy(im))
        held.append(len(packer._outputs))
        got += _drain(packer)
    packer.flush()
    got += _drain(packer)
    assert packer._batch_idx > 10 and max(held) <= 2 and not packer._outputs
    assert packer._buf.shape == (32, *WINDOW, 3) and packer._buf.dtype == torch.float32
    _close([g.numpy() for g in got], _per_image(images))


def test_packer_refuses_a_batch_that_is_not_whole_chunks():
    with pytest.raises(ValueError, match="multiple of chunk"):
        WindowPacker(forward, WINDOW, STRIDE, RED, batch_windows=20, chunk=16)


# ---- the Evaluator on a two-block CLIP-EBC ---------------------------------------

SIZE, STEP, BATCH, CHUNK = 32, 24, 16, 4
BINS, ANCHORS = get_bins_and_anchors(8, 4, "qnrf")
EVAL_KW = dict(reduction=8, sliding_window=True, window_size=SIZE, stride=STEP,
               pad_to_multiple=16)
SIZES = [(64, 96), (24, 16), (80, 56), (40, 120)]  # 12, 1, 9 and 10 windows


@pytest.fixture(scope="module")
def two_blocks():
    """Both packages build ViT-B/16 at its width with two trunk blocks."""
    cfg = (16, 768, 2, 12, 512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_image_encoder.VIT_CONFIGS, "vit_b_16", cfg)
        mp.setitem(port_image_encoder.VIT_CONFIGS, "vit_b_16", cfg)
        yield


@pytest.fixture(scope="module")
def models(two_blocks):
    port = get_model("clip_vit_b_16", SIZE, 8, BINS, ANCHORS, num_vpt=32, seed=0, device="cpu")
    params, stats = jax_convert.convert_reference_clip_ebc(port.state_dict())
    jmodel = jax_get_model("clip_vit_b_16", SIZE, 8, BINS, ANCHORS, dtype=jnp.float32,
                           num_vpt=32)
    return (Evaluator(port, **EVAL_KW), JaxEvaluator(jmodel, **EVAL_KW),
            {"params": params, "batch_stats": stats})


class _Labeled:
    """A labeled dataset of the stream: ``(images [1, H, W, 3], [points],
    densities)`` items, as ``CrowdDataset`` gives them."""

    def __init__(self, seed=1):
        rng = np.random.default_rng(seed)
        self.items = []
        for i, (h, w) in enumerate(SIZES):
            image = rng.normal(size=(1, h, w, 3)).astype(np.float32)
            points = rng.uniform(0, min(h, w), size=(3 * i + 1, 2)).astype(np.float32)
            self.items.append((image, [points], np.zeros((1, h, w), np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _assert_densities(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g.sum(), w.sum(), rtol=1e-4)


def test_evaluator_packed_matches_jax_and_per_image(models):
    port, jax_ev, variables = models
    images = [item[0][0] for item in _Labeled().items]
    got = [d.numpy() for d in port.predict_densities_packed(images, BATCH, CHUNK)]
    assert [g.shape for g in got] == [(h // 8, w // 8) for h, w in SIZES]
    _assert_densities(got, list(jax_ev.predict_densities_packed(variables, images, BATCH, CHUNK)))
    _assert_densities(got, [port.predict_density(im).numpy() for im in images])


def test_evaluate_packed_matches_jax_and_evaluate(models):
    port, jax_ev, variables = models
    ds = _Labeled(seed=2)
    got = evaluate_packed(port, ds, batch_windows=BATCH, chunk=CHUNK)
    want = jax_evaluate_packed(jax_ev, variables, ds, batch_windows=BATCH, chunk=CHUNK)
    per_image = evaluate(port, ds)
    for k in ("mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        np.testing.assert_allclose(got[k], per_image[k], rtol=1e-4)


def test_packed_evaluator_puts_batchnorm_in_eval_mode(models):
    """Packed windows must not depend on their batch-mates: a model left
    in train mode (the trainer's) is put back in eval mode."""
    port = models[0]
    images = [item[0][0] for item in _Labeled().items]
    want = [d.numpy() for d in port.predict_densities_packed(images, BATCH, CHUNK)]
    port.model.train()
    got = [d.numpy() for d in port.predict_densities_packed(images, BATCH, CHUNK)]
    assert not port.model.training
    _close(got, want, tol=0)


def test_count_metrics_match_jax():
    """``utils/metrics.py``, which both ``evaluate`` functions report
    through, against the JAX module: the one-shot errors, the streaming
    accumulator by image and by batch, and an empty accumulator."""
    from clip_ebc_tpu.utils import metrics as jax_metrics
    from clip_ebc_tpu_torch.utils import metrics

    rng = np.random.default_rng(6)
    pred, gt = rng.uniform(0, 300, 9), rng.integers(0, 300, 9).astype(np.float64)
    want = jax_metrics.count_errors(pred, gt)
    assert metrics.count_errors(pred, gt) == want
    ours, ref = metrics.CountErrorAccumulator(), jax_metrics.CountErrorAccumulator()
    for p, g in zip(pred[:4], gt[:4]):
        ours.update(p, g)
        ref.update(p, g)
    ours.update_batch(pred[4:], gt[4:])
    ref.update_batch(pred[4:], gt[4:])
    assert ours.result() == ref.result()
    np.testing.assert_allclose(list(ours.result().values()), list(want.values()), rtol=1e-12)
    assert all(np.isnan(v) for v in metrics.CountErrorAccumulator().result().values())
    with pytest.raises(ValueError, match="shapes differ"):
        metrics.count_errors(pred, gt[:3])


def test_packed_needs_sliding_windows(models):
    ev = Evaluator(models[0].model, reduction=8)
    with pytest.raises(ValueError, match="sliding_window"):
        next(ev.predict_densities_packed([np.zeros((32, 32, 3), np.float32)]))


def _write_images(root, seed=4):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, hw in enumerate(SIZES):
        np.save(root / f"{3000 + i}.npy", rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    return root


def _cli_counts(lines, sep):
    return [(r.split(sep)[0], float(r.split(sep)[1])) for r in lines]


def test_predict_cli_packed_matches_per_image(two_blocks, tmp_path):
    """``--packed_eval --batch_windows 16`` writes the counts and density
    files of the per-image run (the CSV keeps two decimals)."""
    img_dir = _write_images(tmp_path / "images")
    argv = [str(img_dir), "--device", "cpu", "--sliding_window", "--window_size", str(SIZE),
            "--input_size", str(SIZE), "--stride", str(STEP), "--seed", "3"]
    runs = {}
    for tag, extra in (("per_image", []), ("packed", ["--packed_eval", "--batch_windows", "16"])):
        out, dens = tmp_path / f"{tag}.csv", tmp_path / f"{tag}_dens"
        predict.main(argv + ["--out", str(out), "--save_density", str(dens), *extra])
        runs[tag] = (_cli_counts(out.read_text().splitlines()[1:], ","), dens)
    (got, got_dir), (want, want_dir) = runs["packed"], runs["per_image"]
    assert [n for n, _ in got] == [n for n, _ in want] == [f"{3000 + i}.npy" for i in range(4)]
    _assert_densities([np.load(got_dir / n) for n, _ in got],
                      [np.load(want_dir / n) for n, _ in want])
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=0.011)


def test_nwpu_cli_packed_matches_per_image(two_blocks, tmp_path):
    """``cli/test_nwpu.py --sliding_window --packed_eval`` writes the
    per-image run's submission lines, in the same format."""
    _write_images(tmp_path / "data" / "nwpu" / "test" / "images")
    weights = tmp_path / "ckpt" / "best" / "1.pt"
    weights.parent.mkdir(parents=True)
    bins, anchors = get_bins_and_anchors(8, 4, "nwpu")
    torch.save(get_model("clip_vit_b_16", SIZE, 8, bins, anchors, seed=5, device="cpu")
               .state_dict(), weights)
    argv = ["--data_root", str(tmp_path / "data"), "--weight_path", str(weights), "--device",
            "cpu", "--disable_size_check", "--sliding_window", "--input_size", str(SIZE),
            "--stride", str(STEP), "--pad_to_multiple", "16"]
    runs = {}
    for tag, extra in (("per_image", []), ("packed", ["--packed_eval", "--batch_windows", "16"])):
        test_nwpu.main(argv + ["--result_dir", str(tmp_path / tag), *extra])
        text = (tmp_path / tag / "best_1.txt").read_text()
        assert not text.endswith("\n")
        runs[tag] = _cli_counts(text.split("\n"), " ")
    got, want = runs["packed"], runs["per_image"]
    assert [n for n, _ in got] == [n for n, _ in want] == [str(3000 + i) for i in range(4)]
    assert all(np.isfinite(c) for _, c in got)
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-4)
