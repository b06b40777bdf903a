"""The CLIP ResNets through the port's entry points, and what the CLIs
refuse until the next slice.

``clip_resnet50`` trains end to end through the trainer CLI for one
epoch on a tiny synthetic ``sha`` (the reference's ``run.sh`` flags at a
32 px crop: reduction 8, truncation 4, ``word`` prompts, SHA bins): every
parameter but the text tower's moves, and the BatchNorm statistics of the
trunk and the decoder go into the checkpoint. Its best checkpoint then
serves through the predict CLI, whole and by windows, and each whole
image's count is held to the JAX Evaluator's on the same weights (read
back by the JAX package's ``convert_reference_clip_ebc``): fp32, 1e-4
relative.

Training a ViT-L backbone and ``--quant`` on a ViT-L or a CLIP ResNet,
refused by name until this slice, now get past the CLIs' checks.
"""

import shutil

import numpy as np
import pytest
import torch

from clip_ebc_tpu.data.crowd import _load_image as jax_load_image
from clip_ebc_tpu.data.crowd import normalize_image as jax_normalize
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.training.evaluate import Evaluator as JaxEvaluator
from clip_ebc_tpu_torch.cli import predict, test_nwpu, trainer as trainer_cli
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.data.synthetic import make_synthetic_crowd_dataset
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.clip.model import ClipEBC
from clip_ebc_tpu_torch.ops.quant import Int8Conv2d, Int8Linear

torch.set_num_threads(4)
SIZE, RED = 32, 8


def test_clip_resnet50_trains_and_serves_through_the_clis(tmp_path):
    data = make_synthetic_crowd_dataset(str(tmp_path / "data"), "sha", n_train=4, n_val=2,
                                        size=(64, 96), max_count=40, seed=0)
    ckpt = tmp_path / "ckpt"
    trainer_cli.main([
        "--model", "clip_resnet50", "--dataset", "sha", "--input_size", str(SIZE),
        "--reduction", str(RED), "--truncation", "4", "--prompt_type", "word",
        "--count_loss", "dmcount", "--batch_size", "2", "--warmup_lr", "1e-3",
        "--total_epochs", "1", "--eval_start", "1", "--data_root", data, "--ckpt_dir", str(ckpt),
        "--eval_disable_size_check", "--device", "cpu", "--num_workers", "2",
    ])
    latest = torch.load(ckpt / "latest.pt", map_location="cpu", weights_only=True)
    assert latest["step"] == 2
    bins, anchors = get_bins_and_anchors(RED, 4, "sha")
    init = get_model("clip_resnet50", SIZE, RED, bins, anchors, seed=42, device="cpu").state_dict()
    trained = latest["model"]
    moved = {k for k in init if not torch.equal(init[k], trained[k])}
    for k in init:
        if k.startswith("text_encoder."):
            assert k not in moved, k  # the frozen tower
        elif k.endswith(("running_mean", "running_var")) or k.endswith(".weight"):
            assert k in moved, k  # statistics and every weight train
    assert any(k.startswith("image_encoder.layer4") and k.endswith("running_var") for k in moved)

    best = ckpt / "best" / "1.pt"
    val = sorted((tmp_path / "data" / "sha" / "val" / "images").iterdir())
    counts = {}
    for extra in ([], ["--sliding_window", "--window_size", "32", "--stride", "32"]):
        out = tmp_path / f"counts{len(extra)}.csv"
        predict.main([str(val[0].parent), "--model", "clip_resnet50", "--bins_dataset", "sha",
                      "--input_size", str(SIZE), "--device", "cpu", "--weight_path", str(best),
                      "--out", str(out), *extra])
        rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
        assert [r[0] for r in rows] == [p.name for p in val]
        counts[len(extra)] = [float(r[1]) for r in rows]
        assert np.all(np.isfinite(counts[len(extra)]))

    model = jax_get_model("clip_resnet50", SIZE, RED, bins, anchors)
    params, stats = jax_convert.convert_reference_clip_ebc(
        torch.load(best, map_location="cpu", weights_only=True))
    ev = JaxEvaluator(model, reduction=RED, pad_to_multiple=RED)
    want = [ev.predict_count({"params": params, "batch_stats": stats},
                             jax_normalize(jax_load_image(str(p)))) for p in val]
    np.testing.assert_allclose(counts[0], want, rtol=1e-4, atol=1e-3)
    shutil.rmtree(ckpt)  # ~2 GB of weights and Adam moments


@pytest.mark.parametrize("model", ["clip_vit_l_14", "clip_vit_l_14_336px"])
def test_trainer_cli_refuses_vit_l_training(tmp_path, model):
    """The trainer CLI refuses a ViT-L backbone no more (its D = 1024
    frozen backward is ported), with the loader's process pool
    (``--loader_procs``) and ``--pretrained`` too: a missing checkpoint
    fails before the model is built, as for every model."""
    argv = ["--model", model, "--dataset", "sha", "--truncation", "4", "--loader_procs", "2",
            "--data_root", str(tmp_path), "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"]
    trainer_cli.config_from_args(trainer_cli.build_parser().parse_args(argv))
    with pytest.raises(FileNotFoundError, match="clip.pt"):
        trainer_cli.main([*argv, "--pretrained", "clip.pt"])


@pytest.mark.parametrize("model", ["clip_vit_l_14", "clip_vit_l_14_336px", "clip_resnet50",
                                   "clip_resnet101", "clip_resnet50x4"])
@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_quant_is_refused_for_vit_l_and_clip_resnets(tmp_path, model, quant):
    """W8A8 on ViT-L and the CLIP ResNets is refused no more: both serving
    CLIs get past their checks to the first thing they lack here (images,
    weights), and the factory builds the model (on the meta device: no
    weights) with every decoder convolution in int8; a ViT trunk's
    projections too, a ResNet trunk float, as in the JAX package."""
    with pytest.raises(SystemExit, match="no images found"):
        predict.main([str(tmp_path), "--model", model, "--quant", quant, "--device", "cpu"])
    with pytest.raises(SystemExit, match="--weight_path"):
        test_nwpu.main(["--data_root", str(tmp_path), "--model", model, "--quant", quant,
                        "--device", "cpu"])
    bins, anchors = get_bins_and_anchors(RED, 4, "sha")
    with torch.device("meta"):
        m = ClipEBC(model[len("clip_"):], bins, anchors, reduction=RED, quant_int8=True,
                    quant_mode="static" if quant == "int8_static" else "dynamic")
    convs = [n for n, mod in m.named_modules() if isinstance(mod, torch.nn.Conv2d)
             and n.startswith("image_decoder.")]
    assert convs and all(isinstance(m.get_submodule(n), Int8Conv2d) for n in convs)
    trunk_int8 = [n for n, mod in m.image_encoder.named_modules()
                  if isinstance(mod, (Int8Conv2d, Int8Linear))]
    assert bool(trunk_int8) == model.startswith("clip_vit"), trunk_int8[:3]
