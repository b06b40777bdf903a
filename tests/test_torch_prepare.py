"""The port's ``cli/prepare.py`` against the JAX package's, on one OpenAI-layout
CLIP ViT-B/16 file.

The file is the JAX test's constant-filled full-width state dict
(``tests/test_prepare.py``: real widths, so ``detect_clip_arch`` resolves
it; each tensor one distinct constant, so the JAX package's deflated
artifacts are written fast), cast to fp16 and saved as a TorchScript
archive, the way OpenAI ships CLIP (``chip_smoke.save_torchscript``: empty
``nn.Module``s nested along each key's path, every tensor a parameter at
its leaf, ``torch.jit.script`` then ``torch.jit.save``). Both packages'
``prepare_one`` convert it; the six files have the same names, each
``.npz`` the same arrays (compared as arrays, not zip bytes: the port
stores what the JAX package deflates) and ``meta/`` strings, each JSON
config the same content. The sha256 manifest check and the refusal of
``--download`` are covered without converting, and ``--pretrained`` of
the archive and of its prepared ``clip_vit_b_16.npz`` give bit-equal port
weights, each the file's values cast to fp32.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from chip_smoke import save_torchscript
from clip_ebc_tpu.cli import prepare as jax_prepare
from clip_ebc_tpu_torch.cli import prepare as P
from clip_ebc_tpu_torch.cli._common import load_weights
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.models.convert import load_torch_state_dict
from test_prepare import _mini_full_clip_sd

torch.set_num_threads(4)
STEMS = ("clip_vit_b_16", "clip_image_encoder_vit_b_16", "clip_text_encoder_vit_b_16")


# the files are removed after the module's tests: the stored artifacts
# alone take 1.2 GB of the disk every test shares


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    sd = {k: v.half() for k, v in _mini_full_clip_sd().items()}
    root = tmp_path_factory.mktemp("clip")
    path = str(root / "ViT-B-16.pt")
    save_torchscript(sd, path)
    yield sd, path
    shutil.rmtree(root)


@pytest.fixture(scope="module")
def prepared(archive, tmp_path_factory):
    _, path = archive
    root = tmp_path_factory.mktemp("prepared")
    out = {}
    for name, module in (("port", P), ("jax", jax_prepare)):
        out[name] = str(root / name)
        assert module.prepare_one(path, out[name]) == "vit_b_16"
    yield out
    shutil.rmtree(root)


def test_torchscript_fp16_archive_loads(archive):
    sd, path = archive
    got = load_torch_state_dict(path)
    assert set(got) == set(sd)
    assert all(got[k].dtype == torch.float16 and torch.equal(got[k], sd[k]) for k in sd)


def test_prepare_writes_the_jax_artifacts(prepared):
    port, jax_out = prepared["port"], prepared["jax"]
    for sub in ("weights", "configs"):
        assert sorted(os.listdir(os.path.join(port, sub))) == sorted(
            os.listdir(os.path.join(jax_out, sub)))
    assert sorted(os.listdir(os.path.join(port, "weights"))) == sorted(f"{s}.npz" for s in STEMS)
    for stem in STEMS:
        with np.load(os.path.join(port, "weights", f"{stem}.npz")) as a, \
                np.load(os.path.join(jax_out, "weights", f"{stem}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (stem, k)
            assert str(a["meta/split"]) in ("full", "image", "text")
        with open(os.path.join(port, "configs", f"{stem}.json")) as f, \
                open(os.path.join(jax_out, "configs", f"{stem}.json")) as g:
            assert json.load(f) == json.load(g)


def test_manifest_and_download_refusal(tmp_path, archive):
    _, path = archive
    assert len(P.MODEL_URLS) == 9 and P.MODEL_NAME_MAP == jax_prepare.MODEL_NAME_MAP
    assert all(P.expected_sha256(n) == jax_prepare.expected_sha256(n) for n in P.MODEL_URLS)
    blob = tmp_path / "blob.bin"
    blob.write_bytes(b"clip-ebc" * 1000)
    assert P.sha256_file(str(blob)) == jax_prepare.sha256_file(str(blob))
    with pytest.raises(ValueError, match="sha256 mismatch"):  # a made-up file is no release
        P.verify_checkpoint("ViT-B/16", path)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        P.main(["--src", path, "--models", "ViT-B/16", "--out", str(tmp_path / "o")])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.main(["--download", "--models", "RN50", "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="RN50"):  # asked for by name, not under --src
        P.main(["--src", os.path.dirname(path), "--models", "RN50", "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="unknown model"):
        P.main(["--src", path, "--models", "ViT-X/1", "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_pretrained_npz_equals_the_archive(archive, prepared):
    """The CLIs' ``--pretrained`` of the archive and of its prepared
    artifact leave the same weights: the file's fp16 values cast to fp32,
    and the decoder, projection and prompts as they were."""
    sd, path = archive
    bins, anchors = [(0.0, 0.0), (1.0, 1.0), (2.0, float("inf"))], [0.0, 1.0, 2.5]
    model = get_model("clip_vit_b_16", 224, 8, bins, anchors, num_vpt=2, device="cpu")
    fresh = {k: t.clone() for k, t in model.state_dict().items()
             if k.startswith(("vpt_", "image_decoder.", "projection."))}

    def load(src):
        load_weights(types.SimpleNamespace(pretrained=src, weight_path=None,
                                           allow_byte_tokenizer=True), model)
        return {k: t.clone() for k, t in model.state_dict().items()
                if k.startswith(("image_encoder.", "text_encoder.", "logit_scale"))}

    via_pt = load(path)
    model.load_state_dict({k: torch.zeros_like(t) for k, t in via_pt.items()}, strict=False)
    via_npz = load(os.path.join(prepared["port"], "weights", "clip_vit_b_16.npz"))
    assert via_pt.keys() == via_npz.keys()
    assert all(torch.equal(via_pt[k], via_npz[k]) for k in via_pt)
    assert torch.equal(via_npz["image_encoder.transformer.resblocks.11.mlp.c_fc.weight"],
                       sd["visual.transformer.resblocks.11.mlp.c_fc.weight"].float())
    assert torch.equal(via_npz["logit_scale"], sd["logit_scale"].float())
    state = model.state_dict()
    assert all(torch.equal(state[k], t) for k, t in fresh.items())
