"""The port's NWPU test entry point against the JAX package's:
``resize_density_map``, ``NWPUTestDataset`` and ``cli/test_nwpu.py``.

The CLI comparison runs both CLIs on one synthetic ``nwpu/test/images``
tree of two small images, with one set of random weights (the port's
seeded init): the JAX CLI reads them as an Orbax snapshot, its
``--weight_path`` format, the port's CLI as a JAX prepared-tree ``.npz``.
Both write ``best_1.txt``; the names must match line for line and the
counts within 1e-4 relative (fp32; the two packages sum in another
order). ``resize_density_map``: 1e-5 of the largest value (bilinear
weights, fp32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_ebc_tpu.cli import test_nwpu as jax_cli
from clip_ebc_tpu.data.crowd import NWPUTestDataset as JaxNWPU
from clip_ebc_tpu.data.transforms import Resize2Multiple as JaxResize2Multiple
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.ops.sliding_window import resize_density_map as jax_resize_density_map
from clip_ebc_tpu_torch.cli import test_nwpu
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.data.crowd import NWPUTestDataset
from clip_ebc_tpu_torch.data.transforms import Resize2Multiple
from clip_ebc_tpu_torch.models import get_model
from clip_ebc_tpu_torch.ops.sliding_window import resize_density_map

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,size", [
    ((12, 20), (30, 44)),  # up
    ((40, 60), (13, 17)),  # down: jax.image.resize widens its filter (antialias)
    ((16, 24), (8, 48)),  # down one way, up the other
])
def test_resize_density_map_matches_jax(shape, size):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    want = np.asarray(jax_resize_density_map(jnp.asarray(x), size))
    got = resize_density_map(torch.from_numpy(x), size).numpy()
    assert got.shape == size
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_allclose(got.sum(), x.sum(), rtol=1e-5)  # the mass is kept


def test_resize_density_map_of_zeros_is_zeros():
    got = resize_density_map(torch.zeros(8, 8), (4, 4))
    assert torch.equal(got, torch.zeros(4, 4))


def _nwpu_tree(root, sizes, ext=".jpg", seed=0):
    img_dir = os.path.join(root, "nwpu", "test", "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for iid, hw in sizes.items():
        pixels = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        if ext == ".npy":
            np.save(os.path.join(img_dir, f"{iid}.npy"), pixels)
        else:
            Image.fromarray(pixels, "RGB").save(os.path.join(img_dir, f"{iid}.jpg"))
    return str(root)


@pytest.mark.parametrize("ext", [".jpg", ".npy"])
def test_nwpu_dataset_matches_jax(tmp_path, ext):
    """Discovery sorted by id (not by name), ``.npy`` preferred, the same
    normalized pixels, transforms and names; the 1500-image check."""
    root = _nwpu_tree(tmp_path, {3110: (40, 56), 3098: (48, 40), 3101: (33, 47)}, ext)
    port, ref = NWPUTestDataset(root, check_sizes=False), JaxNWPU(root, check_sizes=False)
    assert len(port) == len(ref) == 3
    for i in range(3):
        (img, name), (want, want_name) = port[i], ref[i]
        assert name == want_name
        np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)  # the normalization's last bit
    assert [port[i][1] for i in range(3)] == [f"{i}{ext}" for i in (3098, 3101, 3110)]
    resized = NWPUTestDataset(root, transforms=Resize2Multiple(32, 16), check_sizes=False)
    resized_ref = JaxNWPU(root, transforms=JaxResize2Multiple(32, 16), check_sizes=False)
    np.testing.assert_allclose(resized[2][0], resized_ref[2][0], atol=1e-5)
    with pytest.raises(ValueError, match="1500"):
        NWPUTestDataset(root)


def _jax_variables(port_model):
    params, stats = jax_convert.convert_reference_clip_ebc(port_model.state_dict())
    return {"params": params, "batch_stats": stats}


def test_nwpu_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same two images and weights, full-image mode (the
    default), CLIP-EBC ViT-B/16 at full width in fp32."""
    import orbax.checkpoint as ocp

    root = _nwpu_tree(tmp_path / "data", {3099: (64, 96), 3098: (64, 96)})
    bins, anchors = get_bins_and_anchors(8, 4, "nwpu")
    variables = _jax_variables(get_model("clip_vit_b_16", 224, 8, bins, anchors, seed=3,
                                         device="cpu"))
    jax_weights = str(tmp_path / "jax" / "best" / "1")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(jax_weights, variables)
    ckptr.wait_until_finished()
    port_weights = str(tmp_path / "port" / "best" / "1.npz")
    os.makedirs(os.path.dirname(port_weights))
    np.savez(port_weights, **jax_convert._flatten_tree(variables["params"], "params"),
             **jax_convert._flatten_tree(variables["batch_stats"], "stats"))

    common = ["--data_root", root, "--disable_size_check"]
    jax_cli.main(common + ["--weight_path", jax_weights, "--result_dir", str(tmp_path / "rj")])
    test_nwpu.main(common + ["--weight_path", port_weights, "--result_dir", str(tmp_path / "rp"),
                             "--device", "cpu"])

    def read(path):
        with open(path) as f:
            text = f.read()
        assert not text.endswith("\n")  # the submission format: no trailing newline
        return [line.split(" ") for line in text.split("\n")]

    want = read(tmp_path / "rj" / "best_1.txt")
    got = read(tmp_path / "rp" / "best_1.txt")
    assert [r[0] for r in got] == [r[0] for r in want] == ["3098", "3099"]
    for (_, count), (_, ref) in zip(got, want):
        assert np.isfinite(float(count))
        np.testing.assert_allclose(float(count), float(ref), rtol=1e-4)


@pytest.mark.parametrize("extra,error", [
    (["--quant", "int8", "--quant_attn", "xla"], SystemExit),  # int8 attention needs static scales
    (["--pretrained", "clip.pt"], FileNotFoundError),  # accepted; the file is missing
    (["--model", "clip_resnet50", "--quant", "int8"], SystemExit),  # W8A8 on a CLIP ResNet: no weights
    (["--packed_eval"], SystemExit),  # needs --sliding_window, as the JAX CLI says
    (["--quant_attn"], SystemExit),  # needs --quant int8_static
    ([], SystemExit),  # no weights: the JAX CLI's "one of --weight_path / --pretrained"
])
def test_nwpu_cli_rejects_what_it_cannot_do(tmp_path, extra, error):
    with pytest.raises(error):
        test_nwpu.main(["--data_root", str(tmp_path), "--device", "cpu", *extra])


@pytest.mark.parametrize("weights,name", [
    ("ckpt/best/12.pt", "best_12.txt"),
    ("ckpt/best/12", "best_12.txt"),
    ("runs/exp1/", "runs_exp1.txt"),
    ("w.npz", "w.txt"),
])
def test_nwpu_result_file_name(weights, name):
    assert test_nwpu.result_path("out", weights) == os.path.join("out", name)
    # --weight_path names the file over --pretrained; --pretrained alone keeps
    # its extension, as the JAX CLI names it
    assert test_nwpu.result_path("out", weights, "clip/ViT-B-16.pt") == os.path.join("out", name)
    assert test_nwpu.result_path("out", None, weights) == os.path.join(
        "out", f"{os.path.basename(os.path.dirname(os.path.normpath(weights)))}_"
        f"{os.path.basename(os.path.normpath(weights))}.txt".lstrip("_"))
