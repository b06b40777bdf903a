"""Weight bridge between the JAX package and its PyTorch port, and the
port's package rules (no JAX import, no quiet CPU fallback).

The JAX tree is the exact structure of ``build_clip_ebc("vit_b_16")``'s
init (from ``jax.eval_shape``) filled with seeded numpy values, so every
leaf is distinct and non-trivial. Round trips must be bit-equal: the
bridge only transposes and renames.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ebc_tpu.config import get_bins_and_anchors as jax_bins
from clip_ebc_tpu.models import convert as jax_convert
from clip_ebc_tpu.models.clip.model import build_clip_ebc as jax_build
from clip_ebc_tpu_torch.models.clip.model import build_clip_ebc
from clip_ebc_tpu_torch.models.convert import from_jax_params, load_weights

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tree():
    bins, anchors = jax_bins(8, 4, "qnrf")
    model = jax_build("vit_b_16", bins, anchors, reduction=8, input_size=32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0),
    )
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )
    # BN variances must be positive for a meaningful forward, not for the bridge
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def port_model():
    bins, anchors = jax_bins(8, 4, "qnrf")
    return build_clip_ebc("vit_b_16", bins, anchors, reduction=8, device="cpu")


def _assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{path}: {sorted(set(a) ^ set(b))}"
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_jax_tree_round_trip_is_bit_equal(jax_tree, port_model):
    sd = from_jax_params(jax_tree["params"], jax_tree["batch_stats"])
    port_model.load_state_dict(sd, strict=True)
    params, stats = jax_convert.convert_reference_clip_ebc(port_model.state_dict())
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, dict(jax_tree["params"])), params)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, dict(jax_tree["batch_stats"])), stats)


def test_prepared_tree_npz_loads_into_port(jax_tree, port_model, tmp_path):
    # one constant per leaf: save_prepared_tree compresses, and random
    # values of the full model would take most of a minute to deflate
    leaves = iter(range(1, 10**6))
    tree = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, next(leaves), np.float32), jax_tree
    )
    path = str(tmp_path / "w.npz")
    jax_convert.save_prepared_tree(path, tree["params"], tree["batch_stats"],
                                   {"backbone": "vit_b_16"})
    load_weights(port_model, path)
    want = from_jax_params(tree["params"], tree["batch_stats"])
    got = port_model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_port_pt_state_dict_loads(port_model, tmp_path):
    bins, anchors = jax_bins(8, 4, "qnrf")
    other = build_clip_ebc("vit_b_16", bins, anchors, reduction=8, seed=1, device="cpu")
    path = str(tmp_path / "w.pt")
    torch.save(other.state_dict(), path)
    load_weights(port_model, path)
    for k, v in other.state_dict().items():
        assert torch.equal(port_model.state_dict()[k], v), k


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clip_ebc_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'clip_ebc_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('clip_ebc_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "for name in ('ops.quant', 'cli._common', 'ops.fused_attention', 'models.convert',\n"
        "             'parallel.mesh', 'ops.packed_eval', 'utils.metrics'):\n"
        "    assert 'clip_ebc_tpu_torch.' + name in sys.modules, name\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 22  # every module was imported, the int8 slice's too
    # and no source of the port, nor the chip script, names the JAX package in an import
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "clip_ebc_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert any(p.endswith(os.path.join("ops", "quant.py")) for p in sources)
    assert any(p.endswith(os.path.join("cli", "_common.py")) for p in sources)
    for path in sources:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words and words[0] in ("import", "from"):
                    assert words[1].split(".")[0] not in ("jax", "flax", "clip_ebc_tpu"), (path, line)


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    from clip_ebc_tpu_torch.cli import predict, test_nwpu
    from clip_ebc_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    bins, anchors = jax_bins(8, 4, "qnrf")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_clip_ebc("vit_b_16", bins, anchors, reduction=8)
    np.save(tmp_path / "img.npy", np.zeros((32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main([str(tmp_path), "--out", str(tmp_path / "c.csv")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_nwpu.main(["--data_root", str(tmp_path), "--weight_path", str(tmp_path / "w.pt"),
                        "--disable_size_check", "--result_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()  # nothing was written
    assert resolve_device("cpu") == torch.device("cpu")
