"""The port's non-CLIP models against the JAX package's: every backbone
family as a ``Classifier`` and as a ``Regressor``, in eval and train mode,
fp32 and bf16, from the same weights (the JAX variable tree filled with
seeded numpy values, carried into the port by
``models.convert.head_state_from_jax``) and the same seeded images.

Each output (eval density; train-mode logits and density; the BatchNorm
running statistics after one train-mode forward) is held to the JAX
model's fp32 output by relative L2 error:

    fp32: err(port) <= 2e-4
    bf16: err(port) <= 2e-2 + 2 x err(JAX package in bf16), the second
          term at most 0.1 (a case whose JAX bf16 run is further than
          that from its fp32 run fails)

2e-4 and 2e-2 are the north star's tolerances; the second bf16 term is
the JAX package's own rounding error on the same input.

Train-mode BatchNorm at random weights amplifies rounding exponentially
with depth: with zero-mean shifts, about half of every BatchNorm's
outputs go through the ReLU, and the JAX package's own bf16 train-mode
output lay 0.3-0.9 from its fp32 output on resnet50_ae and mobilenetv2
at 32-128 px, a bound no broken layer could miss. So the train-mode
checks take every BatchNorm shift from U(0.5, 1.5), which keeps most
activations on the ReLU's linear side, and the eval-mode checks keep
zero-mean shifts (in eval mode positive shifts add up along a residual
stack instead). The BatchNorm families run at sizes where their deepest
map keeps at least 4 x 4 positions per image. Repeated layers are cut
where a family has many (``DEPTH_CUTS``), in both packages, keeping
every kind of layer. Each reference is first checked to vary across
positions, so no case passes on a constant output; the Regressor's
output conv takes the absolute value of its seeded kernel and a bias of
+0.5, so its ReLU passes most positions.

Also here: the downscaling resize (antialiased, as ``jax.image.resize``)
at 1/2 and 1/4 and its upscaling, CANNet's ragged pool at the 448 px
grid, flax's SAME padding on odd sizes, the backbone table against the
JAX factory's, the registry, and the initializers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from clip_ebc_tpu.models import densenet as jax_densenet
from clip_ebc_tpu.models import get_backbone as jax_get_backbone
from clip_ebc_tpu.models import get_model as jax_get_model
from clip_ebc_tpu.models import resnet as jax_resnet
from clip_ebc_tpu.models import vit as jax_vit
from clip_ebc_tpu.models.csrnet import _adaptive_avg_pool as jax_adaptive_pool
from clip_ebc_tpu_torch.config import get_bins_and_anchors
from clip_ebc_tpu_torch.models import (Classifier, Regressor, densenet, get_backbone, get_model,
                                       register_backbone, resnet, vit)
from clip_ebc_tpu_torch.models.blocks import SameConv2d, resize_bilinear
from clip_ebc_tpu_torch.models.convert import head_state_from_jax
from clip_ebc_tpu_torch.models.csrnet import adaptive_avg_pool

torch.set_num_threads(4)
RED, BATCH = 8, 2
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
OWN_CAP = 0.1  # the most the JAX package's own bf16 error may add to a bound
BINS, ANCHORS = get_bins_and_anchors(RED, 4, "qnrf")

# (family, input size); the other families are in test_torch_models_bn.py
# and test_torch_models_large.py, so the three files run side by side.
FAMILIES = [("vgg19_ae", 32), ("vgg16_bn", 64), ("resnet18", 128), ("csrnet", 32)]

# (tables of the two packages, key, entry): the repeated layers cut to two
# of each kind (a ResNet stage's first block and an identity block, two
# dense layers per block, two ViT blocks)
_DENSE, _VIT = densenet._CONFIGS["densenet121"], vit._VIT_CONFIGS
DEPTH_CUTS = {
    "resnet50_ae": ((resnet._LAYERS, jax_resnet._LAYERS), "resnet50", ((2, 2, 2, 2), "bottleneck")),
    "densenet121": ((densenet._CONFIGS, jax_densenet._CONFIGS), "densenet121",
                    (_DENSE[0], (2, 2, 2, 2), _DENSE[2])),
    **{name: ((vit._VIT_CONFIGS, jax_vit._VIT_CONFIGS), name, (_VIT[name][0], 2, *_VIT[name][2:]))
       for name in ("vit_b_16", "vit_b_32")},
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _seeded_variables(model, x, seed: int = 0) -> dict:
    """The JAX model's variable tree with seeded numpy leaves: kernels
    N(0, 1 / fan in), biases N(0, 0.1^2), norm and layer scales U(0.5, 1.5),
    BatchNorm means N(0, 0.1^2) and variances U(0.5, 1.5), positional
    embeddings and tokens N(0, 0.02^2)."""
    shapes = jax.eval_shape(lambda k: model.init(k, x, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = getattr(path[-1], "key", "")
        if name in ("scale", "gamma", "var"):
            leaves.append(rng.uniform(0.5, 1.5, s.shape).astype(np.float32))
            continue
        if name == "kernel":
            std = float(np.prod(s.shape[:-1])) ** -0.5
        else:  # positional embeddings and tokens; biases, BatchNorm means
            std = 0.02 if name in ("pos_embedding", "class_token") else 0.1
        leaves.append(rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _train_variables(variables: dict, seed: int = 2) -> dict:
    """``variables`` with every BatchNorm shift (a ``bias`` beside running
    statistics) drawn from U(0.5, 1.5)."""
    norms = {tuple(k.key for k in path[:-1])
             for path, _ in jax.tree_util.tree_flatten_with_path(variables.get("batch_stats", {}))[0]}
    rng = np.random.default_rng(seed)

    def shift(path, leaf):
        keys = tuple(k.key for k in path)
        if keys[-1] == "bias" and keys[1:-1] in norms:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(shift, variables)


def _jax_outputs(model, v_eval, v_train, x) -> dict:
    """Eval density (``v_eval``), train (logits, density) and the updated
    statistics (``v_train``) of the JAX model."""

    def run(v_eval, v_train, x):
        ev = model.apply(v_eval, x, train=False)
        (logits, dens), mut = model.apply(v_train, x, train=True, mutable=["batch_stats"])
        return ev, logits, dens, mut.get("batch_stats", {})

    ev, logits, dens, stats = jax.jit(run)(v_eval, v_train, x)
    out = {"eval": np.asarray(ev, np.float64), "density": np.asarray(dens, np.float64),
           "stats": jax.tree_util.tree_map(lambda t: np.asarray(t, np.float32), stats)}
    if logits is not None:
        out["logits"] = np.asarray(logits.astype(jnp.float32), np.float64)
    return out


def _port_outputs(name, size, head, dtype, v_eval, v_train, x) -> dict:
    # built without the random init get_model runs: the weights are loaded over it
    backbone = get_backbone(name, size, RED, dtype)
    model = (Classifier(backbone, BINS, ANCHORS, dtype) if head == "cls"
             else Regressor(backbone, dtype)).eval()
    xt = torch.from_numpy(np.asarray(x))
    out = {"model": model}
    for v, mode in ((v_eval, "eval"), (v_train, "train")):
        model.load_state_dict(
            head_state_from_jax(model, v["params"], v.get("batch_stats", {})), strict=True)
        with torch.no_grad():
            if mode == "eval":
                out["eval"] = model.eval()(xt).double().numpy()
                continue
            logits, dens = model.train()(xt)
        out["density"], out["state"] = dens.double().numpy(), model.state_dict()
        if logits is not None:
            out["logits"] = logits.double().numpy()
    return out


def run_case(name: str, size: int, head: str) -> dict:
    """The outputs of one (family, head) through both packages, fp32 and
    bf16; the reference is the JAX package's fp32 run."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, size, size, 3)).astype(np.float32)
    bins, anchors = (BINS, ANCHORS) if head == "cls" else (None, None)
    variables = _seeded_variables(jax_get_model(name, size, RED, bins, anchors), jnp.asarray(x))
    if head == "reg":  # a positive output conv, so the ReLU passes most blocks
        head_conv = variables["params"]["Conv_0"]
        head_conv["kernel"], head_conv["bias"][:] = np.abs(head_conv["kernel"]), 0.5
    v_train = _train_variables(variables)
    out = {"v_train": v_train}
    for dt in ("float32", "bfloat16"):
        model = jax_get_model(name, size, RED, bins, anchors, dtype=getattr(jnp, dt))
        out[f"jax_{dt}"] = _jax_outputs(model, variables, v_train, x)
        out[f"port_{dt}"] = _port_outputs(name, size, head, getattr(torch, dt), variables,
                                          v_train, x)
    return out


def check_case(case: dict, mode: str, dtype: str) -> None:
    """Holds one mode ("eval" or "train") of one dtype as the module
    docstring says."""
    exact, jax_out, port = case["jax_float32"], case[f"jax_{dtype}"], case[f"port_{dtype}"]
    keys = ["eval"] if mode == "eval" else [k for k in ("logits", "density") if k in exact]
    for k in keys:
        ref = exact[k]
        assert np.std(ref) > 1e-3 * np.abs(ref).mean() and np.count_nonzero(ref) > ref.size // 10, \
            f"{k}: degenerate reference"
        _hold(rel(port[k], ref), rel(jax_out[k], ref), dtype, (*case["key"], k))
    if mode == "train" and exact["stats"]:
        want, own_sd = _stats_state(case, exact["stats"]), _stats_state(case, jax_out["stats"])
        assert want
        for k in want:
            _hold(rel(port["state"][k], want[k]), rel(own_sd[k], want[k]), dtype, (*case["key"], k))


def _hold(got: float, own: float, dtype: str, what: tuple) -> None:
    print(f"{' '.join(map(str, what))} {dtype}: rel L2 {got:.2e}, JAX's own {own:.2e}, "
          f"{got / (TOL[dtype] + 2 * own):.0%} of the bound")
    assert own <= OWN_CAP, f"{what}: the JAX package's own {dtype} error {own:.3g} is no reference"
    assert got <= TOL[dtype] + 2 * own, (what, got, own)


def _stats_state(case: dict, stats) -> dict:
    """Updated JAX batch statistics under the port's running-stat names
    (the bridge reads them by the names of the port's model)."""
    sd = head_state_from_jax(case["port_float32"]["model"], case["v_train"]["params"], stats)
    return {k: v for k, v in sd.items() if "running_" in k}


_CASES: dict = {}


def case_for(name: str, size: int, head: str) -> dict:
    key = (name, size, head)
    if key not in _CASES:
        _CASES.clear()  # one (family, head) at a time: the tests below run in its order
        with pytest.MonkeyPatch.context() as mp:
            if name in DEPTH_CUTS:
                tables, entry, value = DEPTH_CUTS[name]
                for table in tables:
                    mp.setitem(table, entry, value)
            _CASES[key] = dict(run_case(name, size, head), key=key)
    return _CASES[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("head", ["cls", "reg"])
@pytest.mark.parametrize("name,size", FAMILIES)
def test_family_matches_jax(name, size, head, mode, dtype):
    check_case(case_for(name, size, head), mode, dtype)


@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_bilinear_matches_jax(scale, dtype):
    """Down by 2 and 4 (antialiased in both packages), up by 2, on odd and
    even sides; fp32 1e-6, bf16 one rounding (8e-3) of the largest value."""
    from clip_ebc_tpu.models.blocks import resize_bilinear as jax_resize

    x = np.random.default_rng(2).normal(size=(2, 28, 37, 5)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x, getattr(jnp, dtype)), scale), np.float32)
    got = resize_bilinear(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2), scale)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    tol = 1e-6 if dtype == "float32" else 8e-3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("grid", [(56, 56), (8, 8), (7, 12)])
def test_cannet_pool_matches_jax(grid):
    """CANNet's pool at sizes 1, 2, 3, 6: equal blocks where the size
    divides the grid, the antialiased resize where it does not (at the 448
    px input the 56 x 56 grid takes the resize for 3 and 6); fp32 1e-6."""
    x = np.random.default_rng(3).normal(size=(2, *grid, 4)).astype(np.float32)
    for size in (1, 2, 3, 6):
        want = np.asarray(jax_adaptive_pool(jnp.asarray(x), size))
        got = adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), size)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kernel,stride", [(4, 4), (2, 2), (3, 2)])
@pytest.mark.parametrize("hw", [(29, 30), (32, 32), (7, 9)])
def test_same_conv_matches_flax(kernel, stride, hw):
    """flax ``padding="SAME"`` (asymmetric where the total padding is odd)
    against ``SameConv2d`` on the same kernel; fp32 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    conv = flax_nn.Conv(5, (kernel, kernel), strides=stride)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    m = SameConv2d(3, 5, kernel, stride=stride)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.tensor(np.asarray(v["params"]["bias"])))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _jax_names():
    from clip_ebc_tpu.models import _BACKBONE_REGISTRY, _DENSENET_CONFIGS, _VIT_CONFIGS
    from clip_ebc_tpu.models import _RESNET_AE_NAMES, _RESNET_NAMES, _VGG_NAMES

    return (list(_VGG_NAMES) + list(_RESNET_AE_NAMES) + list(_RESNET_NAMES)
            + ["mobilenetv2", "mobilenet_v2", "csrnet", "csrnet_bn", "cannet", "cannet_bn"]
            + list(_DENSENET_CONFIGS) + list(_VIT_CONFIGS) + sorted(_BACKBONE_REGISTRY))


@pytest.mark.parametrize("reduction", [8, 16, 32])
def test_every_jax_backbone_is_built(reduction):
    """Every backbone name of the JAX factory builds in the port (on the
    meta device) with the JAX module's ``channels`` and
    ``encoder_reduction``."""
    names = _jax_names()
    assert len(names) == 16 + 10 + 6 + 4 + 5 + 1
    for name in names:
        want = jax_get_backbone(name, 224, reduction)
        with torch.device("meta"):  # the module's structure, no storage
            got = get_backbone(name, 224, reduction)
        assert (got.channels, got.encoder_reduction) == (want.channels, want.encoder_reduction), name


def test_registered_backbone_is_built_by_name():
    """A user's factory through ``register_backbone`` (the JAX contract:
    ``factory(input_size, reduction, dtype, axis_name)``) is built, headed
    and trained like a shipped backbone."""
    from torch import nn

    from clip_ebc_tpu_torch.models.blocks import Conv2d

    class Tiny(nn.Module):
        channels, encoder_reduction = 4, 8

        def __init__(self, reduction):
            super().__init__()
            self.reduction = reduction
            self.conv = Conv2d(3, 4, 8, stride=8)

        def forward(self, x):
            return self.conv(x)

    seen = {}

    @register_backbone("Tiny_Test_Backbone")
    def make(input_size, reduction, dtype, axis_name):
        seen.update(input_size=input_size, reduction=reduction, axis_name=axis_name)
        return Tiny(reduction)

    model = get_model("tiny_test_backbone", 64, 8, BINS, ANCHORS, device="cpu")
    assert seen == {"input_size": 64, "reduction": 8, "axis_name": None}
    out = model(torch.zeros(1, 64, 64, 3))
    assert out.shape == (1, 8, 8)


def test_axis_name_and_quant_are_refused():
    """``axis_name`` is refused no more (data parallelism is ported): every
    backbone of the JAX factory builds with it, and each of its BatchNorms
    (none in the plain ViTs and ConvNeXt) takes it, so its training
    statistics are synced over the ranks; ``quant_int8`` stays CLIP-only."""
    from clip_ebc_tpu_torch.models.blocks import BatchNorm

    with_bn = 0
    for name in _jax_names():
        with torch.device("meta"):
            bb = get_backbone(name, 224, 8, axis_name="data")
        norms = [m for m in bb.modules() if isinstance(m, BatchNorm)]
        assert all(m.axis_name == "data" for m in norms), name
        with_bn += bool(norms)
    assert with_bn == 8 + 10 + 2 + 2 + 4  # the _bn VGGs, ResNets, MobileNetV2, *_bn, DenseNets
    with pytest.raises(ValueError, match="clip_"):
        get_model("vgg19_ae", 32, 8, BINS, ANCHORS, quant_int8=True, device="cpu")


def test_initializers_follow_jax():
    """Seeded init: the VGG and head convs kaiming normal (fan out), the
    ResNet encoder's lecun normal truncated at two of its standard
    deviations, biases zero, BatchNorm at identity; the same seed gives the
    same weights. Std within 5% (over >= 36k values)."""
    vgg = get_model("vgg19_ae", 32, 8, BINS, ANCHORS, device="cpu", seed=3)
    w = vgg.backbone.features[2].weight.detach()  # 64 -> 64
    assert abs(float(w.std()) / (2.0 / (64 * 9)) ** 0.5 - 1) < 0.05
    assert float(vgg.backbone.features[2].bias.abs().max()) == 0.0
    again = get_model("vgg19_ae", 32, 8, BINS, ANCHORS, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(vgg.state_dict().values(), again.state_dict().values()))
    res = get_model("resnet18", 64, 8, None, None, device="cpu")
    w = res.backbone.encoder.layer1[0].conv1.weight.detach()  # 64 -> 64, 3x3: fan in 576
    std = (1 / 576) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    bn = res.backbone.encoder.bn1
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))
