"""The port's non-CLIP models against the JAX package's, as
``test_torch_models.py`` holds its families (its module docstring states
the references, the tolerances and the depth cuts): cannet_bn at 56 px (a
7 x 7 grid, ragged for its context pools 2, 3 and 6), mobilenetv2 at 128
px, resnet50_ae at 64 px (the bottleneck encoder and decoder) and the
registered ConvNeXt at 29 px
(its stride-4 stem and stride-2 downsampling pad asymmetrically, SAME).
Each as a Classifier and as a Regressor, eval and train mode, fp32 and
bf16.
"""

import pytest

from test_torch_models import case_for, check_case

FAMILIES = [("cannet_bn", 56), ("mobilenetv2", 128), ("resnet50_ae", 64), ("convnext_nano", 29)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("head", ["cls", "reg"])
@pytest.mark.parametrize("name,size", FAMILIES)
def test_bn_family_matches_jax(name, size, head, mode, dtype):
    check_case(case_for(name, size, head), mode, dtype)
