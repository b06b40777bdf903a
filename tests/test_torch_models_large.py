"""The port's larger non-CLIP models against the JAX package's, as
``test_torch_models.py`` holds the others (its module docstring states the
references, the tolerances and the depth cuts): densenet121 at 128 px,
and the plain ViTs ``vit_b_16`` (32 px: 5 tokens) and ``vit_b_32`` (64
px) at full width, whose blocks take LayerNorm eps 1e-6 and the tanh
GELU, and whose patchify has a bias. Each as a Classifier and as a
Regressor, eval and train mode, fp32 and bf16.
"""

import pytest

from test_torch_models import case_for, check_case

LARGE = [("densenet121", 128), ("vit_b_16", 32), ("vit_b_32", 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("head", ["cls", "reg"])
@pytest.mark.parametrize("name,size", LARGE)
def test_large_family_matches_jax(name, size, head, mode, dtype):
    check_case(case_for(name, size, head), mode, dtype)
