"""The launches of the port's W8A8 MLP and dynamic int8 attention, one
plain version each, and the C entries' ctypes declarations.

* ``ln_mlp_int8_plain`` is its two launches: the LN + int8 fc + GELU +
  quantize (``ln_proj_int8_plain`` with the ``gelu_int8`` epilogue) and
  ``int8_gemm_residual_plain``; ``int8_attention_dynamic_plain`` is the scale
  pass ``qkv_quant_dynamic_plain`` and the body on its output
  (``int8_attention_dynamic_q_plain``). The pieces compose to the whole plain
  functions bit for bit (the whole functions are held to the JAX package in
  ``tests/test_torch_mlp_int8.py`` and ``tests/test_torch_quant_attn.py``).
* The scale pass's plain version at its edges against a numpy transcription
  of the JAX ``q8`` (``_pair_attention_body``: ``s = max(max|t|, 1e-8) /
  127``, ``clip(round(t / s))``, round half to even): a short last tile,
  k's scale shared by a head pair, an all-zero head, values at a rounding
  tie. Bit-equal: the same fp32 operations on both sides.
* Every entry of ``ops/fused_attention.py``'s ``_ARGTYPES`` (and the flash
  entries' one list) against its ``extern "C"`` declaration in
  ``csrc/*.cu``, read as text: the count of parameters and, for each, a
  pointer, an int, a long long or a float. A pointer declared as an int
  would be cut to 32 bits with no error.

All on CPU tensors, which take the plain versions.
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

from clip_ebc_tpu_torch.ops import flash_attention as fl
from clip_ebc_tpu_torch.ops import fused_attention as fa
from clip_ebc_tpu_torch.ops import quant as tq

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "clip_ebc_tpu_torch", "csrc")


# ---- the W8A8 MLP: launch 1, launch 2 -------------------------------------------------


def _mlp_args(dtype, b=2, l=37, d=128, hidden=512, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f(rng.normal(size=(b, l, d))).to(dtype)
    gam, be = f(1.0 + 0.1 * rng.normal(size=d)), f(0.1 * rng.normal(size=d))
    w_fc, b_fc = f(0.06 * rng.normal(size=(hidden, d))), f(0.02 * rng.normal(size=hidden))
    w_pj, b_pj = f(0.03 * rng.normal(size=(d, hidden))), f(0.02 * rng.normal(size=d))
    y = torch.nn.functional.layer_norm(x.float(), (d,), gam, be)
    h = y @ w_fc.T + b_fc
    act1, act2 = y.abs().amax() / 127.0, (h * torch.sigmoid(1.702 * h)).abs().amax() / 127.0
    return x, gam, be, (*tq.quantize_weight(w_fc), *tq.quantize_weight(w_pj)), b_fc, b_pj, act1, act2


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_mlp_int8_plain_is_its_two_launches(dtype, quick):
    x, gam, be, (wfc_q, s_fc, wpj_q, s_pj), b_fc, b_pj, act1, act2 = _mlp_args(dtype)
    whole = fa.ln_mlp_int8_plain(x, gam, be, wfc_q, s_fc, b_fc, act1, wpj_q, s_pj, b_pj, act2, quick)
    hq = fa.ln_proj_int8_plain(x, gam, be, wfc_q, s_fc * act1, b_fc, act1, "gelu_int8", act2, quick)
    assert hq.dtype == torch.int8 and hq.shape == x.shape[:-1] + (wfc_q.shape[0],)
    parts = fa.int8_gemm_residual_plain(hq, wpj_q, s_pj * act2, b_pj, x)
    assert parts.dtype == dtype and torch.equal(parts, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemm_residual_plain_matches_numpy(dtype):
    """x + (acc * sw2 + b) in fp32 with acc exact, one rounding to x's dtype;
    a CPU tensor takes the plain version through the wrapper (no launch)."""
    rng = np.random.default_rng(8)
    m, d, hidden = 45, 128, 384
    hq = rng.integers(-127, 128, size=(m, hidden)).astype(np.int8)
    w = rng.integers(-127, 128, size=(d, hidden)).astype(np.int8)
    sw2 = (rng.uniform(0.5, 1.5, size=d) * 1e-5).astype(np.float32)
    b = (0.02 * rng.normal(size=d)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
    acc = hq.astype(np.int64) @ w.T.astype(np.int64)
    assert np.abs(acc).max() < 2**31
    want = x.float().numpy() + (acc.astype(np.float32) * sw2 + b)
    before = fa.int8_gemm_residual.launches
    got = fa.int8_gemm_residual(torch.from_numpy(hq), torch.from_numpy(w), torch.from_numpy(sw2),
                                torch.from_numpy(b), x)
    assert fa.int8_gemm_residual.launches == before
    assert torch.equal(got, torch.from_numpy(want).to(dtype))


# ---- the dynamic int8 attention: the scale pass, the body -----------------------------


def _np_q8(qkv: np.ndarray, h: int, block_b: int) -> tuple:
    """The JAX ``q8`` per tile of block_b windows: q and v of each head, k of
    each head pair (the pair's 128 lanes quantized together)."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    q = np.zeros(qkv.shape, np.int8)
    scales = np.zeros((b, h, 3), np.float32)
    for t0 in range(0, b, block_b):
        tile = qkv[t0:t0 + block_b]
        for p in range(3):
            for hd in range(h):
                lo = p * d + (128 * (hd // 2) if p == 1 else 64 * hd)
                amax = np.abs(tile[..., lo:lo + (128 if p == 1 else 64)]).max()
                s = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
                scales[t0:t0 + block_b, hd, p] = s
                cols = slice(p * d + 64 * hd, p * d + 64 * hd + 64)
                q[t0:t0 + block_b, :, cols] = np.clip(np.rint(tile[..., cols] / s), -127, 127)
    return q, scales


def _edge_qkv(case: str) -> tuple:
    """(qkv (B, L, 3D) fp32 with D = 256, 4 heads, block_b) of one edge."""
    rng = np.random.default_rng(11)
    b, l, d = 3, 5, 256
    mag = np.repeat(rng.uniform(0.3, 3.0, size=12), 64).astype(np.float32)  # a magnitude a head
    qkv = (rng.normal(size=(b, l, 3 * d)) * mag).astype(np.float32)
    if case == "short last tile":  # B = 3 in tiles of 2: window 2 has its own scales
        qkv[2] *= 0.25
    elif case == "head pair":  # one head of each k pair 10x the other; q and v stay apart
        for pair in range(2):
            qkv[:, :, d + 128 * pair:d + 128 * pair + 64] *= 10.0
    elif case == "zero head":
        qkv[:, :, 64:128] = 0.0  # q of head 1
        qkv[:, :, d + 128:d + 256] = 0.0  # k of heads 2 and 3 (a whole pair)
    elif case == "rounding ties":  # s = 127 / 127 = 1: t / s lands on .5 exactly
        qkv[:] = rng.choice(np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32),
                            size=qkv.shape)
        qkv[:, 0, ::64] = 127.0  # every head's (and pair's) max-abs
    return qkv, 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["short last tile", "head pair", "zero head", "rounding ties"])
def test_scale_pass_plain_matches_jax_q8(case, dtype):
    qkv, block_b = _edge_qkv(case)
    t = torch.from_numpy(qkv).to(dtype)
    want_q, want_s = _np_q8(t.float().numpy(), 4, block_b)
    got_q, got_s = fa.qkv_quant_dynamic_plain(t, 4, block_b)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    before = fa.qkv_quant_dynamic.launches
    wq, ws = fa.qkv_quant_dynamic(t, 4, block_b)  # a CPU tensor: the plain version
    assert fa.qkv_quant_dynamic.launches == before
    assert torch.equal(wq, got_q) and torch.equal(ws, got_s)
    if case == "zero head":
        assert float(got_s[0, 1, 0]) == np.float32(1e-8) / np.float32(127.0)
        assert not got_q[..., 64:128].any() and not got_q[..., 256 + 128:512].any()
    if case == "head pair":  # k: one scale a pair (its larger head's); q and v: one a head
        assert torch.equal(got_s[:, 0::2, 1], got_s[:, 1::2, 1])
        k_even = t.float()[:2, :, 256:512].reshape(2, 5, 2, 2, 64)[:, :, :, 0].abs().amax((0, 1, 3))
        assert torch.equal(got_s[0, 0::2, 1], k_even / 127.0)
        assert not torch.equal(got_s[:, 0::2, 0], got_s[:, 1::2, 0])
    if case == "short last tile":
        assert torch.equal(got_s[0], got_s[1]) and not torch.equal(got_s[1], got_s[2])
    if case == "rounding ties":  # half to even: 2.5 -> 2, -0.5 -> 0, 3.5 -> 4
        vals = dict(zip(t.float().numpy().ravel().tolist(), got_q.numpy().ravel().tolist()))
        assert vals[2.5] == 2 and vals[-0.5] == 0 and vals[0.5] == 0 and vals[3.5] == 4 and vals[-1.5] == -2


@pytest.mark.parametrize("dtype,block_b", [(torch.float32, 1), (torch.bfloat16, 2)])
def test_dynamic_plain_is_scale_pass_then_body(dtype, block_b):
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(3, 37, 3 * 256)).astype(np.float32)).to(dtype)
    sm = 64**-0.5
    for kv_len in (37, 30):
        whole = fa.int8_attention_dynamic_plain(qkv, 4, kv_len, sm, block_b)
        qkv_q, scales = fa.qkv_quant_dynamic_plain(qkv, 4, block_b)
        parts = fa.int8_attention_dynamic_q_plain(qkv_q, scales, 4, kv_len, sm, dtype)
        assert parts.dtype == dtype and torch.equal(parts, whole)


# ---- ctypes declarations against the C entries ----------------------------------------

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "long long",
         ctypes.c_float: "float"}


def _c_entries() -> dict:
    """``{entry: [kind, ...]}`` of every ``extern "C"`` function in csrc/*.cu
    (a declaration inside a macro under its macro parameter's name)."""
    out = {}
    for path in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(path) as f:
            text = f.read().replace("\\\n", "\n")
        for m in re.finditer(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', text):
            kinds = []
            for p in m.group(2).split(","):
                p = " ".join(p.split())
                if "*" in p:
                    kinds.append("pointer")
                elif p.startswith(("long long", "const long long")):
                    kinds.append("long long")
                elif p.startswith(("float", "const float")):
                    kinds.append("float")
                elif p.startswith(("int", "const int")):
                    kinds.append("int")
                else:
                    kinds.append(p)
            out[m.group(1)] = kinds
    return out


@pytest.mark.parametrize("entry", sorted(fa._ARGTYPES))
def test_argtypes_match_the_c_declaration(entry):
    declared = _c_entries()
    assert entry in declared, f"{entry}: no extern \"C\" declaration in csrc/*.cu"
    assert [_KIND[t] for t in fa._ARGTYPES[entry]] == declared[entry]


def test_flash_argtypes_match_the_c_declaration():
    """The four flash entries come from one macro (``NAME``) and one list."""
    declared = _c_entries()
    with open(os.path.join(CSRC, "flash_attention.cu")) as f:
        text = f.read()
    for name in fl._ENTRIES.values():
        assert re.search(rf"\b{name}\b", text), name
    assert [_KIND[t] for t in fl._ARGTYPES] == declared["NAME"]
