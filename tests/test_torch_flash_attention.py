"""The port's flash-attention plain version against the JAX package's Pallas
kernel (interpret mode) in float32 and bfloat16, with GQA and sliding
windows; and the wrapper's CPU route. The Hopper kernel itself is tested in
test_torch_cuda.py."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.ops.kernels.flash_attention import flash_attention as jax_fa
from onnx_quantize_tpu_torch.ops.kernels import flash_attention

torch.set_num_threads(1)

# Float32: both sides form the same float32 scores and online/global softmax
# of them; they differ in summation order and exp only (1e-5 of max|out|).
# Bfloat16: both round p to bf16 before the PV product, but the JAX kernel
# rounds exp(s - running max) per 16-key block and the plain version
# exp(s - row max), and the bf16 output rounds once more: a few bf16 ulps
# (2^-8 relative each) of the largest output, so 1e-2 of max|out|.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

# name: (B, T, Hq, Hkv, D, window)
CASES = {
    "global_mha": (2, 64, 2, 2, 32, None),
    "global_gqa4": (1, 64, 4, 1, 64, None),
    "window16_gqa2": (2, 64, 4, 2, 32, 16),
    "window5_gqa4": (1, 48, 4, 1, 32, 5),  # window smaller than a block
}


def _inputs(B, T, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, Hq, D)) / np.sqrt(D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    if dtype == "bfloat16":
        # bf16-representable values, so both packages start from the same inputs.
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (q, k, v))
    return q, k, v


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_pallas(case, dtype):
    B, T, Hq, Hkv, D, window = CASES[case]
    q, k, v = _inputs(B, T, Hq, Hkv, D, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_fa(*(jnp.asarray(a, jdt) for a in (q, k, v)), sliding_window=window,
                             bt=16, bs=16, interpret=True)).astype(np.float32)
    got = flash_attention.flash_attention_reference(
        *(_to_torch(a, dtype) for a in (q, k, v)), sliding_window=window)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, T, Hq, D)
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL[dtype] * np.abs(want).max())


def test_plain_matches_dense_softmax():
    """The plain version equals masked softmax attention (float32, GQA)."""
    B, T, Hq, Hkv, D, window = CASES["window16_gqa2"]
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, T, Hq, Hkv, D, "float32"))
    kk = k.repeat_interleave(Hq // Hkv, dim=2)
    vv = v.repeat_interleave(Hq // Hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, kk)
    t = torch.arange(T)
    mask = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    want = torch.einsum("bhts,bshd->bthd", probs, vv)
    got = flash_attention.flash_attention_reference(q, k, v, sliding_window=window)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_wrapper_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 48, 4, 2, 32, "float32"))
    before = flash_attention.launches
    for window in (None, 7):
        got = flash_attention.flash_attention(q, k, v, sliding_window=window)
        assert torch.equal(got, flash_attention.flash_attention_reference(
            q, k, v, sliding_window=window))
    assert flash_attention.launches == before
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="sliding_window"):
        flash_attention.flash_attention(q, k, v, sliding_window=0)
