"""The port's int8 flash-decode plain version against the JAX package's Pallas
kernel (interpret mode, its batched and per-sequence bodies) and its jnp
oracle, on the same int8 cache; and the wrapper's CPU route. The Hopper
kernel itself is tested in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.ops.kernels.flash_decode import flash_decode_int8 as jax_fd
from onnx_quantize_tpu.ops.kernels.flash_decode import flash_decode_int8_reference as jax_fd_ref
from onnx_quantize_tpu_torch.ops.kernels import flash_decode

torch.set_num_threads(1)

# Float32 on both sides from the same int8 codes and scales: the results
# differ in summation order and in float32 exp only, far inside 1e-5 of the
# output's largest magnitude.
REL_TOL = 1e-5
S = 256  # two of the JAX kernel's 128-slot blocks

# name: (Hq, Hkv, D, window, pos); the pos = S entry is the engine's sentinel
# for an inactive slot.
CASES = {
    "global_g4": (4, 1, 64, None, [0, 127, 128, 255]),
    "window16_g2": (4, 2, 64, 16, [0, 15, 130, 255]),  # window smaller than a block
    "window130_g4": (4, 1, 32, 130, [5, 129, 200, 254]),  # window spans a block edge
    "global_g1": (2, 2, 64, None, [1, 64, 190, 3]),
    "sentinel": (4, 1, 64, 16, [S, 0, 77, S]),
    "sentinel_global": (4, 2, 32, None, [S, 200, 0, 31]),
}


def _inputs(Hq, Hkv, D, pos, B=4, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, D)) / 16).astype(np.float32)
    k = rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8)
    ks = rng.uniform(1e-3, 3e-2, (B, S, Hkv)).astype(np.float32)
    vs = rng.uniform(1e-3, 3e-2, (B, S, Hkv)).astype(np.float32)
    return q, k, ks, v, vs, np.asarray(pos, np.int32)


def _port(args, window):
    return flash_decode.flash_decode_int8_reference(
        *(torch.from_numpy(a) for a in args), window=window).numpy()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("jax_route", ["pallas_batched", "pallas_per_sequence", "jnp_oracle"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case, jax_route):
    Hq, Hkv, D, window, pos = CASES[case]
    args = _inputs(Hq, Hkv, D, pos)
    got = _port(args, window)
    jargs = tuple(jnp.asarray(a) for a in args)
    if jax_route == "jnp_oracle":
        want = jax_fd_ref(*jargs, window=window)
    else:
        want = jax_fd(*jargs, window=window, interpret=True,
                      batched=jax_route == "pallas_batched")
    assert got.shape == (4, Hq, D)
    assert np.isfinite(got).all()
    _close(got, want)


def test_wrapper_on_cpu_runs_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(4, 1, 64, [0, 3, 100, S])]
    before = flash_decode.launches
    for window in (None, 8):
        for batched in (None, True, False):
            got = flash_decode.flash_decode_int8(*args, window=window, batched=batched)
            want = flash_decode.flash_decode_int8_reference(*args, window=window)
            assert torch.equal(got, want)
    assert flash_decode.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, ks, v, vs, pos = (torch.from_numpy(a) for a in _inputs(4, 2, 64, [0, 1, 2, 3]))
    with pytest.raises(TypeError, match="int8"):
        flash_decode.flash_decode_int8(q, k.view(torch.uint8), ks, v, vs, pos)
    with pytest.raises(TypeError, match="float32"):
        flash_decode.flash_decode_int8(q.to(torch.bfloat16), k, ks, v, vs, pos)
    with pytest.raises(ValueError, match="pos"):
        flash_decode.flash_decode_int8(q, k, ks, v, vs, pos.long())
    with pytest.raises(ValueError, match="multiple"):
        flash_decode.flash_decode_int8(q[:, :3], k, ks, v, vs, pos)
    with pytest.raises(ValueError, match="window"):
        flash_decode.flash_decode_int8(q, k, ks, v, vs, pos, window=0)
