"""The W8 kernel's tensor-core design on the CPU: its launch plan for every W8
shape that chip_smoke.py runs, the exact byte-to-bf16 conversion of its
operand registers (emulated bit for bit over every byte), and the mma route's
walk with the plan's K split (emulated in torch) against the plain version
and the JAX Pallas kernel in interpret mode. The kernel itself runs in
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w8 import w8_dequant_matmul as jax_w8
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.ops.kernels import matmul_w8
from onnx_quantize_tpu_torch.ops.kernels.matmul_w8 import MMA_SLICE, w8_plan

from .test_torch_w4_mma import _byte_perm

torch.set_num_threads(1)

SMS = 132  # H100 SXM

# chip_smoke.py's W8 cases, (M, K, N, bk, x dtype) -> (route, bm, bn, splits):
# the lm_head at decode and over a scoring window, then the odd shapes.
BF16, F32 = torch.bfloat16, torch.float32
PLAN_CASES = {
    (32, 640, 262144, 640, BF16): ("mma", 32, 128, 1),
    (2048, 640, 262144, 640, BF16): ("mma", 128, 256, 1),  # x-stationary
    (32, 640, 262144, 640, F32): ("simt", 32, 128, 1),  # float32 x: the CUDA cores
    (5, 640, 40004, 640, BF16): ("simt", 32, 128, 1),  # N % 16 != 0
    (33, 640, 40004, 640, BF16): ("simt", 64, 128, 1),
    (7, 640, 1000, 640, BF16): ("simt", 32, 32, 1),
    (65, 640, 1000, 640, BF16): ("simt", 64, 32, 1),
    (31, 640, 999, 128, BF16): ("simt", 32, 32, 1),
    (33, 640, 1008, 640, BF16): ("mma", 64, 128, 20),  # 16 tiles: K split
    (5, 640, 1008, 32, BF16): ("mma", 16, 128, 20),  # splits straddle g32 tiles
    (70, 640, 1008, 32, BF16): ("mma", 64, 128, 10),
    (4, 130, 128, 130, BF16): ("simt", 32, 32, 1),  # a K tile of 130 rows
    (2048, 640, 16384, 128, BF16): ("mma", 64, 128, 1),  # group tiles at a window's M
}


@pytest.mark.parametrize("shape", list(PLAN_CASES),
                         ids=lambda s: "M{}-K{}-N{}-bk{}-{}".format(*s[:4], str(s[4])[6:]))
def test_plan_routes_tiles_and_splits(shape):
    M, K, N, bk, dtype = shape
    plan = w8_plan(M, K, N, bk, dtype, SMS)
    assert (plan.route, plan.bm, plan.bn, plan.splits) == PLAN_CASES[shape]
    assert plan.blocks == plan.splits * -(-M // plan.bm) * -(-N // plan.bn)
    if plan.route == "mma":
        slices = K // MMA_SLICE
        assert -(-slices // plan.split_slices) == plan.splits
        assert plan.splits == 1 or plan.blocks >= SMS or plan.split_slices == 1
    else:
        assert plan.split_slices == 0


# (M, K, N, bk) -> (bm, bn) above M = 64: the x-stationary form (bn 256)
# where a single K tile's x rows fit in shared memory beside the ring (128
# rows, else 64) and give four tiles an SM.
LARGE_M_CASES = {
    (2048, 640, 262144, 640): (128, 256),
    (400, 640, 65552, 640): (128, 256),
    (65, 640, 262144, 640): (128, 256),
    (200, 1024, 65552, 1024): (64, 256),  # 128 rows of K = 1024 do not fit
    (2048, 1536, 262144, 1536): (64, 128),  # nor do 64 of 1536
    (2048, 640, 262144, 128): (64, 128),  # group tiles
    (100, 640, 16384, 640): (64, 128),  # 64 tiles of 256: too few
}


@pytest.mark.parametrize("shape", list(LARGE_M_CASES),
                         ids=lambda s: "M{}-K{}-N{}-bk{}".format(*s))
def test_plan_large_m_tiles(shape):
    M, K, N, bk = shape
    plan = w8_plan(M, K, N, bk, BF16, SMS)
    assert (plan.route, plan.bm, plan.bn, plan.splits) == ("mma", *LARGE_M_CASES[shape], 1)
    assert plan.blocks == -(-M // plan.bm) * -(-N // plan.bn)


@pytest.mark.parametrize("M", [1, 16, 32, 33, 64, 65, 2048, 4096])
def test_lm_head_plan_never_splits(M):
    """The lm_head (K = 640, N = 262,144) has enough tiles at every M."""
    plan = w8_plan(M, 640, 262144, 640, BF16, SMS)
    assert plan.route == "mma" and plan.splits == 1 and plan.blocks >= 2 * SMS


def _as_float(words):
    return words.to(torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("signed", [False, True], ids=["uint8", "int8"])
def test_byte_to_bf16_is_exact(signed):
    """The kernel's operand registers, emulated bit for bit: byte j of a word
    (int8 words XORed with 0x80808080) put under 0x4B by prmt is the float
    2^23 + b; subtracting 2^23 (int8: 2^23 + 128) and rounding to bf16 gives
    every byte's exact value, in every position."""
    g = np.random.default_rng(0)
    every = torch.arange(256, dtype=torch.int64)
    words = torch.cat([torch.from_numpy(g.integers(0, 2 ** 32, 4096, dtype=np.int64)),
                       every * 0x01010101, every | (every.flip(0) << 24)])
    flip = 0x80808080 if signed else 0
    magic = torch.tensor(8388736.0 if signed else 8388608.0)
    for j in range(4):
        sel = 0x7440 | j
        f = _as_float(_byte_perm(words ^ flip, torch.full_like(words, 0x4B000000), sel))
        got = (f - magic).to(torch.bfloat16).to(torch.float32)
        byte = (words >> (8 * j)) & 0xFF
        want = torch.where(byte > 127, byte - 256, byte) if signed else byte
        assert torch.equal(got, want.to(torch.float32))


def _sites(dtype, strategy, gs, K, N, symmetric, seed=0):
    w = (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, symmetric, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy(strategy),
                           group_size=gs, symmetric=symmetric, reduce_range=False)
    return jqt, from_jax_params({"w": jqt}, device="cpu")["w"]


def _mma_walk(x2d, data, scale_rows, zp_rows, *, bk, plan):
    """The mma route's arithmetic in float32: each split walks its 16-row
    slices, accumulating the partial dot and (asymmetric) the x sums of the
    current K tile, folds ``(d - xsum * zp) * s`` when the tile changes and
    at its end; the partial tiles are then summed in split order."""
    M, K = x2d.shape
    N = data.shape[1]
    xf = x2d.to(torch.float32)
    wf = data.to(torch.float32)
    tile_slices = bk // MMA_SLICE
    slices = K // MMA_SLICE
    out = torch.zeros((M, N))
    for z in range(plan.splits):
        acc = torch.zeros((M, N))
        d = torch.zeros((M, N))
        xs = torch.zeros((M, 1))
        first = z * plan.split_slices
        cur = first // tile_slices

        def fold(tile):
            if zp_rows is None:
                return d * scale_rows[tile]
            return (d - xs * zp_rows[tile]) * scale_rows[tile]

        for c in range(first, min(slices, first + plan.split_slices)):
            if c // tile_slices != cur:
                acc += fold(cur)
                d.zero_()
                xs.zero_()
                cur = c // tile_slices
            xc = xf[:, c * MMA_SLICE:(c + 1) * MMA_SLICE]
            d += xc @ wf[c * MMA_SLICE:(c + 1) * MMA_SLICE]
            xs += xc.sum(dim=1, keepdim=True)
        acc += fold(cur)
        out = out + acc
    return out


# (weight type, strategy, group size, symmetric, K, N, M): a channel scale at
# the lm_head's K, asymmetric uint8, group tiles of 32 and 128 rows with the
# plan's K split straddling them, ragged M. The JAX kernel drops the zero
# point 128 of symmetric uint8 (a reference fault), so those cases are left
# out; every N is a multiple of 128, the JAX kernel's lanes.
WALK_CASES = [
    ("int8", "channel", -1, True, 640, 256, 32),
    ("uint8", "channel", -1, False, 640, 256, 5),
    ("uint8", "group", 32, False, 640, 256, 37),
    ("int8", "group", 128, True, 640, 128, 70),
    ("uint8", "group", 64, False, 96 * 4, 384, 3),
]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["split", "no-split"])
@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}{c[2]}-K{c[4]}-N{c[5]}-M{c[6]}")
def test_mma_walk_matches_plain_and_jax(case, sms):
    """The walk with the plan's splits equals the plain version and the JAX
    kernel on bf16-representable x: float32 sums in another order, within
    1e-5 of max|y|."""
    dtype, strategy, gs, symmetric, K, N, M = case
    jqt, tqt = _sites(dtype, strategy, gs, K, N, symmetric)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((M, K)).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32)
    (x2d, data, scale_rows, zp_rows), kw = matmul_w8.w8_operands(x, tqt)
    plan = w8_plan(M, K, N, kw["bk"], torch.bfloat16, sms)
    assert plan.route == "mma" and (plan.splits > 1) == (sms == SMS)
    got = _mma_walk(x2d, data, scale_rows, zp_rows, plan=plan, **kw)
    plain = matmul_w8.w8_dequant_matmul_plain(x2d, data, scale_rows, zp_rows, **kw)
    want = np.asarray(jax_w8(jnp.asarray(x.numpy()), jqt, interpret=True))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)).to(torch.bfloat16)
    data = torch.from_numpy(rng.integers(0, 256, (64, 32)).astype(np.uint8))
    rows = torch.from_numpy(rng.uniform(1e-3, 1e-2, (2, 32)).astype(np.float32))
    zps = torch.from_numpy(rng.integers(0, 256, (2, 32)).astype(np.float32))
    before = (matmul_w8.launches, dict(matmul_w8.route_launches))
    got = matmul_w8.w8_matmul(x, data, rows, zps, bk=32)
    assert torch.equal(got, matmul_w8.w8_dequant_matmul_plain(x, data, rows, zps, bk=32))
    assert (matmul_w8.launches, matmul_w8.route_launches) == before
