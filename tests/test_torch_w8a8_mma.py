"""The W8A8 kernel's tensor-core design on the CPU: its launch plan for every
W8A8 shape that chip_smoke.py runs, and the mma route's walk emulated in
torch (x codes staged 16 at a time through transpose4x4 into the mma's
permuted k order, each K tile's int32 dot over whole 32-row slices, the
tiles folded into float32 in the plain order), bit for bit against the plain
version and the JAX Pallas kernel in interpret mode. The kernel itself runs
in test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w8a8 import w8a8_matmul as jax_w8a8
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.ops.kernels import matmul_w8a8
from onnx_quantize_tpu_torch.ops.kernels.matmul_q8 import MMA_K

from .test_torch_q8_mma import _s8, _transpose4x4, _word

torch.set_num_threads(1)

SMS = 132  # H100 SXM

# chip_smoke.py's W8A8 cases, (M, K, N, bk) -> (route, bm, bn): the A8
# arm's lm_head at decode and over a scoring window, then the odd shapes.
PLAN_CASES = {
    (32, 640, 262144, 640): ("mma", 32, 64),
    (2048, 640, 262144, 640): ("mma", 128, 128),
    (7, 640, 1000, 640): ("simt", 32, 32),  # N % 16 != 0
    (65, 640, 1000, 640): ("simt", 64, 32),
    (31, 640, 999, 128): ("simt", 32, 32),
    (5, 640, 40004, 640): ("simt", 32, 128),  # N % 4 == 0: four columns a thread
    (33, 640, 40004, 640): ("simt", 64, 128),
    (9, 1100, 256, 1100): ("mma", 32, 32),  # one tile of 1100 rows
    (40, 1100, 256, 1100): ("mma", 32, 32),
    (37, 640, 1008, 128): ("mma", 32, 32),  # group tiles, ragged M and N edges
    (70, 640, 1008, 128): ("mma", 64, 128),
}


@pytest.mark.parametrize("shape", list(PLAN_CASES), ids=lambda s: "M{}-K{}-N{}-bk{}".format(*s))
def test_plan_routes_and_tiles(shape):
    M, K, N, bk = shape
    plan = matmul_w8a8.w8a8_plan(M, K, N, SMS, bk)
    assert (plan.route, plan.bm, plan.bn) == PLAN_CASES[shape]
    assert plan.blocks == -(-M // plan.bm) * -(-N // plan.bn)


@pytest.mark.parametrize("bk,route", [(16, "simt"), (48, "simt"), (32, "mma"), (64, "mma"),
                                      (128, "mma"), (None, "mma")])
def test_plan_takes_group_tiles_of_whole_slices(bk, route):
    """A group tile must end on a 32-row mma slice (its int32 sums are folded
    before the next tile); a tile of all of K may end anywhere (zero codes
    fill the last slice)."""
    assert matmul_w8a8.w8a8_plan(32, 96 * 4, 256, SMS, bk).route == route


def _staged_x(x_q):
    """x_q (M, K) int8 as the mma route stages it: rows padded with zero codes
    to whole 32-row slices, each 16-code chunk loaded as four words in
    natural order and stored through transpose4x4 (s8_stage_permuted).
    Returns the staged codes (M, K32), position 4t + q of each chunk."""
    M, K = x_q.shape
    k32 = -(-K // MMA_K) * MMA_K
    codes = torch.nn.functional.pad(x_q.to(torch.int64), (0, k32 - K)).reshape(M, -1, 4, 4)
    words = [_word(codes[:, :, q] & 0xFF) for q in range(4)]  # (M, chunks) each
    cols = _transpose4x4(words)
    return torch.stack([_s8(cols[t], q) for t in range(4) for q in range(4)],
                       dim=-1).reshape(M, k32)


def _mma_route_emulation(x_q, sx, data, scale_rows, bk, fused=False):
    """The mma route's arithmetic: the staged (permuted) x codes against the
    weight rows in the same permuted order (row t + 4q at k = 4t + q of each
    16-row half), int32 per 32-row slice, summed over each K tile; then each
    tile folded in order, ``acc + float(d) * (sx * s)``, one rounded float32
    operation at a time (a single tile: its one term). ``fused``: the fold as
    one fused multiply-add (the product is exact in float64, so only the sum
    rounds), which is what XLA makes of the JAX kernel's fold on the CPU."""
    M, K = x_q.shape
    N = data.shape[1]
    w = data.to(torch.int64) - (128 if data.dtype == torch.uint8 else 0)
    k32 = -(-K // MMA_K) * MMA_K
    w = torch.nn.functional.pad(w, (0, 0, 0, k32 - K))
    xs = _staged_x(x_q)
    perm = torch.tensor([16 * h + t + 4 * q for h in range(2) for t in range(4)
                         for q in range(4)])
    tile_slices = k32 // MMA_K if bk == K else bk // MMA_K
    acc = None
    d = torch.zeros((M, N), dtype=torch.int64)
    for sl in range(k32 // MMA_K):
        k0 = sl * MMA_K
        d += xs[:, k0:k0 + MMA_K] @ w[k0 + perm]
        if (sl + 1) % tile_slices == 0:
            s = sx * scale_rows[sl // tile_slices]
            term = d.to(torch.int32).to(torch.float32) * s
            if acc is None:
                acc = term
            elif fused:
                acc = (acc.double() + d.double() * s.double()).float()
            else:
                acc = acc + term
            d.zero_()
    return acc


# (weight type, strategy, group size, K, N, M): a channel scale at the
# lm_head's K, g128 tiles, a tile of 1100 rows (x rows padded to 1104 and
# the last slice to 1120), ragged M and N tile edges, uint8 with zero point
# 128 (shifted by XOR). The JAX kernel takes N % 128 == 0 only (its TPU
# lanes), so the other cases hold to the plain version alone; with group
# tiles it equals the walk whose fold is fused (XLA contracts the kernel's
# ``acc + dot * s`` into an FMA on the CPU), and the kernel's rounded fold
# differs from that by the last bit.
EMULATION_CASES = [
    (dt, *rest) for dt in ("int8", "uint8") for rest in (
        ("channel", -1, 640, 256, 32),
        ("group", 128, 640, 256, 37),
        ("group", 128, 640, 208, 37),
        ("channel", -1, 1100, 128, 9),
        ("group", 32, 96, 48, 5),
    )
]


@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}{c[2]}-K{c[3]}-N{c[4]}-M{c[5]}")
def test_mma_walk_bit_equal_to_plain_and_jax(case):
    dtype, strategy, gs, K, N, M = case
    w = (0.1 * np.random.default_rng(0).standard_normal((K, N))).astype(np.float32)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, True, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy(strategy),
                           group_size=gs, symmetric=True, reduce_range=False,
                           input_quant=JActQuantSpec(mode="dynamic", dtype="int8",
                                                     symmetric=True))
    tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
    x = np.random.default_rng(1).standard_normal((M, K)).astype(np.float32)
    (x_q, sx, data, scale_rows), kw = matmul_w8a8.w8a8_operands(torch.from_numpy(x), tqt)
    plan = matmul_w8a8.w8a8_plan(M, x_q.shape[1], N, SMS, kw["bk"])
    assert plan.route == "mma"
    got = _mma_route_emulation(x_q, sx, data, scale_rows, kw["bk"])
    plain = matmul_w8a8.w8a8_matmul_plain(x_q, sx, data, scale_rows, **kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if N % 128 == 0:
        want = np.asarray(jax_w8a8(x, jqt, interpret=True))
        fused = _mma_route_emulation(x_q, sx, data, scale_rows, kw["bk"], fused=True)
        np.testing.assert_array_equal(fused.numpy(), want)
        if strategy == "channel":  # one tile: no fold, so no contraction
            np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(4)
    x_q = torch.from_numpy(rng.integers(-127, 128, (5, 64)).astype(np.int8))
    data = torch.from_numpy(rng.integers(-128, 128, (64, 32)).astype(np.int8))
    rows = torch.from_numpy(rng.uniform(1e-3, 1e-2, (2, 32)).astype(np.float32))
    sx = torch.tensor(0.03)
    before = (matmul_w8a8.launches, dict(matmul_w8a8.route_launches))
    got = matmul_w8a8.w8a8_matmul(x_q, sx, data, rows, bk=32)
    assert torch.equal(got, matmul_w8a8.w8a8_matmul_plain(x_q, sx, data, rows, bk=32))
    assert (matmul_w8a8.launches, matmul_w8a8.route_launches) == before
