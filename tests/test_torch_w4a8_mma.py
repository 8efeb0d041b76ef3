"""The W4A8 kernel's tensor-core design on the CPU: its launch plan for every
W4A8 shape that chip_smoke.py runs, the bytewise nibble widening of its B
operands (emulated bit for bit over every byte), and the mma route's walk
with the plan's K split emulated in torch (x codes staged 16 at a time through
transpose4x4 into the mma's permuted k order, per-group int32 dots and row
sums added over the splits, every pair then folded into float32 in the plain
order), bit for bit against the plain version and the JAX Pallas kernel in
interpret mode. The kernel itself runs in test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.engine import prepare_kernel_scales as jax_prepare
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w4a8 import w4a8_matmul as jax_w4a8
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.ops.kernels import matmul_w4a8
from onnx_quantize_tpu_torch.ops.kernels.matmul_q8 import MMA_K
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4a8 import w4a8_plan

from .test_torch_w8a8_mma import _staged_x

torch.set_num_threads(1)

SMS = 132  # H100 SXM

# chip_smoke.py's W4A8 cases, (M, K_pad, N, gs) -> (route, bm, bn, splits):
# a Gemma-3-270M layer's four g128 sites at decode and at a 32x128 prefill
# (qkv and gate_up: K = 640 padded to 6 groups), then the odd shapes.
PLAN_CASES = {
    (32, 768, 1536, 128): ("mma", 32, 64, 3),
    (32, 1024, 640, 128): ("mma", 32, 64, 6),
    (32, 768, 4096, 128): ("mma", 32, 64, 1),
    (32, 2048, 640, 128): ("mma", 32, 64, 6),
    (4096, 768, 1536, 128): ("mma", 32, 128, 1),
    (4096, 1024, 640, 128): ("mma", 32, 128, 1),
    (4096, 768, 4096, 128): ("mma", 32, 128, 1),
    (4096, 2048, 640, 128): ("mma", 32, 128, 1),
    (5, 384, 200, 64): ("simt", 32, 32, 1),  # N % 16 != 0
    (37, 384, 200, 64): ("simt", 64, 32, 1),
    (3, 768, 20000, 128): ("mma", 32, 64, 1),  # 313 tiles: no split
    (70, 768, 20000, 128): ("mma", 32, 128, 1),
    (5, 640, 1008, 32): ("mma", 32, 64, 5),  # g32: a slice is a whole group
    (70, 640, 1008, 32): ("mma", 32, 128, 4),
    (3, 512, 208, 64): ("mma", 32, 64, 8),  # int4 g64, a pad group
    (40, 512, 208, 64): ("mma", 32, 64, 8),
    (4, 130, 128, 65): ("simt", 32, 32, 1),  # channel scales: a group of 65 rows
    (7, 96, 128, 16): ("simt", 32, 32, 1),  # a 16-row group
}


@pytest.mark.parametrize("shape", list(PLAN_CASES), ids=lambda s: "M{}-K{}-N{}-g{}".format(*s))
def test_plan_routes_tiles_and_splits(shape):
    M, K_pad, N, gs = shape
    plan = w4a8_plan(M, K_pad, N, gs, SMS)
    assert (plan.route, plan.bm, plan.bn, plan.splits) == PLAN_CASES[shape]
    assert plan.blocks == plan.splits * -(-M // plan.bm) * -(-N // plan.bn)
    assert plan.groups == K_pad // gs
    if plan.route == "mma":
        slices = K_pad // 2 // MMA_K
        assert -(-slices // plan.split_slices) == plan.splits
        assert plan.splits == 1 or plan.blocks >= SMS * 3 // 8 or plan.split_slices == 1
        assert plan.scratch_elems == plan.tiles * plan.groups * (plan.bm * plan.bn + plan.bm)
    else:
        assert plan.split_slices == 0


def test_plan_keeps_int32_dots_exact():
    """Past K_pad = 2^17 the s8 mma could overflow without .satfinite: simt."""
    assert w4a8_plan(32, 1 << 17, 256, 128, SMS).route == "simt"
    assert w4a8_plan(32, (1 << 17) - 256, 256, 128, SMS).route == "mma"


def _nibbles(words, shift, signed):
    """The kernel's nibbles(): __vsub4(((w >> shift) & 0x0F0F0F0F) ^ sign,
    sign), sign 0x08080808 for int4, bytewise on int64 words."""
    sign = 0x08080808 if signed else 0
    v = ((words >> shift) & 0x0F0F0F0F) ^ sign
    out = torch.zeros_like(words)
    for b in range(4):
        byte = (((v >> (8 * b)) & 0xFF) - ((sign >> (8 * b)) & 0xFF)) & 0xFF
        out |= byte << (8 * b)
    return out


@pytest.mark.parametrize("signed", [False, True], ids=["uint4", "int4"])
def test_nibble_widening_is_exact(signed):
    """Every byte in every position: the low and high nibbles widen to the s8
    bytes of their values (uint4 0..15, int4 sign-extended -8..7)."""
    every = torch.arange(256, dtype=torch.int64)
    g = np.random.default_rng(0)
    words = torch.cat([every * 0x01010101, every | (every.flip(0) << 16),
                       torch.from_numpy(g.integers(0, 2 ** 32, 4096, dtype=np.int64))])
    for shift, part in ((0, lambda b: b & 15), (4, lambda b: b >> 4)):
        got = _nibbles(words, shift, signed)
        for b in range(4):
            want = part((words >> (8 * b)) & 0xFF)
            if signed:
                want = torch.where(want > 7, want - 16, want)
            byte = (got >> (8 * b)) & 0xFF
            assert torch.equal(torch.where(byte > 127, byte - 256, byte), want)


def _site(dtype, gs, K, N, seed=0):
    w = (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32)
    sym = dtype == "int4"
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy.GROUP, gs, sym, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy.GROUP,
                           group_size=gs, symmetric=sym, reduce_range=False,
                           input_quant=JActQuantSpec(mode="dynamic", dtype="int8",
                                                     symmetric=True))
    jqt = jax_prepare({"w": jqt})["w"]
    return jqt, from_jax_params({"w": jqt}, device="cpu")["w"]


# Inside each 16-row half of a 32-row slice the mma's k order is permuted:
# k = 4t + q holds row t + 4q (the s8 core's layout in common.cuh).
_PERM = torch.tensor([16 * h + t + 4 * q for h in range(2) for t in range(4) for q in range(4)])


def _mma_walk(x_q, sx, data, scales, zps, *, gs, signed, plan, fused=False):
    """The mma route's arithmetic. Each split walks its 32-row slices of
    packed rows: the staged (permuted) low- and high-group x codes against
    the widened nibbles of the same rows in the same order, int32 per slice,
    and the row sums of the staged codes (the ones-mma), added per group into
    the tile's totals (the atomics: integer sums, any order). Then every pair
    folds in order, ``acc + (t_lo + t_hi)`` with ``t = (d - xsum * zp) *
    (sx * s)``, one rounded float32 operation at a time. ``fused``: the fold
    as XLA contracts the JAX kernel's on the CPU, ``acc + fma(d_lo - xsum_lo
    * zp_lo, sx * s_lo, t_hi)`` (the product is exact in float64)."""
    M, K_pad = x_q.shape
    half_rows, N = data.shape
    groups = K_pad // gs
    words = data.to(torch.int64)
    nib = [_nibbles(words, shift, signed) for shift in (0, 4)]
    nib = [torch.where(n > 127, n - 256, n) for n in nib]  # s8 bytes as values
    dots = torch.zeros((groups, M, N), dtype=torch.int64)
    xsum = torch.zeros((groups, M, 1), dtype=torch.int64)
    slices = half_rows // MMA_K
    for z in range(plan.splits):
        for c in range(z * plan.split_slices, min(slices, (z + 1) * plan.split_slices)):
            pr = c * MMA_K
            p, r = divmod(pr, gs)
            for h in (0, 1):
                col = (2 * p + h) * gs + r
                xs = _staged_x(x_q[:, col:col + MMA_K])  # (M, 32), permuted
                dots[2 * p + h] += xs @ nib[h][pr + _PERM]
                xsum[2 * p + h] += xs.sum(dim=1, keepdim=True)
    assert (dots.abs() < 2 ** 31).all()
    s = sx * scales.reshape(groups, 1, N)
    zp = zps.reshape(groups, 1, N)
    d = dots.to(torch.int32).to(torch.float32)
    t = (d - xsum.to(torch.float32) * zp) * s
    acc = torch.zeros((M, N))
    for p in range(groups // 2):
        if fused:
            inner = d[2 * p] - xsum[2 * p].to(torch.float32) * zp[2 * p]
            acc = acc + (inner.double() * s[2 * p].double() + t[2 * p + 1].double()).float()
        else:
            acc = acc + (t[2 * p] + t[2 * p + 1])
    return acc


# (dtype, group size, K, N, M): the four 270M sites' shapes at decode (N cut
# to 256 and 384), a pad group, int4 and uint4, g32 (every slice a whole
# group), g64 and g128, ragged M, and N not a multiple of the JAX kernel's
# 128 lanes (held to the plain version alone).
WALK_CASES = [
    ("uint4", 128, 640, 384, 32),
    ("uint4", 128, 1024, 256, 32),
    ("int4", 128, 2048, 128, 7),
    ("uint4", 32, 640, 256, 37),
    ("int4", 64, 448, 208, 3),
    ("uint4", 64, 320, 128, 70),
]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["split", "no-split"])
@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: f"{c[0]}-g{c[1]}-K{c[2]}-N{c[3]}-M{c[4]}")
def test_mma_walk_bit_equal_to_plain_and_jax(case, sms):
    dtype, gs, K, N, M = case
    jqt, tqt = _site(dtype, gs, K, N)
    x = np.random.default_rng(1).standard_normal((M, K)).astype(np.float32)
    (x_q, sx, data, scales, zps), kw = matmul_w4a8.w4a8_operands(torch.from_numpy(x), tqt)
    plan = w4a8_plan(M, x_q.shape[1], N, kw["gs"], sms)
    assert plan.route == "mma" and (plan.splits > 1) == (sms == SMS)
    got = _mma_walk(x_q, sx, data, scales, zps, plan=plan, **kw)
    plain = matmul_w4a8.w4a8_matmul_plain(x_q, sx, data, scales, zps, **kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if N % 128 == 0:
        want = np.asarray(jax_w4a8(x, jqt, interpret=True))
        fused = _mma_walk(x_q, sx, data, scales, zps, plan=plan, fused=True, **kw)
        np.testing.assert_array_equal(fused.numpy(), want)


def test_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(4)
    x_q = torch.from_numpy(rng.integers(-127, 128, (5, 128)).astype(np.int8))
    data = torch.from_numpy(rng.integers(0, 256, (64, 32)).astype(np.uint8))
    scales = torch.from_numpy(rng.uniform(1e-3, 1e-2, (1, 2, 32)).astype(np.float32))
    zps = torch.from_numpy(rng.integers(0, 16, (1, 2, 32)).astype(np.float32))
    sx = torch.tensor(0.03)
    before = (matmul_w4a8.launches, dict(matmul_w4a8.route_launches))
    got = matmul_w4a8.w4a8_matmul(x_q, sx, data, scales, zps, gs=64, signed=False)
    want = matmul_w4a8.w4a8_matmul_plain(x_q, sx, data, scales, zps, gs=64, signed=False)
    assert torch.equal(got, want)
    assert (matmul_w4a8.launches, matmul_w4a8.route_launches) == before
