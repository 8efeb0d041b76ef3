"""The Q8 kernel's tensor-core design on the CPU: its launch plan, the K
split's int32 partials with each split's own w_zp * xsum fold (emulated in
torch, against the plain version, the JAX oracle and the JAX Pallas kernel
in interpret mode), and the operand registers of its s8 mma (weight words
through transpose4x4, uint8 flipped by XOR, and x codes staged in the mma's
permuted k order), bit for bit. The kernel itself runs in
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.ops.kernels.matmul_q8 import q8_matmul as jax_q8
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp
from onnx_quantize_tpu_torch.ops.kernels.matmul_q8 import (
    MMA_K,
    q8_matmul_plain,
    q8_operands,
    q8_plan,
)

from .test_torch_q8 import _q8_case
from .test_torch_w4_mma import _byte_perm

torch.set_num_threads(1)

SMS = 132  # H100 SXM
# (name, K, N) of a Gemma-3-270M layer's seven QLINEAR sites (unfused).
BODY = [("q", 640, 1024), ("k", 640, 256), ("v", 640, 256), ("o", 1024, 640),
        ("gate", 640, 2048), ("up", 640, 2048), ("down", 2048, 640)]


def _split_rows(plan, K):
    """K-row boundaries of the plan's ranges (K rounded up to whole slices)."""
    k32 = -(-K // MMA_K) * MMA_K
    step = plan.split_slices * MMA_K
    return [min(z * step, k32) for z in range(plan.splits)] + [k32]


@pytest.mark.parametrize("M", [1, 16, 32, 64])
@pytest.mark.parametrize("site", BODY, ids=lambda s: s[0])
def test_plan_fills_the_card_at_decode(site, M):
    """Every body site launches at least one block per SM at decode, by a K
    split whose boundaries fall on whole 32-row slices, with no empty range."""
    _, K, N = site
    plan = q8_plan(M, K, N, SMS)
    assert plan.route == "mma" and plan.blocks >= SMS
    assert plan.blocks == plan.splits * -(-M // plan.bm) * -(-N // plan.bn)
    assert plan.splits > 1
    bounds = _split_rows(plan, K)
    assert all(b % MMA_K == 0 for b in bounds)
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("M", [4096, 8192])
@pytest.mark.parametrize("site", BODY, ids=lambda s: s[0])
def test_plan_takes_no_split_at_large_m(site, M):
    """A 32x128 prefill and more: enough tiles, no split."""
    _, K, N = site
    plan = q8_plan(M, K, N, SMS)
    assert (plan.route, plan.bn, plan.splits) == ("mma", 128, 1)
    assert plan.bm in (64, 128) and plan.blocks == plan.tiles


@pytest.mark.parametrize("N,route,bn", [
    (40, "simt", 32),  # N % 16 != 0: no 16-byte weight copies
    (100, "simt", 32),
    (130, "simt", 32),
    (40064, "mma", 64),  # many tiles: no split
    (208, "mma", 32),  # N % 16 == 0 with a ragged tile edge, masked
])
def test_plan_routes(N, route, bn):
    plan = q8_plan(7, 640, N, SMS)
    assert (plan.route, plan.bn) == (route, bn)
    if route == "simt":
        assert plan.splits == 1 and plan.split_slices == 0


def _split_kernel_emulation(x2d, data, bias, c, plan):
    """The mma route's integer arithmetic: x codes quantized as staged (0 past
    K), each split's int32 dot over its range of whole slices with its own
    ``- w_zp * xsum`` folded in, the partials summed, then ``- x_zp * wsum +
    K * x_zp * w_zp + bias`` and the epilogue, one rounded float32 operation
    at a time."""
    M, K = x2d.shape
    x_q = torch.clamp(torch.round(x2d.to(torch.float32) / c.fparams[0]).to(torch.int64)
                      + c.iparams[0], *c.iq) - c.x_shift
    w = data.to(torch.int64) - (128 if data.dtype == torch.uint8 else 0)
    k32 = -(-K // MMA_K) * MMA_K
    x_q = torch.nn.functional.pad(x_q, (0, k32 - K))
    w = torch.nn.functional.pad(w, (0, 0, 0, k32 - K))
    wzp = c.wzp.to(torch.int64)
    bounds = _split_rows(plan, K)
    acc = torch.zeros((M, data.shape[1]), dtype=torch.int64)
    for lo, hi in zip(bounds, bounds[1:]):
        xz = x_q[:, lo:hi]
        acc += xz @ w[lo:hi] - wzp * xz.sum(dim=1, keepdim=True)
    x_zp = int(c.iparams[0]) - c.x_shift
    acc += -x_zp * c.wsum.to(torch.int64) + K * x_zp * wzp
    if bias is not None:
        acc += bias.to(torch.int64)
    acc = ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)  # int32 wraparound
    y_zp = c.iparams[1].to(torch.float32)
    y_q = torch.clamp(torch.round(acc.to(torch.float32) * c.req) + y_zp, *c.oq)
    return (y_q - y_zp) * c.fparams[1]


# (strategy, bias, K, weight type, symmetric, N, M): the 270M k site at
# decode (20 single-slice splits), down (16 splits of 4 slices), a K tail
# with zero points per tensor, and uint8 symmetric weights at N = 208 with a
# ragged M.
EMULATION_CASES = [
    (JStrategy.CHANNEL, False, 640, JQuantType.QInt8, True, 256, 32),
    (JStrategy.CHANNEL, True, 2048, JQuantType.QInt8, True, 640, 32),
    (JStrategy.TENSOR, True, 100, JQuantType.QUInt8, False, 128, 6),
    (JStrategy.CHANNEL, True, 1000, JQuantType.QUInt8, True, 208, 40),
]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["split", "no-split"])
@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: f"{c[3].value}-K{c[2]}-N{c[5]}-M{c[6]}")
def test_split_int32_partials_bit_equal_to_plain_and_jax(case, sms):
    """The K split's partials, folded per split and summed, give the plain
    version's, the JAX oracle's and (N % 128 == 0) the JAX Pallas kernel's
    float32 bits exactly."""
    strategy, with_bias, K, w_qt, w_sym, N, M = case
    _, jqt, jbias, tqt, tbias = _q8_case(strategy, with_bias, K, w_qt, w_sym, seed=2, N=N)
    x = np.random.default_rng(3).standard_normal((M, K)).astype(np.float32)
    x2d, data, bias, c = q8_operands(torch.from_numpy(x), tqt, tbias)
    plan = q8_plan(M, K, N, sms)
    assert plan.route == "mma" and (plan.splits > 1) == (sms == SMS)
    got = _split_kernel_emulation(x2d, data, bias, c, plan)
    want = np.asarray(quantized_matmul_jnp(x, jqt, jbias))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(q8_matmul_plain(x2d, data, bias, c).numpy(), want)
    if N % 128 == 0:
        np.testing.assert_array_equal(np.asarray(jax_q8(x, jqt, jbias, interpret=True)), want)


def _transpose4x4(rows):
    """common.cuh's transpose4x4 on int64 tensors of 32-bit words."""
    a = _byte_perm(rows[0], rows[1], 0x5140)
    b = _byte_perm(rows[2], rows[3], 0x5140)
    c = _byte_perm(rows[0], rows[1], 0x7362)
    d = _byte_perm(rows[2], rows[3], 0x7362)
    return [_byte_perm(a, b, 0x5410), _byte_perm(a, b, 0x7632),
            _byte_perm(c, d, 0x5410), _byte_perm(c, d, 0x7632)]


def _word(byte_rows):
    """Four bytes (last dim, lowest first) as one little-endian word."""
    return sum(byte_rows[..., i].to(torch.int64) << (8 * i) for i in range(4))


def _s8(words, i):
    """Byte i of 32-bit words as a signed 8-bit value."""
    b = (words >> (8 * i)) & 0xFF
    return b - ((b >> 7) << 8)


@pytest.mark.parametrize("signed", [True, False], ids=["int8", "uint8"])
def test_mma_operand_registers_are_exact(signed):
    """One 32-row slice of the mma route, register by register. Lane (g, t)
    loads the weight words of rows t + 4q and 16 + t + 4q at columns 4g ..
    4g + 3 (uint8 XORed with 0x80808080) and transposes them: register j
    holds column 4g + j. x codes are staged 16 at a time through the same
    transpose, so the A fragment's k = 4t + q is row t + 4q as well. The
    fragments' dot over the mma's k equals the plain int dot of the slice."""
    rng = np.random.default_rng(0)
    M, N = 16, 32
    raw = torch.from_numpy(rng.integers(0, 256, (MMA_K, N), dtype=np.int64))
    w = raw - 256 * (raw > 127) if signed else raw - 128  # the shifted weight values
    codes = torch.from_numpy(rng.integers(-128, 128, (M, MMA_K), dtype=np.int64))
    flip = 0 if signed else 0x80808080
    perm = [t + 4 * q for t in range(4) for q in range(4)]  # k = 4t + q holds row t + 4q

    # B: b[h][j][g, t] is the register of n-tile j, half h (b0, b1).
    b = torch.zeros((2, 4, MMA_K), dtype=torch.int64).reshape(2, 4, 8, 4)
    for g in range(8):
        for t in range(4):
            for h in range(2):
                rows = [_word(raw[16 * h + t + 4 * q, 4 * g:4 * g + 4]) ^ flip for q in range(4)]
                cols = _transpose4x4([torch.as_tensor(r) for r in rows])
                for j in range(4):
                    b[h, j, g, t] = cols[j]
                    for q in range(4):
                        assert _s8(cols[j], q) == w[16 * h + t + 4 * q, 4 * g + j]
    # A: each row's 16-code halves packed as words 4q .. 4q + 3, transposed.
    staged = torch.zeros((M, 2, 4), dtype=torch.int64)
    for h in range(2):
        words = [_word((codes[:, 16 * h + 4 * q:16 * h + 4 * q + 4] & 0xFF)) for q in range(4)]
        for t, col in enumerate(_transpose4x4(words)):
            staged[:, h, t] = col
    a_k = torch.stack([_s8(staged[:, h, t], q) for h in range(2) for t in range(4)
                       for q in range(4)], dim=1)  # (M, 32) in the mma's k order
    assert torch.equal(a_k, codes[:, [16 * h + p for h in range(2) for p in perm]])
    # The mma's dot: sum over k = 16 h + 4 t + q of A[m, k] * B[k, n].
    b_k = torch.stack([_s8(b[h, :, :, t], q) for h in range(2) for t in range(4)
                       for q in range(4)], dim=0)  # (32, n-tile j, column g)
    got = a_k @ b_k.reshape(MMA_K, 32)
    cols_order = [4 * g + j for j in range(4) for g in range(8)]
    assert torch.equal(got, (codes @ w)[:, cols_order])
