"""The W4 kernel's tensor-core design on the CPU: its launch plan, the
chunked affine its K split relies on (emulated in torch, against the plain
version and the JAX Pallas kernel in interpret mode), and the exact
nibble-to-bf16 bit trick of its operand registers. The kernel itself runs in
test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.engine import prepare_kernel_scales as jax_prepare
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_dequant_matmul as jax_w4
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import (
    MMA_SLICE,
    w4_dequant_matmul_plain,
    w4_operands,
    w4_plan,
)

torch.set_num_threads(1)

SMS = 132  # H100 SXM
# (name, K_pad, N) of a Gemma-3-270M layer's four W4 g128 sites, K padded to
# whole group pairs (qkv and gate_up: 5 groups of 128 padded to 6).
BODY = [("qkv", 768, 1536), ("o", 1024, 640), ("gate_up", 768, 4096), ("down", 2048, 640)]


def _split_rows(plan, K_pad):
    """Packed-row boundaries of the plan's K ranges."""
    half_rows = K_pad // 2
    step = plan.split_chunks * MMA_SLICE
    return [min(z * step, half_rows) for z in range(plan.splits)] + [half_rows]


@pytest.mark.parametrize("M", [1, 16, 32, 64])
@pytest.mark.parametrize("site", BODY, ids=lambda s: s[0])
def test_plan_fills_the_card_at_decode(site, M):
    """Every body site launches at least one block per SM at decode, by a K
    split whose boundaries fall on 16-row slices, each slice inside one
    group pair, with no empty range."""
    _, K_pad, N = site
    gs = 128
    plan = w4_plan(M, K_pad, N, gs, torch.bfloat16, SMS)
    assert plan.route == "mma" and plan.blocks >= SMS
    assert plan.blocks == plan.splits * -(-M // plan.bm) * -(-N // plan.bn)
    bounds = _split_rows(plan, K_pad)
    assert all(b % MMA_SLICE == 0 for b in bounds)
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    assert all(r // gs == (r + MMA_SLICE - 1) // gs for r in range(0, K_pad // 2, MMA_SLICE))


@pytest.mark.parametrize("M", [2048, 4096])
@pytest.mark.parametrize("site", BODY, ids=lambda s: s[0])
def test_plan_takes_no_split_at_large_m(site, M):
    _, K_pad, N = site
    plan = w4_plan(M, K_pad, N, 128, torch.bfloat16, SMS)
    assert (plan.route, plan.bm, plan.bn, plan.splits) == ("mma", 64, 128, 1)
    assert plan.blocks >= SMS


@pytest.mark.parametrize("dtype,gs,N,route,bn", [
    (torch.float32, 128, 640, "simt", 32),  # float32 x: the CUDA-core route
    (torch.float32, 128, 20000, "simt", 128),  # four columns a thread fill the SMs
    (torch.bfloat16, 65, 128, "simt", 32),  # channel scales over K = 130: gs % 16 != 0
    (torch.bfloat16, 64, 200, "simt", 32),  # N % 16 != 0: no 16-byte weight copies
    (torch.bfloat16, 64, 208, "mma", 64),  # N % 16 == 0 with a ragged tile edge, masked
])
def test_plan_routes(dtype, gs, N, route, bn):
    plan = w4_plan(3, 4 * gs, N, gs, dtype, SMS)
    assert (plan.route, plan.bn) == (route, bn)
    if route == "simt":
        assert plan.splits == 1 and plan.split_chunks == 0


def _sites(dtype, gs, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    sym = dtype == "int4"
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy.GROUP, gs, sym, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy.GROUP,
                           group_size=gs, symmetric=sym, reduce_range=False)
    jqt = jax_prepare({"w": jqt})["w"]
    return jqt, from_jax_params({"w": jqt}, device="cpu")["w"]


def _split_kernel_emulation(x2d, data, scales, zps, *, gs, signed, plan):
    """The mma route's arithmetic in float32: each split walks its 16-row
    slices, accumulating the low- and high-nibble partial dots and their x
    sums, folds ``(d - xsum * zp) * s`` whenever the group pair changes and
    at its end; the partial tiles are then summed in split order."""
    M, K_pad = x2d.shape
    N = data.shape[1]
    nib = torch.stack([data & 0x0F, data >> 4]).to(torch.int16)
    if signed:
        nib = torch.where(nib > 7, nib - 16, nib)
    nib = nib.to(torch.float32)
    xf = x2d.to(torch.float32)
    chunks = K_pad // (2 * MMA_SLICE)
    out = torch.zeros((M, N))
    for z in range(plan.splits):
        acc = torch.zeros((M, N))
        d = torch.zeros((2, M, N))
        xs = torch.zeros((2, M, 1))
        cur = -1

        def fold(p):
            return sum((d[h] - xs[h] * zps[p, h]) * scales[p, h] for h in (0, 1))

        for c in range(z * plan.split_chunks, min(chunks, (z + 1) * plan.split_chunks)):
            row = c * MMA_SLICE
            p, r = divmod(row, gs)
            if p != cur:
                if cur >= 0:
                    acc += fold(cur)
                d.zero_()
                xs.zero_()
                cur = p
            for h in (0, 1):
                xc = xf[:, (2 * p + h) * gs + r:(2 * p + h) * gs + r + MMA_SLICE]
                d[h] += xc @ nib[h, row:row + MMA_SLICE]
                xs[h] += xc.sum(dim=1, keepdim=True)
        acc += fold(cur)
        out = out + acc
    return out


# (dtype, gs, K, N, M): pad groups (K = 640 and 320 fill 5 of 6 groups),
# int4 and uint4, g64 and g128, ragged M.
AFFINE_CASES = [
    ("uint4", 128, 640, 256, 32),
    ("int4", 128, 1024, 128, 5),
    ("uint4", 64, 320, 128, 3),
    ("int4", 64, 448, 256, 70),
]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["split", "no-split"])
@pytest.mark.parametrize("case", AFFINE_CASES, ids=lambda c: f"{c[0]}-g{c[1]}-K{c[2]}-M{c[4]}")
def test_chunked_affine_matches_plain_and_jax(case, sms):
    """The K split's per-chunk affine, ``sum_c (x_c . w_c - xsum_c * zp) * s``
    over the plan's ranges, equals the plain version and the JAX kernel on
    bf16-representable x. Float32 sums in another order: 1e-5 of max|y|."""
    dtype, gs, K, N, M = case
    jqt, tqt = _sites(dtype, gs, K, N)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((M, K)).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32)
    (x2d, data, scales, zps), kw = w4_operands(x, tqt)
    plan = w4_plan(M, x2d.shape[1], N, gs, torch.bfloat16, sms)
    assert plan.route == "mma" and (plan.splits > 1) == (sms == SMS)
    got = _split_kernel_emulation(x2d, data, scales, zps, plan=plan, **kw)
    plain = w4_dequant_matmul_plain(x2d, data, scales, zps, **kw)
    want = np.asarray(jax_w4(jnp.asarray(x.numpy()), jqt, interpret=True))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on int64 tensors of 32-bit words."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16_halves(words):
    """The two bf16 halves of 32-bit words, as float32 (low half first)."""
    halves = torch.stack([words & 0xFFFF, words >> 16], dim=-1)
    halves = halves - ((halves >> 15) << 16)  # as signed 16-bit values
    return halves.to(torch.int16).view(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize("signed", [False, True], ids=["uint4", "int4"])
def test_nibble_to_bf16_bit_trick_is_exact(signed):
    """The kernel's operand registers, emulated bit for bit: byte j of two
    weight words (rows k and k + 1) through prmt, the nibble masked into
    0x4300 (int4: xor 8 first), read as bf16 and offset by 128 (int4: 136)
    in bf16, give every nibble's exact value, row k in the low half."""
    g = np.random.default_rng(0)
    words = torch.from_numpy(g.integers(0, 2 ** 32, (2, 4096), dtype=np.int64))
    every = torch.arange(256, dtype=torch.int64)  # every byte, in each position
    a = torch.cat([words[0], every * 0x01010101])
    b = torch.cat([words[1], every.flip(0) * 0x01010101])
    nib_bits = 0x43084308 if signed else 0x43004300
    offset = torch.tensor(136.0 if signed else 128.0, dtype=torch.bfloat16)

    def value(n):
        return torch.where(n > 7, n - 16, n) if signed else n

    for j in range(4):
        sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12)
        p = _byte_perm(a, b, sel)
        lo = _bf16_halves((p & 0x000F000F) ^ nib_bits).to(torch.bfloat16) - offset
        hi = _bf16_halves(((p >> 12) & 0x000F000F) ^ nib_bits).to(torch.bfloat16) - offset
        aj, bj = (a >> (8 * j)) & 0xFF, (b >> (8 * j)) & 0xFF
        want_lo = torch.stack([value(aj & 0x0F), value(bj & 0x0F)], dim=-1).to(torch.float32)
        want_hi = torch.stack([value(aj >> 4), value(bj >> 4)], dim=-1).to(torch.float32)
        assert torch.equal(lo.to(torch.float32), want_lo)
        assert torch.equal(hi.to(torch.float32), want_hi)
