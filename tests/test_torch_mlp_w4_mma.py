"""The fused W4 MLP's tensor-core design on the CPU: its launch plan on every
shape that chip_smoke.py and the `cuda` tests run, and the mma route's
arithmetic order emulated in torch (per-warp gate-up chunks with their own x
sums, GeGLU rounded to bf16, down partials per 16-column K step, the warps'
and clusters' sums in the plan's order) against the plain version and the
JAX Pallas kernel in interpret mode. The kernel itself runs in
test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.mlp_w4 import mlp_w4_fused as jax_fused
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import w4_dequant_matmul_plain
from onnx_quantize_tpu_torch.ops.kernels.mlp_w4 import (
    MMA_TJ,
    SMEM_LIMIT,
    mlp_w4_operands,
    mlp_w4_plain,
    mlp_w4_plan,
)

torch.set_num_threads(1)

# Shared memory of one block such that two fit an H100 SM (228 KB, 1 KB
# reserved a block): the 270M clusters of 16 then run in one wave.
TWO_PER_SM = 228 * 1024 // 2 - 1024

# (K_pad, inter, N, gs, M, x dtype) -> (route, bm, passes, cluster, blocks,
# counters, scratch elements): chip_smoke.py's 270M MLP (K = 640 padded to 768)
# at M = 32, 1 and 256 and its ragged int4 case (K = 192 padded to 256), in
# bf16 and float32; the `cuda` tests' cases (the same, 12 blocks in clusters
# of 4 at K = 128, I = 192, and 3 blocks in clusters of one at K = 64, I = 48).
PLAN_CASES = [
    ((768, 2048, 640, 128, 32, torch.bfloat16), ("mma", 32, 1, 16, 128, 16, 8 * 32 * 640)),
    ((768, 2048, 640, 128, 1, torch.bfloat16), ("mma", 16, 1, 16, 128, 16, 8 * 16 * 640)),
    ((768, 2048, 640, 128, 256, torch.bfloat16), ("mma", 32, 8, 16, 128, 128, 8 * 256 * 640)),
    ((256, 256, 192, 64, 5, torch.bfloat16), ("mma", 16, 1, 8, 16, 8, 2 * 16 * 192)),
    ((128, 192, 128, 64, 4, torch.bfloat16), ("mma", 16, 1, 4, 12, 4, 3 * 16 * 128)),
    ((64, 48, 64, 16, 3, torch.bfloat16), ("mma", 16, 1, 1, 3, 1, 3 * 16 * 64)),
    ((768, 2048, 640, 128, 32, torch.float32), ("simt", 32, 1, 1, 64, 2, 64 * 32 * 640)),
    ((768, 2048, 640, 128, 1, torch.float32), ("simt", 32, 1, 1, 64, 2, 64 * 32 * 640)),
    ((768, 2048, 640, 128, 256, torch.float32), ("simt", 32, 8, 1, 64, 2, 64 * 256 * 640)),
    ((256, 256, 192, 64, 5, torch.float32), ("simt", 32, 1, 1, 8, 2, 8 * 32 * 192)),
]


@pytest.mark.parametrize("shape,want", PLAN_CASES,
                         ids=[f"K{s[0]}-I{s[1]}-N{s[2]}-g{s[3]}-M{s[4]}-{str(s[5])[6:]}"
                              for s, _ in PLAN_CASES])
def test_plan_on_every_shape_the_card_runs(shape, want):
    K_pad, inter, N, gs, M, dtype = shape
    plan = mlp_w4_plan(M, K_pad, inter, N, gs, gs, dtype)
    got = (plan.route, plan.bm, plan.passes, plan.cluster, plan.blocks, plan.tiles,
           plan.scratch_elems)
    assert got == want
    assert plan.blocks * plan.tj == inter and plan.passes * plan.bm >= M
    if plan.route == "mma":
        assert plan.tj == MMA_TJ and plan.warps == 8
        assert plan.blocks % plan.cluster == 0 and N % (8 * plan.cluster) == 0
        assert plan.splits == plan.blocks // plan.cluster
        assert plan.smem_bytes <= SMEM_LIMIT
    else:
        assert plan.tj == 32 and plan.cluster == 1 and plan.splits == plan.blocks


def test_270m_plan_fits_two_blocks_an_sm():
    for M in (1, 32, 256):
        plan = mlp_w4_plan(M, 768, 2048, 640, 128, 128, torch.bfloat16)
        assert plan.smem_bytes <= TWO_PER_SM


@pytest.mark.parametrize("gs,pairs,inter,N", [(8, 2, 256, 128), (64, 2, 200, 128),
                                               (64, 2, 256, 100), (16, 17, 256, 128)])
def test_plan_sends_other_shapes_to_simt(gs, pairs, inter, N):
    """A group size, intermediate width, N or number of gate-up group pairs
    (one x mbarrier each) the tensor-core route does not take keeps the
    CUDA-core kernel."""
    assert mlp_w4_plan(4, 2 * pairs * gs, inter, N, gs, gs, torch.bfloat16).route == "simt"


def _nibbles(data: torch.Tensor, signed: bool) -> torch.Tensor:
    """(rows, cols) packed uint8 -> (2, rows, cols) float32: low, high."""
    w = data.to(torch.int16)
    nib = torch.stack([w & 0x0F, w >> 4])
    if signed:
        nib = torch.where(nib > 7, nib - 16, nib)
    return nib.to(torch.float32)


def _mma_emulation(x2d, wg, sg, zg, wd, sd, zd, *, gs_g, gs_d, signed_g, signed_d, plan):
    """The mma route's arithmetic in float32, in its order. Returns (h, y):
    h (M, 2I) float32 before GeGLU and y (M, N).

    Gate-up: each warp (one of two K halves: the even or odd slices of each
    pair) walks its slices pair by pair (at bm = 16 alternating two
    accumulator sets), each slice carrying its own x sums; at the pair's end
    it folds (d - xsum * zp) * s of both groups; h sums the halves in order. act = bf16(gelu_tanh(h_gate) *
    h_up). Down: in each cluster, K step kk is block kk's 16 act columns
    against its 16 packed down rows (one nibble half), folded with its group's
    scale and zero point; each of the 8 warps sums its K steps in order,
    the block sums the warps in order, and the cluster partials are summed in
    cluster order."""
    M, K_pad = x2d.shape
    inter, N = wg.shape[1] // 2, wd.shape[1]
    xf = x2d.to(torch.float32)
    ng, nd = _nibbles(wg, signed_g), _nibbles(wd, signed_d)
    spp, pairs = gs_g // 16, K_pad // (2 * gs_g)
    sets = 2 if plan.bm == 16 else 1  # gate-up accumulator sets (alternate slices)
    ksplit, kparts = 2, 8
    cs = plan.cluster
    h_all = torch.zeros((M, 2 * inter))
    y = torch.zeros((M, N))
    for p_ in range(plan.passes):
        rows = slice(p_ * plan.bm, min(M, (p_ + 1) * plan.bm))
        x = xf[rows]
        h = torch.zeros((x.shape[0], 2 * inter))
        for kh in range(ksplit):
            acc = torch.zeros_like(h)
            for pp in range(pairs):
                d = torch.zeros((sets, 2) + h.shape)  # (set, low/high, M, 2I)
                xs = torch.zeros((sets, 2, x.shape[0], 1))
                for idx, c in enumerate(range(pp * spp + kh, (pp + 1) * spp, ksplit)):
                    s_ = idx % sets
                    col = pp * gs_g + 16 * c  # the low nibbles' x columns; the high's + gs
                    for half in (0, 1):
                        xc = x[:, col + half * gs_g:col + half * gs_g + 16]
                        d[s_, half] += xc @ ng[half, 16 * c:16 * c + 16]
                        xs[s_, half] += xc.sum(dim=1, keepdim=True)
                dd, xx = (d[0] + d[1], xs[0] + xs[1]) if sets == 2 else (d[0], xs[0])
                acc += sum((dd[hf] - xx[hf] * zg[pp, hf]) * sg[pp, hf] for hf in (0, 1))
            h = h + acc
        h_all[rows] = h
        act = torch.nn.functional.gelu(h[:, :inter], approximate="tanh") * h[:, inter:]
        act = act.to(torch.bfloat16).to(torch.float32)
        out = torch.zeros((x.shape[0], N))
        for cid in range(plan.blocks // cs):
            piece = torch.zeros_like(out)
            for dpart in range(kparts):
                acc2 = torch.zeros_like(out)
                for kk in range(dpart * cs // kparts, (dpart + 1) * cs // kparts):
                    jb = (cid * cs + kk) * 16
                    gd = jb // gs_d
                    drow = (gd >> 1) * gs_d + jb % gs_d
                    a = act[:, jb:jb + 16]
                    dk = a @ nd[gd & 1, drow:drow + 16]
                    acc2 += (dk - a.sum(dim=1, keepdim=True) * zd[gd >> 1, gd & 1]) \
                        * sd[gd >> 1, gd & 1]
                piece = piece + acc2
            out = out + piece
        y[rows] = out
    return h_all, y


def _pair(rng, K, inter, gs, dtype):
    def qt(w):
        q, s, z = jax_rtn(w, dtype, JStrategy.GROUP, gs, dtype.is_signed, False)
        return jax_make_qtensor(q, s, z, quant_type=dtype, strategy=JStrategy.GROUP,
                                group_size=gs, symmetric=dtype.is_signed, reduce_range=False)

    wg = (0.1 * rng.standard_normal((K, 2 * inter))).astype(np.float32)
    wd = (0.1 * rng.standard_normal((inter, K))).astype(np.float32)
    return qt(wg), qt(wd)


# (K, inter, gs, dtype, M): the cases of tests/test_torch_mlp_w4.py (JAX's
# fused-vs-oracle cases, the ragged gate-up group K = 192 and the ragged
# down K, inter = 192), two passes of 32 rows (M = 40), and clusters of one
# with g16 (one slice a pair).
EMU_CASES = ([(128, 256, 64, dt, M) for dt in (JQuantType.QUInt4, JQuantType.QInt4)
              for M in (1, 8, 32)]
             + [(192, 256, 64, JQuantType.QUInt4, 4), (128, 192, 64, JQuantType.QUInt4, 4),
                (128, 256, 64, JQuantType.QInt4, 40), (64, 48, 16, JQuantType.QInt4, 3)])


@pytest.mark.parametrize("K,inter,gs,dtype,M", EMU_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_mma_order_matches_plain_and_jax(K, inter, gs, dtype, M):
    """On bf16 x: h in the route's order within 1e-5 of max|h| of the plain
    version's (float32 sums in another order); y within 1e-2 of max|y| of the
    plain version and of the JAX kernel in interpret mode (act rounds to bf16
    between the products, and an h one ulp apart can round the other way: the
    card's bar). The fixed order gives the same bits twice."""
    rng = np.random.default_rng(3)
    jgu, jdn = _pair(rng, K, inter, gs, dtype)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tree = from_jax_params({"gu": jgu, "dn": jdn}, device="cpu")
    ops, kw = mlp_w4_operands(xb, tree["gu"], tree["dn"])
    plan = mlp_w4_plan(M, ops[0].shape[1], inter, K, kw["gs_g"], kw["gs_d"], torch.bfloat16)
    assert plan.route == "mma"
    h, y = _mma_emulation(*ops, **kw, plan=plan)
    h2, y2 = _mma_emulation(*ops, **kw, plan=plan)
    assert torch.equal(h, h2) and torch.equal(y, y2)
    x2d, wg, sg, zg = ops[:4]
    h_plain = w4_dequant_matmul_plain(x2d, wg, sg, zg, gs=kw["gs_g"], signed=kw["signed_g"])
    np.testing.assert_allclose(h.numpy(), h_plain.numpy(), rtol=0,
                               atol=1e-5 * h_plain.abs().max().item())
    plain = mlp_w4_plain(*ops, **kw).numpy()
    want = np.asarray(jax_fused(jnp.asarray(x, jnp.bfloat16), jgu, jdn, interpret=True))
    assert y.shape == (M, K)
    np.testing.assert_allclose(y.numpy(), plain, rtol=0, atol=1e-2 * np.abs(plain).max())
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-2 * np.abs(want).max())
