"""The flash-attention kernel's tensor-core design on the CPU: its launch plan
(which block and warp owns each row and head, which keys each walks, its
shared memory), and its tile walk emulated in torch (16-row warp slices,
32-key slices split across warps, edge-only masking, p rounded to bf16
against the running max, l from the unrounded p, the splits merged at the
end), held against the plain version and the JAX Pallas kernel in interpret
mode. The kernel itself runs in test_torch_cuda.py and chip_smoke.py."""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.ops.kernels.flash_attention import flash_attention as jax_fa
from onnx_quantize_tpu_torch.ops.kernels.flash_attention import (
    MAX_WARPS,
    SMEM_LIMIT,
    fa_key_range,
    fa_plan,
    flash_attention_reference,
    mma_plan,
    mma_smem_bytes,
)

torch.set_num_threads(1)

NEG_INF = -1e30

# (B, T, Hq, Hkv, D, window): a 2048-token window of Gemma-3-270M (local and
# global layers), a 512-token prefill, and the ragged cases of the cuda tests.
PLAN_CASES = [
    (1, 2048, 4, 1, 256, 512),
    (1, 2048, 4, 1, 256, None),
    (1, 512, 4, 1, 256, 512),
    (2, 48, 2, 2, 128, None),
    (1, 130, 4, 1, 256, 40),
    (2, 100, 4, 2, 64, 7),
    (1, 256, 4, 1, 256, None),
    (1, 70, 2, 1, 32, 64),
    (2, 100, 8, 1, 128, 16),
]


def _case_id(c):
    return f"B{c[0]}-T{c[1]}-{c[2]}on{c[3]}-D{c[4]}-w{c[5]}"


def _live(row: int, S: int, window):
    """Keys that query row ``row`` attends to, from the mask's definition."""
    first = max(row - window + 1, 0) if window else 0
    return range(first, min(row, S - 1) + 1)


def _warp_slices(plan, t0: int, T: int, S: int, window):
    """{split: key slices that split computes} for the block at row ``t0``,
    as the kernel walks them (a slice starting past the range is skipped)."""
    s_lo, s_hi = fa_key_range(t0, plan.rows, T, S, window)
    stage = plan.key_splits * plan.key_tile
    n_stages = (s_hi - s_lo + stage) // stage if s_hi >= s_lo else 0
    slices = {z: [] for z in range(plan.key_splits)}
    for s in range(n_stages):
        for z in range(plan.key_splits):
            key0 = s_lo + s * stage + z * plan.key_tile
            if key0 <= s_hi:
                slices[z].append(key0)
    return slices, n_stages


@pytest.mark.parametrize("case", PLAN_CASES, ids=_case_id)
def test_plan_owns_every_row_and_walks_every_live_key(case):
    """Every (row, query head) of every sequence is written by exactly one
    block and warp (split 0 of its head); every live key of every row lies in
    its block's key range and in exactly one computed slice; the range is
    exactly the block's causal and window bounds, no computed slice lies past
    it and the last stage starts inside it; shared memory fits the card."""
    B, T, Hq, Hkv, D, window = case
    S, group = T, Hq // Hkv
    plan = fa_plan(B, T, S, Hq, Hkv, D, window)
    assert plan.route == "mma" and plan.rows == 16 and plan.key_tile == 32
    assert group % plan.heads == 0 and plan.heads * plan.key_splits <= MAX_WARPS
    assert plan.threads <= 256
    assert plan.smem_bytes == mma_smem_bytes(D, plan.heads, plan.key_splits)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.grid == (-(-T // 16), Hq // plan.heads, B)

    owner = np.zeros((B, T, Hq), dtype=np.int64)
    stage = plan.key_splits * plan.key_tile
    for bz in range(plan.grid[2]):
        for by in range(plan.grid[1]):
            h0 = by * plan.heads
            assert h0 // group == (h0 + plan.heads - 1) // group  # one KV head a block
            for bx in range(plan.grid[0]):
                t0 = plan.block_rows(bx)
                rows = range(t0, min(t0 + plan.rows, T))
                owner[bz, rows.start:rows.stop, h0:h0 + plan.heads] += 1
                s_lo, s_hi = fa_key_range(t0, plan.rows, T, S, window)
                live = [set(_live(r, S, window)) for r in rows]
                every = set().union(*live)
                assert (s_lo, s_hi) == (min(every), max(every))
                slices, n_stages = _warp_slices(plan, t0, T, S, window)
                assert (n_stages - 1) * stage <= s_hi - s_lo  # no whole stage past it
                walked = [k for z in slices for key0 in slices[z]
                          for k in range(key0, key0 + plan.key_tile)]
                assert all(s_lo <= key0 <= s_hi for z in slices for key0 in slices[z])
                in_range = [k for k in walked if k <= s_hi]
                assert sorted(in_range) == list(range(s_lo, s_hi + 1))  # each key once
    assert (owner == 1).all()
    # The longest causal tiles launch first.
    assert plan.block_rows(0) == (plan.grid[0] - 1) * 16


def test_plan_at_the_window_shapes():
    """A 2048-token window of the 270M model: every query head of the one KV
    head in a block, two key splits (8 warps), the 2-stage ring in shared
    memory."""
    for window in (512, None):
        plan = fa_plan(1, 2048, 2048, 4, 1, 256, window)
        assert (plan.heads, plan.key_splits, plan.grid, plan.smem_bytes) == (
            4, 2, (128, 1, 1), 169_984)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_plan_fits_shared_memory_and_warps(D, group):
    plan = fa_plan(1, 4096, 4096, 2 * group, 2, D, None)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.heads * plan.key_splits <= MAX_WARPS
    assert plan.key_splits >= 1 and group % plan.heads == 0


def test_plan_routes_by_dtype():
    assert fa_plan(2, 48, 48, 2, 2, 128, None, torch.float32).route == "simt"
    assert fa_plan(2, 48, 48, 2, 2, 128, None, torch.bfloat16).route == "mma"
    simt = fa_plan(1, 130, 130, 4, 1, 256, 40, torch.float32)
    assert (simt.rows, simt.heads, simt.grid, simt.threads) == (64, 1, (3, 4, 1), 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_refuses_the_other_dtypes_route(dtype):
    """The mma route takes only bfloat16 and the simt route only float32; a
    plan of the other route raises before anything launches."""
    from onnx_quantize_tpu_torch.ops.kernels.flash_attention import launch, simt_plan

    q = torch.zeros(1, 16, 4, 64, dtype=dtype)
    k = torch.zeros(1, 16, 1, 64, dtype=dtype)
    plan = simt_plan(1, 16, 4, 64) if dtype == torch.bfloat16 else mma_plan(1, 16, 4, 64, 4, 1)
    with pytest.raises(ValueError, match="route does not take"):
        launch(q, k, k, None, plan)


def _edge(key0: int, key_tile: int, t0: int, rows: int, S: int, window) -> bool:
    """The kernel's test for a slice that needs the element mask."""
    return (key0 + key_tile - 1 > t0 or key0 + key_tile > S
            or (bool(window) and key0 <= t0 + rows - 1 - window))


def _emulate(q, k, v, window, plan, bf16: bool):
    """The mma route's walk in torch. q (B, T, Hq, D), k/v (B, S, Hkv, D)
    float32 (bf16-representable when ``bf16``). With ``bf16`` p is rounded to
    bf16 before the PV product and the output to bf16; otherwise all float32."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    rows_n, kt = plan.rows, plan.key_tile
    out = torch.zeros_like(q)
    for b in range(B):
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                t0 = plan.block_rows(bx)
                s_lo, s_hi = fa_key_range(t0, rows_n, T, S, window)
                slices, _ = _warp_slices(plan, t0, T, S, window)
                row_idx = torch.arange(t0, t0 + rows_n)
                for wh in range(plan.heads):
                    h = by * plan.heads + wh
                    hk = h // group
                    qt = torch.zeros(rows_n, D)
                    n = min(rows_n, T - t0)
                    qt[:n] = q[b, t0:t0 + n, h]
                    parts = []
                    for z in range(plan.key_splits):
                        m = torch.full((rows_n,), NEG_INF)
                        l = torch.zeros(rows_n)
                        acc = torch.zeros(rows_n, D)
                        for key0 in slices[z]:
                            keys = torch.arange(key0, key0 + kt)
                            staged = keys <= s_hi  # zero past the live range
                            kk = torch.zeros(kt, D)
                            vv = torch.zeros(kt, D)
                            kk[staged] = k[b, keys[staged], hk]
                            vv[staged] = v[b, keys[staged], hk]
                            sc = qt @ kk.T
                            r, c = row_idx[:, None], keys[None, :]
                            ok = (c <= r) & (c < S)
                            if window:
                                ok &= c > r - window
                            if _edge(key0, kt, t0, rows_n, S, window):
                                sc = torch.where(ok, sc, NEG_INF)
                            else:
                                assert ok.all()  # an interior slice needs no compare
                            m_new = torch.maximum(m, sc.max(dim=1).values)
                            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
                            alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
                            p = torch.exp(sc - m_safe[:, None])
                            l = l * alpha + p.sum(dim=1)
                            if bf16:
                                p = p.to(torch.bfloat16).to(torch.float32)
                            acc = acc * alpha[:, None] + p @ vv
                            m = m_new
                        parts.append((m, l, acc))
                    m_all = torch.stack([p_[0] for p_ in parts]).max(dim=0).values
                    m_all = torch.where(m_all <= NEG_INF / 2, 0.0, m_all)
                    acc = torch.zeros(rows_n, D)
                    l = torch.zeros(rows_n)
                    for m_z, l_z, acc_z in parts:
                        f = torch.where(m_z <= NEG_INF / 2, 0.0, torch.exp(m_z - m_all))
                        acc += f[:, None] * acc_z
                        l += f * l_z
                    res = acc / l.clamp(min=1e-30)[:, None]
                    out[b, t0:t0 + n, h] = res[:n]
    return out.to(torch.bfloat16).to(torch.float32) if bf16 else out


# Float32 arithmetic: the walk forms the plain version's float32 scores and
# online softmax of them, summed in another order: 1e-5 of max|out|.
# bfloat16: the walk rounds p = exp(s - running max) to bf16 per slice, the
# plain version exp(s - row max) and the JAX kernel exp(s - its running
# max) per block, and the bf16 output rounds once more: a few bf16 ulps
# (2^-8 relative each) of the largest output, so 1e-2 of max|out|.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

# (B, T, Hq, Hkv, D, JAX block): G = 4 at D = 256, T = 256 in whole tiles and
# T = 120 ragged against the 16-row tiles and the 32-key slices.
WALK_SHAPES = {"T256": (1, 256, 4, 1, 256, 128), "T120_ragged": (2, 120, 8, 2, 256, 40)}


def _inputs(B, T, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, Hq, D)) / np.sqrt(D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (q, k, v))
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_out(shape: str, window, dtype: str) -> np.ndarray:
    B, T, Hq, Hkv, D, blk = WALK_SHAPES[shape]
    q, k, v = _inputs(B, T, Hq, Hkv, D, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = jax_fa(*(jnp.asarray(a, jdt) for a in (q, k, v)), sliding_window=window, bt=blk,
                 bs=blk, interpret=True)
    return np.asarray(out).astype(np.float32)


def _plans(B, T, Hq, Hkv, D, window):
    """The plan's own split, no split, and four splits of two heads."""
    return {"plan": fa_plan(B, T, T, Hq, Hkv, D, window),
            "splits1": mma_plan(B, T, Hq, D, 4, 1),
            "splits4": mma_plan(B, T, Hq, D, 2, 4)}


@pytest.mark.parametrize("plan_name", ["plan", "splits1", "splits4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [64, None], ids=["w64", "global"])
@pytest.mark.parametrize("shape", list(WALK_SHAPES))
def test_emulated_walk_matches_plain_and_jax(shape, window, dtype, plan_name):
    B, T, Hq, Hkv, D, _ = WALK_SHAPES[shape]
    plan = _plans(B, T, Hq, Hkv, D, window)[plan_name]
    q, k, v = _inputs(B, T, Hq, Hkv, D, dtype)
    got = _emulate(*(torch.from_numpy(a) for a in (q, k, v)), window, plan,
                   bf16=dtype == "bfloat16")
    tdt = getattr(torch, dtype)
    want = flash_attention_reference(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                     sliding_window=window).to(torch.float32)
    tol = REL_TOL[dtype] * want.abs().max().item()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol
    jax_want = _jax_out(shape, window, dtype)
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=0,
                               atol=REL_TOL[dtype] * np.abs(jax_want).max())


@pytest.mark.parametrize("align", [16, 4], ids=["mma", "simt"])
def test_kernel_view_copies_what_the_kernel_cannot_read(align):
    """An operand one bf16 element off an aligned base, or with a row stride
    off the kernel's granule, becomes a fresh aligned copy with the same
    values (``contiguous()`` would return such a contiguous view as it is);
    an operand the kernel can read passes through untouched."""
    from onnx_quantize_tpu_torch.ops.kernels.flash_attention import _kernel_view

    x = torch.randn(2, 8, 2, 32).to(torch.bfloat16)
    assert _kernel_view(x, align) is x
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    buf[1:] = x.reshape(-1)
    odd = buf[1:].view(x.shape)
    assert odd.is_contiguous() and odd.contiguous().data_ptr() % align != 0
    got = _kernel_view(odd, align)
    assert got.data_ptr() % align == 0 and got.is_contiguous() and torch.equal(got, x)
    wide = torch.randn(2, 8, 2, 33).to(torch.bfloat16)[..., :32]  # rows of 33 elements
    got = _kernel_view(wide, align)
    assert got is not wide and torch.equal(got, wide) and got.stride()[:3] == (512, 64, 32)
