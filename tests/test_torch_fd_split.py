"""Flash decode's split of the live range on the CPU: its launch plan puts
every live key in exactly one split, and the kernel's split-and-merge walk
(each split's online softmax over its whole 64-key tiles, then the last
cluster's merge in split order), emulated in torch, agrees with the plain
version and the JAX Pallas kernel in interpret mode. The kernel itself runs
in test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.ops.kernels.flash_decode import flash_decode_int8 as jax_fd
from onnx_quantize_tpu_torch.ops.kernels import flash_decode
from onnx_quantize_tpu_torch.ops.kernels.flash_decode import (
    KEY_TILE,
    MAX_SPLITS,
    fd_plan,
    fd_split_ranges,
)

from .test_torch_flash_decode import CASES, S, _close, _inputs

torch.set_num_threads(1)

SMS = 132  # H100 SXM


def _live(pos, S, window):
    hi = min(pos, S - 1)
    lo = 0 if window is None else max(pos - window + 1, 0)
    return lo, hi


@pytest.mark.parametrize("window", [None, 512, 100, 16, 1])
@pytest.mark.parametrize("S_", [1024, 4096])
def test_every_live_key_in_exactly_one_split(S_, window):
    """pos 0, 63, 64, 511, 512, S - 1 and the sentinel S: the plan's splits
    cover the live range once, in order, each a run of whole 64-key tiles
    from the range's first key (only the last tile of the range is short),
    and no split starts before the range or ends past it."""
    plan = fd_plan(32, 1, S_, window, SMS)
    for pos in (0, 63, 64, 511, 512, S_ - 1, S_):
        lo, hi = _live(pos, S_, window)
        ranges = fd_split_ranges(plan.splits, pos, S_, window)
        assert len(ranges) == plan.splits
        keys = [s for first, end in ranges for s in range(first, end)]
        assert keys == list(range(lo, hi + 1))
        for first, end in ranges:
            assert lo <= first and end <= hi + 1
            if end > first:
                assert (first - lo) % KEY_TILE == 0
                assert (end - lo) % KEY_TILE == 0 or end == hi + 1


@pytest.mark.parametrize("B,Hkv,S_,window,splits", [
    (32, 1, 1024, None, 6),  # a decode step's global layer: 192 blocks
    (32, 1, 1024, 512, 6),  # its local layers
    (32, 1, 4096, None, 6),
    (32, 1, 4096, 16, 1),  # one tile of live keys at most: nothing to split
    (1, 1, 4096, None, MAX_SPLITS),  # one pair: a cluster of 8
    (3, 2, 128, None, 2),
])
def test_plan_fills_the_card(B, Hkv, S_, window, splits):
    """At least one block an SM where the live range and a cluster of 8
    allow it, in whole tiles."""
    plan = fd_plan(B, Hkv, S_, window, SMS)
    assert (plan.splits, plan.pairs, plan.blocks) == (splits, B * Hkv, B * Hkv * splits)
    live = S_ if window is None else min(S_, window)
    assert plan.blocks >= min(SMS, B * Hkv * min(-(-live // KEY_TILE), MAX_SPLITS))


def _split_walk(q, k, ks, v, vs, pos, window, splits):
    """The kernel's arithmetic in float32: per (sequence, kv head) and split,
    the online softmax over the split's tiles (scores ``(q . K) * ks``, the
    running max, ``p * vs`` against V), the partial (m, l, acc); then the
    merge: factors ``exp(m_z - max m)`` (0 for an empty split), l and acc
    summed over the splits (acc in split order, as the kernel), acc / l."""
    B, Hq, D = q.shape
    S_, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    neg = -1e30
    out = torch.empty((B, Hq, D), dtype=torch.float32)
    for b in range(B):
        ranges = fd_split_ranges(splits, int(pos[b]), S_, window)
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G]
            parts = []
            for first, end in ranges:
                m = torch.full((G,), neg)
                l = torch.zeros(G)
                acc = torch.zeros((G, D))
                for s0 in range(first, end, KEY_TILE):
                    s1 = min(s0 + KEY_TILE, end)
                    sc = (qg @ k[b, s0:s1, h].float().T) * ks[b, s0:s1, h]
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.where(m <= neg / 2, 0.0, torch.exp(m - m_new))
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + (p * vs[b, s0:s1, h]) @ v[b, s0:s1, h].float()
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            num, den = torch.zeros((G, D)), torch.zeros(G)
            for m, l, acc in parts:
                f = torch.where(m <= neg / 2, 0.0, torch.exp(m - mx))
                den = den + f * l
                num = num + f[:, None] * acc
            out[b, h * G:(h + 1) * G] = num / torch.clamp(den, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("splits", [None, 1, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_split_walk_matches_plain_and_jax(case, splits):
    """The plan's splits (None) and others, uneven ones too: the merged walk
    within test_torch_flash_decode's tolerance (1e-5 of the largest output)
    of the plain version and of the JAX kernel (interpret mode); finite at
    the pos = S sentinel."""
    Hq, Hkv, D, window, pos = CASES[case]
    args = _inputs(Hq, Hkv, D, pos)
    if splits is None:
        splits = fd_plan(len(pos), Hkv, S, window, SMS).splits
        assert (splits > 1) == (window is None or window > KEY_TILE)
    targs = [torch.from_numpy(a) for a in args]
    got = _split_walk(*targs, window, splits).numpy()
    assert np.isfinite(got).all()
    _close(got, flash_decode.flash_decode_int8_reference(*targs, window=window).numpy())
    _close(got, jax_fd(*(jnp.asarray(a) for a in args), window=window, interpret=True))
