"""Blockwise causal attention: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/flash_attention.py``
(``_fa_call`` -> ``_fa_kernel``) with ``csrc/flash_attention.cu``: the
full-sequence attention of a prefill or a perplexity window, with online
softmax, the causal mask and Gemma-3's sliding window from index arithmetic,
and GQA by index, never materializing the (T, S) scores.

What bounds it on the card: operations (~82 GFLOP of attention per
2048-token window of Gemma-3-270M). bfloat16 runs on the tensor cores
(``mma.sync`` m16n8k16): a block takes 16 query rows of the query heads of
one GQA group, so each staged K/V tile serves all of them, and its warps
split the live key tiles, merging in shared memory at the end. float32
keeps the CUDA-core kernel of the first port. :func:`fa_plan` chooses the
route, the block and the split; the source note in the ``.cu`` file gives
the design. The reference's ``causal=False`` still applies the causal mask
inside every block, so the port's attention is always causal and takes no
such flag.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from onnx_quantize_tpu_torch.ops.kernels import check_launch, kernel_library, ptr, stream_ptr

__all__ = ["FaPlan", "fa_plan", "mma_plan", "simt_plan", "fa_key_range", "mma_smem_bytes",
           "flash_attention", "flash_attention_reference", "launch"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0
# The same launches by route ("mma": bf16 tensor cores, "simt": CUDA cores).
route_launches = {"mma": 0, "simt": 0}

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations

# mma route: query rows a block (one m16 tile a warp), keys a warp takes
# from each stage (four n8 tiles), warps a block (256 threads keep up to 255
# registers each: D = 256 holds a 16 x 256 float32 accumulator a warp).
MMA_ROWS = 16
KEY_TILE = 32
MAX_WARPS = 8
# Stages of the mma route's K/V ring: the next lands during this one's mmas.
RING_STAGES = 2
# simt route (float32): T and S tile of the CUDA-core kernel, its threads.
SIMT_TILE = 64
SIMT_THREADS = 256
# Shared memory a block may use on the H100 (227 KB).
SMEM_LIMIT = 232_448
# Bytes of one cp.async copy: the mma route stages rows in such chunks.
CP_ASYNC_BYTES = 16


@dataclasses.dataclass(frozen=True)
class FaPlan:
    """How one flash-attention call launches. ``route`` "mma" (bf16 on the
    tensor cores) or "simt" (float32 on the CUDA cores). A block covers
    ``rows`` query rows (T tiles in reverse order on the mma route) of
    ``heads`` query heads of one GQA group, and runs ``heads * key_splits``
    warps: warp (head, split) takes every ``key_splits``-th slice of
    ``key_tile`` keys of the block's live range. K/V stages of ``key_splits
    * key_tile`` keys sit in a ring of ``RING_STAGES``; ``grid`` is (T
    tiles, head groups, sequences)."""

    route: str
    rows: int
    heads: int
    key_splits: int
    key_tile: int
    grid: tuple[int, int, int]
    smem_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.heads * self.key_splits if self.route == "mma" else SIMT_THREADS

    def block_rows(self, bx: int) -> int:
        """First query row of the blocks at ``blockIdx.x == bx``."""
        if self.route == "mma":
            return (self.grid[0] - 1 - bx) * self.rows  # the longest causal tiles first
        return bx * self.rows


def mma_smem_bytes(D: int, heads: int, key_splits: int) -> int:
    """The mma route's shared memory (``csrc/flash_attention.cu``'s
    ``mma_smem_bytes``): the Q tile, then the K/V ring or the float32 merge
    tile of splits 1.., whichever is larger, then each warp's row max and
    sum. A staged bf16 row is D + 8 elements (16 bytes of padding)."""
    ring = RING_STAGES * key_splits * KEY_TILE * 2 * (D + 8) * 2
    merge = (key_splits - 1) * heads * MMA_ROWS * (D + 8) * 4
    return heads * MMA_ROWS * (D + 8) * 2 + max(ring, merge) + 2 * key_splits * heads * MMA_ROWS * 4


def fa_key_range(t0: int, rows: int, T: int, S: int, window: int | None) -> tuple[int, int]:
    """(first, last) key a block of query rows ``t0 .. t0 + rows - 1`` walks:
    the window's lower bound and the causal upper bound (last < first: none)."""
    t_last = min(t0 + rows, T) - 1
    return (max(t0 - window + 1, 0) if window else 0), min(t_last, S - 1)


def mma_plan(B: int, T: int, Hq: int, D: int, heads: int, key_splits: int) -> FaPlan:
    """The mma route with ``heads`` query heads and ``key_splits`` key splits
    a block."""
    return FaPlan("mma", MMA_ROWS, heads, key_splits, KEY_TILE,
                  (-(-T // MMA_ROWS), Hq // heads, B), mma_smem_bytes(D, heads, key_splits))


def simt_plan(B: int, T: int, Hq: int, D: int) -> FaPlan:
    """The CUDA-core route (float32): one block per (64-row T tile, query
    head, sequence); rows padded by one element."""
    smem = 3 * SIMT_TILE * (D + 1) * 4 + SIMT_TILE * (SIMT_TILE + 16) * 4
    return FaPlan("simt", SIMT_TILE, 1, 1, SIMT_TILE, (-(-T // SIMT_TILE), Hq, B), smem)


def fa_plan(B: int, T: int, S: int, Hq: int, Hkv: int, D: int, window: int | None,
            dtype: torch.dtype = torch.bfloat16) -> FaPlan:
    """The launch plan of ``csrc/flash_attention.cu`` for q (B, T, Hq, D) and
    k/v (B, S, Hkv, D) of ``dtype``.

    bfloat16 takes the mma route. A block takes the largest divisor of the
    GQA group up to 4 as its heads (Gemma-3-270M: all 4 on its one KV head),
    so that a split of the keys still fits in 8 warps, and as many key splits
    as fill 8 warps while a stage of them does not outrun the live keys of a
    row tile and the ring fits in shared memory. At a 2048-token window of
    the 270M model: 128 blocks of 8 warps (4 heads x 2 splits), 169,984
    bytes. float32 takes the simt route.
    """
    if dtype != torch.bfloat16:
        return simt_plan(B, T, Hq, D)
    group = Hq // Hkv
    heads = max(h for h in (1, 2, 4) if group % h == 0)
    live = min(S, T, window + MMA_ROWS - 1 if window else T)  # most keys a row tile sees
    splits = MAX_WARPS // heads
    while splits > 1 and ((splits // 2) * KEY_TILE >= live
                          or mma_smem_bytes(D, heads, splits) > SMEM_LIMIT):
        splits //= 2
    return mma_plan(B, T, Hq, D, heads, splits)


def flash_attention_reference(q, k, v, *, sliding_window: int | None = None):
    """The kernel's function in plain PyTorch (einsum and softmax).

    Scores in float32 from q's and k's values; p rounded to v's dtype before
    the PV product while the row sum uses the unrounded p; the output is
    ``acc / max(l, 1e-30)`` in q's dtype. Shapes as :func:`flash_attention`.
    """
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, T, Hkv, Hq // Hkv, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= rows
    if sliding_window is not None:
        mask &= cols > rows - sliding_window
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = acc / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def _check_operands(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q must be (B, T, Hq, D) and k/v (B, S, Hkv, D)")
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")


def _kernel_view(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` itself when the kernel can read its strides (unit last stride,
    the others and the base on ``align`` bytes), else a fresh contiguous copy
    (``contiguous()`` would return an already contiguous view as it is)."""
    elems = align // t.element_size()
    if (t.stride(3) == 1 and all(s % elems == 0 for s in t.stride()[:3])
            and t.data_ptr() % align == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, sliding_window: int | None = None):
    """Blockwise causal attention. q: (B, T, Hq, D); k/v: (B, S, Hkv, D).

    Positions run from 0 in both (the prefill layout): row t sees keys
    ``s <= t`` and, with ``sliding_window``, ``s > t - sliding_window``.
    q is pre-scaled. Returns (B, T, Hq, D) in q's dtype. Launches the kernel
    on CUDA tensors (the route of :func:`fa_plan`); CPU tensors get the plain
    version.
    """
    _check_operands(q, k, v)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention: sliding_window must be None or >= 1, "
                         f"got {sliding_window}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} is not one of {_HEAD_DIMS}")
    return launch(q, k, v, sliding_window, fa_plan(B, T, S, Hq, Hkv, D, sliding_window, q.dtype))


def launch(q, k, v, sliding_window: int | None, plan: FaPlan) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands by ``plan`` (the wrapper's
    :func:`fa_plan`, or another key split to compare with it). The mma route
    takes bfloat16, the simt route float32."""
    if (plan.route == "mma") != (q.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention: the {plan.route} route does not take {q.dtype}")
    align = CP_ASYNC_BYTES if plan.route == "mma" else 4
    q, k, v = (_kernel_view(t, align) for t in (q, k, v))
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    if B * T == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = kernel_library().oqt_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv, D,
        0 if sliding_window is None else int(sliding_window), strides,
        int(plan.route == "mma"), plan.heads, plan.key_splits, plan.smem_bytes,
        stream_ptr(q.device),
    )
    check_launch(err, "oqt_flash_attention")
    global launches
    launches += 1
    route_launches[plan.route] += 1
    return out
