"""Int8-KV flash decode: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernels of ``onnx_quantize_tpu/ops/kernels/flash_decode.py``
(``_fd_call`` -> ``_fd_kernel`` and ``_fd_batched_call`` ->
``_fd_batched_kernel``; the batched body only coarsens the TPU grid) with
``csrc/flash_decode.cu``. One-token GQA attention read straight from the
int8 cache: ``scores = (q . K_i8) * k_scale[s]``, ``out = (p * v_scale[s]) .
V_i8``, over the live slots ``max(pos - window + 1, 0) <= s <= pos``.

What bounds it on the card: the live int8 K/V bytes (~10.5 MB per global
layer at B = 32, 640 live slots, D = 256). The blocks of a (kv head,
sequence) pair split its live range in whole 64-key tiles (:func:`fd_plan`
sets how many, so that the grid fills the SMs; :func:`fd_split_ranges` gives
each block's keys), each walking its share in shared-memory tiles that the
group's query heads share, so each live byte is read once per step. The
splits of a pair form one thread block cluster and merge their partials
through each other's shared memory, in split order, inside the same launch
(no scratch, no counters); the source holds the rest of the design.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.ops.kernels import check_launch, kernel_library, ptr, stream_ptr

__all__ = ["FdPlan", "fd_plan", "fd_split_ranges", "flash_decode_int8",
           "flash_decode_int8_reference"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0

_NEG_INF = -1e30

# Keys a block stages at a time (the kernel's kTile): a split takes whole tiles.
KEY_TILE = 64
# Splits of a live range at most: the splits of a (sequence, kv head) pair
# form one thread block cluster, and 8 is the portable cluster size.
MAX_SPLITS = 8
# The kernel's limits: a thread of its PV phase owns one 4-column word of
# every head (at most 8) for a quarter of the keys, 256 threads in a block.
MAX_HEAD_DIM = 256
MAX_GROUP = 8
# Blocks a plan aims at, per two SMs: at B = 32 on the H100 six splits (192
# blocks) beat four and eight, whose clusters of 8 blocks no longer all fit
# at once.
BLOCKS_PER_TWO_SMS = 3


@dataclasses.dataclass(frozen=True)
class FdPlan:
    """How one flash-decode call launches: ``splits`` blocks (one cluster)
    share each of the ``pairs`` (sequence, kv head) pairs' live range;
    ``blocks`` in all."""

    splits: int
    pairs: int
    blocks: int


def fd_plan(B: int, Hkv: int, S: int, window: int | None, sms: int) -> FdPlan:
    """The launch plan of ``csrc/flash_decode.cu`` for B sequences of an S-slot
    cache with Hkv KV heads on a card of ``sms`` SMs.

    A live range holds at most ``min(S, window)`` keys, so a split of more than
    that many 64-key tiles would stay empty, and a cluster holds at most 8.
    Below that, the plan takes as many splits as give the card 1.5 blocks an
    SM (one each where the range allows): at B = 32 on one KV head, S = 1024,
    6 splits (192 blocks), 1-2 tiles a block at position 640 with and without
    a 512-key window.
    """
    live = S if window is None else min(S, window)
    pairs = B * Hkv
    splits = max(1, min(-(-live // KEY_TILE), MAX_SPLITS,
                        BLOCKS_PER_TWO_SMS * sms // (2 * pairs)))
    return FdPlan(splits, pairs, pairs * splits)


def fd_split_ranges(splits: int, pos: int, S: int, window: int | None) -> list[tuple[int, int]]:
    """The kernel's key ranges ``[first, end)`` of each split for a sequence at
    position ``pos``: its live range ``[max(pos - window + 1, 0), min(pos, S -
    1)]`` cut into T tiles of 64 keys from its first key, split z taking tiles
    ``[z * T // splits, (z + 1) * T // splits)`` (empty where that is empty)."""
    hi = min(pos, S - 1)
    lo = 0 if window is None else max(pos - window + 1, 0)
    tiles = -(-max(hi - lo + 1, 0) // KEY_TILE)
    return [(lo + KEY_TILE * (z * tiles // splits),
             min(lo + KEY_TILE * ((z + 1) * tiles // splits), hi + 1)) for z in range(splits)]


def flash_decode_int8_reference(q, k_q, k_scale, v_q, v_scale, pos, *, window=None):
    """The kernel's function in plain PyTorch (einsum and softmax), float32.

    Shapes as :func:`flash_decode_int8`. The scales fold into the score
    columns and the attention weights, as in the kernel; slots past ``pos``
    and before the window are masked."""
    B, Hq, D = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    qg = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_q.to(torch.float32))
    scores = scores * k_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, :]
    slots = torch.arange(S, device=q.device)
    pos = pos.to(torch.int64)
    mask = slots[None, :] <= pos[:, None]  # (B, S)
    if window is not None:
        mask &= slots[None, :] > pos[:, None] - window
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1) * v_scale.to(torch.float32).permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v_q.to(torch.float32))
    return out.reshape(B, Hq, D)


def _check_operands(q, k_q, k_scale, v_q, v_scale, pos):
    if q.ndim != 3 or k_q.ndim != 4:
        raise ValueError("flash_decode_int8: q must be (B, Hq, D) and k/v (B, S, Hkv, D)")
    B, Hq, D = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if q.dtype != torch.float32:
        raise TypeError(f"flash_decode_int8: q must be float32, got {q.dtype}")
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise TypeError("flash_decode_int8: k and v must be int8 codes (the int4 cache "
                        "runs the scale-folded attend)")
    if tuple(k_q.shape) != (B, S, Hkv, D) or tuple(v_q.shape) != (B, S, Hkv, D):
        raise ValueError(f"flash_decode_int8: k/v {tuple(k_q.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_decode_int8: Hq={Hq} is not a multiple of Hkv={Hkv}")
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, S, Hkv):
            raise ValueError(f"flash_decode_int8: scales must be float32 {(B, S, Hkv)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"flash_decode_int8: pos must be int32 ({B},)")
    for t in (k_q, k_scale, v_q, v_scale, pos):
        if t.device != q.device:
            raise ValueError("flash_decode_int8: operands on different devices")


def flash_decode_int8(q, k_q, k_scale, v_q, v_scale, pos, *, window: int | None = None,
                      batched: bool | None = None):
    """Decode attention over the int8 KV cache.

    q: (B, Hq, D) float32, the pre-scaled query of each sequence's new token;
    k_q/v_q: (B, S, Hkv, D) int8; k_scale/v_scale: (B, S, Hkv) float32;
    pos: (B,) int32, each sequence's current position (pos = S marks an
    inactive slot: its output is finite and meaningless). Returns (B, Hq, D)
    float32. Launches the kernel on CUDA tensors; CPU tensors get the plain
    version. ``batched`` (the TPU grid choice) is accepted and changes
    nothing here.
    """
    del batched
    _check_operands(q, k_q, k_scale, v_q, v_scale, pos)
    if window is not None and window < 1:
        raise ValueError(f"flash_decode_int8: window must be None or >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_decode_int8_reference(q, k_q, k_scale, v_q, v_scale, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_int8: unsupported device {q.device}")
    B, Hq, D = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if D % 16 or D > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode_int8: the kernel takes head_dim % 16 == 0 up to "
                         f"{MAX_HEAD_DIM} and up to {MAX_GROUP} query heads a KV head, got "
                         f"head_dim {D}, {Hq // Hkv} heads")
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # the kernel reads q in 16-byte loads
    operands = [t.contiguous() for t in (k_q, k_scale, v_q, v_scale, pos)]
    if operands[0].data_ptr() % 16 or operands[2].data_ptr() % 16:
        raise ValueError("flash_decode_int8: the K/V cache must be 16-byte aligned")
    k_q, k_scale, v_q, v_scale, pos = operands
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = fd_plan(B, Hkv, S, window, sms)
    err = kernel_library().oqt_flash_decode(
        ptr(q), ptr(k_q), ptr(k_scale), ptr(v_q), ptr(v_scale), ptr(pos), ptr(out), B, S, Hkv,
        Hq // Hkv, D, 0 if window is None else int(window), plan.splits, stream_ptr(q.device),
    )
    check_launch(err, "oqt_flash_decode")
    global launches
    launches += 1
    return out
