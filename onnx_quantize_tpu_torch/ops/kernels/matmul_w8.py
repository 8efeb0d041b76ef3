"""W8 (int8/uint8) dequant-matmul: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/matmul_w8.py``
(``_w8_call`` -> ``_w8_kernel``) with ``csrc/matmul_w8.cu``. It computes
``x @ dequant(W)`` in float32 with one scale row per K tile: a tensor or
channel scale is one tile spanning K, a group scale one tile per group. The
affine goes on each tile's partial dot (``(x . w - sum(x) * zp) * s``); the
symmetric path, whose zero point is 0, skips the zp term.

What bounds it on the card: the Gemma-3-270M lm_head (640 x 262144, int8 per
channel) reads 168 MB of weights per decode step (M = 32, ~60 us at
3.35 TB/s with its float32 logits); over a 2048-token scoring window its
0.69 TFLOP of bf16 products and 2.15 GB of float32 logits take ~0.69 ms.
bf16 x runs on the tensor cores (``mma.sync`` m16n8k16, each byte made an
exact bf16 through the float 2^23 + b), and where the output tiles number
fewer than the SMs K is split, the partials summed in a fixed order inside
the same launch. float32 x, a K tile or N that is not a multiple of 16, or an
operand off a 16-byte boundary keeps the CUDA-core kernel. :func:`w8_plan`
chooses the route, the tile and the split; the source note in
``csrc/matmul_w8.cu`` gives the design. ``PERF.md`` holds its times beside
the plain version's and the yardsticks'.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import (
    check_launch,
    four_columns_fill,
    kernel_library,
    pad_to_multiple,
    ptr,
    register_kernel,
    split_scratch,
    stream_ptr,
)
from onnx_quantize_tpu_torch.ops.reference import qdq_epilogue, qdq_prologue

__all__ = ["W8Plan", "w8_plan", "w8_matmul", "w8_dequant_matmul_plain", "w8_dequant_matmul",
           "w8_operands", "w8_scale_rows"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version. ``route_launches``
# splits them by the route the launch plan chose.
launches = 0
route_launches = {"mma": 0, "simt": 0}

# K rows of a bf16 mma slice (m16n8k16): the K split's granularity, and what
# a K tile must be a multiple of on the mma route.
MMA_SLICE = 16
# Bytes of one cp.async copy: the mma route stages x and weight rows in such
# chunks, so it needs 16-byte-aligned operands and N % 16 == 0.
CP_ASYNC_BYTES = 16
# The x-stationary form of the mma route: 256-column output tiles, a ring of
# three 64-row weight stages (272-byte rows) beside a resident x tile of
# bm x (K + 8) bf16, within a block's 227 KB of shared memory.
XS_BN = 256
XS_RING_BYTES = 3 * 64 * (XS_BN + 16)
SMEM_BYTES = 227 * 1024


@dataclasses.dataclass(frozen=True)
class W8Plan:
    """How one W8 call launches: ``route`` "mma" (bf16 x on the tensor cores)
    or "simt" (float32 FMAs on the CUDA cores); a block covers ``bm`` rows of
    M and ``bn`` columns; ``splits`` blocks share each (bm, bn) tile along K,
    each walking ``split_slices`` slices of 16 rows (mma route; 0 for simt);
    ``blocks`` in all."""

    route: str
    bm: int
    bn: int
    splits: int
    split_slices: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.blocks // self.splits

    @property
    def scratch_elems(self) -> int:
        """4-byte elements of K-split scratch: a partial tile a block."""
        return self.blocks * self.bm * self.bn


def _tiles(M: int, N: int, bm: int, bn: int) -> int:
    return -(-M // bm) * -(-N // bn)


def w8_plan(M: int, K: int, N: int, bk: int, x_dtype: torch.dtype, sms: int) -> W8Plan:
    """The launch plan of ``csrc/matmul_w8.cu`` for x (M, K) of ``x_dtype``
    against (K, N) int8/uint8 weights in K tiles of ``bk`` rows on a card of
    ``sms`` SMs.

    bf16 x with ``bk % 16 == 0`` (so K too) and ``N % 16 == 0`` (the weight
    rows move in 16-byte ``cp.async`` chunks) takes the mma route. Above
    M = 64, a single K tile whose x tile of 128 rows (64 where K is too long)
    by all of K fits in shared memory beside the weight ring, with at least
    four 256-column output tiles an SM, takes the x-stationary form (``bn``
    256: one block an SM walks a range of tiles, only the weights streaming;
    the lm_head over a scoring window). Otherwise the tiles are 16, 32 or 64
    rows by 128 columns; while they number fewer than the SMs, K is split
    into ranges of whole 16-row slices, as many as fill the SMs (the lm_head
    never splits: 2,048 tiles at M = 32). Anything else takes the simt
    route.
    """
    if x_dtype == torch.bfloat16 and bk % MMA_SLICE == 0 and N % CP_ASYNC_BYTES == 0:
        if M > 64 and bk == K:
            bm = _x_stationary_rows(K)
            if bm and _tiles(M, N, bm, XS_BN) >= 4 * sms:
                return W8Plan("mma", bm, XS_BN, 1, K // MMA_SLICE, _tiles(M, N, bm, XS_BN))
        bm, bn = (16 if M <= 16 else 32 if M <= 32 else 64), 128
        tiles = _tiles(M, N, bm, bn)
        slices = K // MMA_SLICE
        per = slices
        if tiles < sms:
            per = max(1, slices // -(-sms // tiles))
        splits = -(-slices // per)
        return W8Plan("mma", bm, bn, splits, per, tiles * splits)
    return _simt_plan(M, N, sms)


def _x_stationary_rows(K: int) -> int:
    """Rows of the largest resident x tile that fits beside the weight ring
    (0 if none does)."""
    for bm in (128, 64):
        if XS_RING_BYTES + bm * (K + 8) * 2 <= SMEM_BYTES:
            return bm
    return 0


def _simt_plan(M: int, N: int, sms: int) -> W8Plan:
    """32- or 64-row tiles; four columns a thread only when N % 4 == 0 and the
    wide blocks still fill every SM."""
    bm = 32 if M <= 32 else 64
    bn = 128 if four_columns_fill(N, sms) else 32
    return W8Plan("simt", bm, bn, 1, 0, _tiles(M, N, bm, bn))


def w8_dequant_matmul_plain(x2d: torch.Tensor, data: torch.Tensor, scale_rows: torch.Tensor,
                            zp_rows: torch.Tensor | None, *, bk: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands.

    x2d (M, K); data (K, N) int8/uint8; scale_rows/zp_rows (K/bk, N) float32,
    zp_rows None for the symmetric path. Returns (M, N) float32.
    """
    M, K = x2d.shape
    N = data.shape[1]
    n_k = K // bk
    xt = x2d.to(torch.float32).reshape(M, n_k, bk).transpose(0, 1)  # (n_k, M, bk)
    dots = torch.bmm(xt, data.to(torch.float32).reshape(n_k, bk, N))  # (n_k, M, N)
    if zp_rows is not None:
        dots = dots - xt.sum(dim=-1, keepdim=True) * zp_rows.reshape(n_k, 1, N)
    return (dots * scale_rows.reshape(n_k, 1, N)).sum(dim=0)


def _check_operands(x2d, data, scale_rows, zp_rows, bk):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w8_matmul: x must be float32 or bfloat16, got {x2d.dtype}")
    if data.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"w8_matmul: data must be int8 or uint8, got {data.dtype}")
    if x2d.ndim != 2 or data.ndim != 2:
        raise ValueError("w8_matmul: x and data must be 2-D")
    M, K = x2d.shape
    if data.shape[0] != K or bk <= 0 or K % bk != 0:
        raise ValueError(f"w8_matmul: x {tuple(x2d.shape)} does not match data "
                         f"{tuple(data.shape)} with K tile {bk}")
    rows = [scale_rows] + ([] if zp_rows is None else [zp_rows])
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (K // bk, data.shape[1]):
            raise ValueError(f"w8_matmul: scale/zp rows must be float32 {(K // bk, data.shape[1])}")
    for t in [x2d, data] + rows:
        if t.device != x2d.device:
            raise ValueError("w8_matmul: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("w8_matmul: operands must be contiguous")
    if data.data_ptr() % 4:
        raise ValueError("w8_matmul: weight data must be 4-byte aligned")


def w8_matmul(x2d: torch.Tensor, data: torch.Tensor, scale_rows: torch.Tensor,
              zp_rows: torch.Tensor | None, *, bk: int) -> torch.Tensor:
    """Launch the W8 kernel on CUDA tensors; CPU tensors get the plain version.

    Operands as :func:`w8_dequant_matmul_plain`; returns (M, N) float32.
    """
    _check_operands(x2d, data, scale_rows, zp_rows, bk)
    if x2d.device.type == "cpu":
        return w8_dequant_matmul_plain(x2d, data, scale_rows, zp_rows, bk=bk)
    if x2d.device.type != "cuda":
        raise ValueError(f"w8_matmul: unsupported device {x2d.device}")
    M, K = x2d.shape
    N = data.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    if M == 0 or N == 0:
        return out
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    plan = w8_plan(M, K, N, bk, x2d.dtype, sms)
    if plan.route == "mma" and any(t.data_ptr() % CP_ASYNC_BYTES for t in (x2d, data)):
        plan = _simt_plan(M, N, sms)  # a view at an odd offset: no 16-byte copies
    ws = counters = None
    if plan.splits > 1:
        ws, counters = split_scratch(x2d.device, plan)
    err = kernel_library().oqt_w8_matmul(
        ptr(x2d), int(x2d.dtype == torch.bfloat16), ptr(data), ptr(scale_rows), ptr(zp_rows),
        ptr(out), M, K, N, bk, int(data.dtype == torch.int8), int(zp_rows is None),
        int(plan.route == "mma"), plan.bm, plan.bn, plan.split_slices, ptr(ws), ptr(counters),
        stream_ptr(x2d.device),
    )
    check_launch(err, "oqt_w8_matmul")
    global launches
    launches += 1
    route_launches[plan.route] += 1
    return out


def w8_scale_rows(qt: QTensor) -> tuple[int, torch.Tensor, torch.Tensor | None]:
    """``(bk, scale_rows, zp_rows)``: one float32 (N,) row per K tile of bk rows.

    Group strategy: bk is the group size (pad tiles carry scale 1, zp 0).
    Tensor/channel: one tile spanning K. ``zp_rows`` is None when the zero
    point is 0 (signed symmetric weights)."""
    K, N = qt.meta.shape
    scale = qt.scale.to(torch.float32)
    zp = qt.zero_point.to(torch.float32)
    strat = qt.meta.strat
    if strat == QuantizationStrategy.GROUP:
        bk = qt.meta.group_size
        n_k = -(-K // bk)
        G = scale.shape[0]
        scale = torch.cat([scale, scale.new_ones((n_k - G, N))], dim=0)
        zp = torch.cat([zp, zp.new_zeros((n_k - G, N))], dim=0)
    else:
        bk = K
        shape = (1, N) if strat == QuantizationStrategy.CHANNEL else (1, 1)
        scale = scale.reshape(shape).expand(1, N)
        zp = zp.reshape(shape).expand(1, N)
    # Symmetric signed weights have zp 0 (uint8 symmetric keeps zp = 128).
    zero_zp = qt.meta.symmetric and qt.meta.qt.is_signed
    return bk, scale.contiguous(), None if zero_zp else zp.contiguous()


def w8_operands(x: torch.Tensor, qt: QTensor) -> tuple[tuple, dict]:
    """The (x2d, data, scale_rows, zp_rows) operands and keyword arguments
    that :func:`w8_matmul` and its plain version take for ``x @ dequant(qt)``."""
    K, _ = qt.meta.shape
    bk, scale_rows, zp_rows = w8_scale_rows(qt)
    x2d = pad_to_multiple(x.reshape(-1, K), 1, bk).contiguous()
    data = pad_to_multiple(qt.data, 0, bk).contiguous()
    return (x2d, data, scale_rows, zp_rows), dict(bk=bk)


def w8_dequant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for an 8-bit QTensor. x: (..., K) -> (..., N) f32."""
    operands, kwargs = w8_operands(x, qt)
    return w8_matmul(*operands, **kwargs).reshape(*x.shape[:-1], qt.meta.shape[1])


def _w8_predicate(x, qt: QTensor, bias) -> bool:
    return (not qt.meta.packed and qt.meta.fmt == QFormat.QDQ
            and qt.meta.qt.bitwidth == 8)


@register_kernel(_w8_predicate)
def _w8_kernel_entry(x, qt: QTensor, bias):
    # Activation QDQ around the weight-only kernel: an A8 site that no A8
    # kernel covers still computes the reference's result.
    y = w8_dequant_matmul(qdq_prologue(x, qt), qt)
    return qdq_epilogue(y, qt, bias)
