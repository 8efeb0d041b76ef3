"""W8A8 (dynamic int8 activations x symmetric 8-bit weights): CUDA kernel,
wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/matmul_w8a8.py``
(``_w8a8_call`` -> ``_w8a8_kernel``) with ``csrc/matmul_w8a8.cu``. The
activations are quantized per tensor to symmetric int8 by
``matmul_w4a8.quantize_activation_int8``; the weights are int8 with zero
point 0 or uint8 with zero point 128, shifted into int8 at load. Each K tile
(the group for a group scale, all of K for a channel or tensor scale) is
dotted fully in int32 and scaled once: ``float(x_q . w) * (sx * s_row)``.

What bounds it on the card: bytes. The Gemma-3-270M lm_head (640 x
262144) reads 168 MB of weights and writes 33.5 MB of float32 logits at
decode (M = 32, ~60 us at 3.35 TB/s), and writes 2.15 GB of logits for a
2048-token scoring window (~0.64 ms). The dot runs on the tensor cores
(``mma.sync`` m16n8k32 s8, the Q8 kernel's core), each K tile's int32 sums
folded into float32 in the plain version's order, so the two stay bit-equal.
A weight N that is not a multiple of 16, a weight pointer off a 16-byte
boundary, or a group tile that is not a multiple of 32 rows keeps the
``__dp4a`` kernel of the first port. :func:`w8a8_plan` chooses the route and
the tile; the source note in ``csrc/matmul_w8a8.cu`` gives the design.
``PERF.md`` holds its times beside the plain version's and
``torch._int_mm``'s (a yardstick the port never calls).

Unlike the TPU predicate there is no ``N % 128`` or group-size condition
(the kernel masks ragged edges). Asymmetric weights, and uint8 symmetric
weights quantized with ``reduce_range`` (zero point 64, not 128), go to the
W8 kernel behind the QDQ prologue, whose result follows their zero point.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import (
    check_launch,
    four_columns_fill,
    kernel_library,
    pad_to_multiple,
    ptr,
    register_kernel,
    stream_ptr,
)
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4a8 import (
    check_a8_operands,
    quantize_activation_int8,
    takes_int8_activations,
)
from onnx_quantize_tpu_torch.ops.kernels.matmul_q8 import CP_ASYNC_BYTES, MAX_K, MMA_K, _tiles
from onnx_quantize_tpu_torch.ops.reference import qdq_epilogue

__all__ = ["W8A8Plan", "w8a8_plan", "w8a8_matmul", "w8a8_matmul_plain", "w8a8_operands",
           "w8a8_dequant_matmul"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version. ``route_launches``
# splits them by the route the launch plan chose.
launches = 0
route_launches = {"mma": 0, "simt": 0}

# Rows of K per float32 partial product in the plain version: every partial
# sum stays below 127 * 128 * 1024 < 2^24, so each chunk's dot is exact.
_EXACT_ROWS = 1024


def w8a8_matmul_plain(x_q: torch.Tensor, sx: torch.Tensor, data: torch.Tensor,
                      scale_rows: torch.Tensor, *, bk: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands.

    x_q (M, K) int8; sx a float32 scalar; data (K, N) int8, or uint8 with
    zero point 128; scale_rows (K/bk, N) float32. The integer dot of each
    tile runs as float32 products over chunks of at most 1024 rows (exact;
    TF32 must be off on a card), summed in int32; the tiles are then scaled
    and added one after the other, as the kernel does, so the two agree bit
    for bit. Returns (M, N) float32.
    """
    M, K = x_q.shape
    N = data.shape[1]
    n_k = K // bk
    w = data.to(torch.float32)
    if data.dtype == torch.uint8:
        w = w - 128.0
    xt = x_q.to(torch.float32).reshape(M, n_k, bk).transpose(0, 1)  # (n_k, M, bk)
    wt = w.reshape(n_k, bk, N)

    def chunk_dot(r0: int) -> torch.Tensor:
        return torch.bmm(xt[:, :, r0:r0 + _EXACT_ROWS], wt[:, r0:r0 + _EXACT_ROWS])

    dots = chunk_dot(0)  # (n_k, M, N), integer-valued
    if bk > _EXACT_ROWS:
        dots = dots.to(torch.int32)
        for r0 in range(_EXACT_ROWS, bk, _EXACT_ROWS):
            dots += chunk_dot(r0).to(torch.int32)
        dots = dots.to(torch.float32)
    terms = dots * (sx * scale_rows.reshape(n_k, 1, N))
    acc = terms[0]
    for t in range(1, n_k):
        acc = acc + terms[t]
    return acc


@dataclasses.dataclass(frozen=True)
class W8A8Plan:
    """How one W8A8 call launches: ``route`` "mma" (s8 tensor cores) or
    "simt" (``__dp4a`` on the CUDA cores); a block covers ``bm`` rows of M and
    ``bn`` columns; ``blocks`` in all."""

    route: str
    bm: int
    bn: int
    blocks: int


def w8a8_plan(M: int, K: int, N: int, sms: int, bk: int | None = None) -> W8A8Plan:
    """The launch plan of ``csrc/matmul_w8a8.cu`` for x_q (M, K) against (K, N)
    int8/uint8 weights in K tiles of ``bk`` rows (None: all of K) on a card of
    ``sms`` SMs.

    The mma route needs N % 16 == 0 (weight rows move in 16-byte
    ``cp.async`` chunks) and a K tile that is all of K or whole 32-row mma
    slices (a tile's int32 sums are folded before the next tile starts). Up
    to M = 64: 32-row tiles of 64 columns, or of 32 where 64 could not give
    every SM a block. Above: 128 x 128 tiles, or 64 x 128 where those number
    fewer than the SMs. K is never split (the lm_head launches 4,096 blocks
    at M = 32). Anything else takes the simt route: 32- or 64-row tiles, four
    columns a thread where N % 4 == 0 and the wide blocks still fill every SM.
    """
    bk = K if bk is None else bk
    if N % CP_ASYNC_BYTES or (bk != K and bk % MMA_K):
        return _simt_plan(M, N, sms)
    if M <= 64:
        bm = 32
        bn = 64 if _tiles(M, N, bm, 64) >= sms else 32
    else:
        bn = 128
        bm = 128 if _tiles(M, N, 128, bn) >= sms else 64
    return W8A8Plan("mma", bm, bn, _tiles(M, N, bm, bn))


def _simt_plan(M: int, N: int, sms: int) -> W8A8Plan:
    bm = 32 if M <= 32 else 64
    bn = 128 if four_columns_fill(N, sms) else 32
    return W8A8Plan("simt", bm, bn, _tiles(M, N, bm, bn))


def _check_operands(x_q, sx, data, scale_rows, bk):
    check_a8_operands("w8a8_matmul", x_q, sx, data, scale_rows)
    if data.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"w8a8_matmul: data must be int8 or uint8, got {data.dtype}")
    K = x_q.shape[1]
    if data.shape[0] != K or bk <= 0 or K % bk != 0:
        raise ValueError(f"w8a8_matmul: x_q {tuple(x_q.shape)} does not match data "
                         f"{tuple(data.shape)} with K tile {bk}")
    if scale_rows.dtype != torch.float32 or tuple(scale_rows.shape) != (K // bk, data.shape[1]):
        raise ValueError(f"w8a8_matmul: scale rows must be float32 {(K // bk, data.shape[1])}")


def w8a8_matmul(x_q: torch.Tensor, sx: torch.Tensor, data: torch.Tensor,
                scale_rows: torch.Tensor, *, bk: int) -> torch.Tensor:
    """Launch the W8A8 kernel on CUDA tensors; CPU tensors get the plain version.

    Operands as :func:`w8a8_matmul_plain`; returns (M, N) float32.
    """
    _check_operands(x_q, sx, data, scale_rows, bk)
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, sx, data, scale_rows, bk=bk)
    if x_q.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x_q.device}")
    M, K = x_q.shape
    N = data.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return out
    if bk >= MAX_K:
        raise ValueError(f"w8a8_matmul: a K tile of {bk} rows could overflow the int32 dot "
                         f"(bk < {MAX_K})")
    sms = torch.cuda.get_device_properties(x_q.device).multi_processor_count
    plan = w8a8_plan(M, K, N, sms, bk)
    if plan.route == "mma":
        # x rows move in 16-byte chunks: pad them with zero codes.
        x_q = pad_to_multiple(x_q, 1, CP_ASYNC_BYTES).contiguous()
        if data.data_ptr() % CP_ASYNC_BYTES or x_q.data_ptr() % CP_ASYNC_BYTES:
            plan = _simt_plan(M, N, sms)  # a view at an odd offset: no 16-byte copies
    err = kernel_library().oqt_w8a8_matmul(
        ptr(x_q), ptr(sx), ptr(data), ptr(scale_rows), ptr(out), M, K, N, x_q.shape[1], bk,
        int(data.dtype == torch.int8), int(plan.route == "mma"), plan.bm, plan.bn,
        stream_ptr(x_q.device),
    )
    check_launch(err, "oqt_w8a8_matmul")
    global launches
    launches += 1
    route_launches[plan.route] += 1
    return out


def w8a8_operands(x: torch.Tensor, qt: QTensor) -> tuple[tuple, dict]:
    """The (x_q, sx, data, scale_rows) operands and keyword arguments that
    :func:`w8a8_matmul` and its plain version take for ``quant(x) @ dequant(qt)``."""
    # Imported here: importing matmul_w8 registers the W8 kernel, which must
    # come after this module's (the registry's import order).
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w8 import w8_scale_rows

    K, _ = qt.meta.shape
    bk, scale_rows, _ = w8_scale_rows(qt)  # the zero point is 0 or the shift's 128
    x_q, sx = quantize_activation_int8(x.reshape(-1, K))
    x_q = pad_to_multiple(x_q, 1, bk).contiguous()
    data = pad_to_multiple(qt.data, 0, bk).contiguous()
    return (x_q, sx, data, scale_rows), dict(bk=bk)


def w8a8_dequant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``quant_int8(x) @ dequant(qt)`` for a symmetric 8-bit QTensor. x: (..., K) -> (..., N)."""
    operands, kwargs = w8a8_operands(x, qt)
    return w8a8_matmul(*operands, **kwargs).reshape(*x.shape[:-1], qt.meta.shape[1])


def _w8a8_predicate(x, qt: QTensor, bias) -> bool:
    m = qt.meta
    return (not m.packed and m.qt.bitwidth == 8 and takes_int8_activations(qt) and m.symmetric
            and (m.qt.is_signed or not m.reduce_range))


@register_kernel(_w8a8_predicate)
def _w8a8_kernel_entry(x, qt: QTensor, bias):
    return qdq_epilogue(w8a8_dequant_matmul(x, qt), qt, bias)
