"""W4 (uint4/int4) group-pair dequant-matmul: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/matmul_w4.py``
(``_w4_call`` -> ``_w4_kernel``) with ``csrc/matmul_w4.cu``. It computes
``x @ dequant(W)`` in float32 for packed 4-bit weights, applying each group's
affine to the partial dot: ``(x . w - sum(x) * zp) * s``.

What bounds it on the card: at decode (M <= 64) the packed weight bytes (a
Gemma-3-270M layer's four sites read 3.1 MB, ~1 us at 3.35 TB/s); at
M >= 2048 the bf16 operations (~26 us a layer at M = 2048). bf16 x runs on
the tensor cores (``mma.sync`` m16n8k16, nibbles turned exactly into bf16),
and at decode the K dimension is split until the grid fills the SMs, with
the partials summed in a fixed order inside the same launch. float32 x, a
group size or N that is not a multiple of 16, or an operand that is not
16-byte aligned keeps the CUDA-core kernel.
:func:`w4_plan` chooses the route, the tile and the split; the source note in
``csrc/matmul_w4.cu`` gives the design. ``PERF.md`` holds its times.

Unlike the TPU wrapper there is no ``N % 128`` predicate (ragged edges are
masked in the kernel) and no routing of large M to a dequantize-then-dense
path: that threshold was measured on a TPU.
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

__all__ = ["W4Plan", "w4_plan", "w4_matmul", "w4_dequant_matmul_plain", "w4_dequant_matmul",
           "w4_operands", "expand_w4_scales"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0

# Packed rows an mma slice covers (the mma's K): the K split's granularity.
MMA_SLICE = 16
# Bytes of one cp.async copy: the mma route stages x and weight rows in such
# chunks, so it needs 16-byte-aligned operands and N % 16 == 0.
CP_ASYNC_BYTES = 16


@dataclasses.dataclass(frozen=True)
class W4Plan:
    """How one W4 call launches: ``route`` "mma" (bf16 x on the tensor cores)
    or "simt" (float32 FMAs on the CUDA cores); a block covers ``bm`` rows of
    M and ``bn`` columns; ``splits`` blocks share each (bm, bn) tile along K,
    each walking ``split_chunks`` slices of 16 packed rows (mma route; 0 for
    simt); ``blocks`` in all."""

    route: str
    bm: int
    bn: int
    splits: int
    split_chunks: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.blocks // self.splits


def w4_plan(M: int, K_pad: int, N: int, gs: int, x_dtype: torch.dtype, sms: int) -> W4Plan:
    """The launch plan of ``csrc/matmul_w4.cu`` for x (M, K_pad) of ``x_dtype``
    against packed (K_pad/2, N) weights with group size ``gs`` on a card of
    ``sms`` SMs.

    bf16 x with ``gs % 16 == 0`` and ``N % 16 == 0`` (the weight rows move in
    16-byte ``cp.async`` chunks) takes the mma route: 16-, 32- or 64-row by
    64-column tiles up to M = 64, 64 x 128 above. While the tiles number
    fewer than the SMs, K is split into ranges of whole 16-row slices (each
    slice lies inside one group pair), as many as fill the SMs; with enough
    tiles (every Gemma-3-270M site at M >= 2048) there is no split. Anything
    else takes the simt route.
    """
    if x_dtype == torch.bfloat16 and gs % MMA_SLICE == 0 and N % CP_ASYNC_BYTES == 0:
        bm = 16 if M <= 16 else 32 if M <= 32 else 64
        bn = 64 if M <= 64 else 128
        tiles = -(-M // bm) * -(-N // bn)
        chunks = K_pad // (2 * MMA_SLICE)
        per = chunks
        if tiles < sms:
            per = max(1, chunks // -(-sms // tiles))
        splits = -(-chunks // per)
        return W4Plan("mma", bm, bn, splits, per, tiles * splits)
    return _simt_plan(M, N, sms)


def _simt_plan(M: int, N: int, sms: int) -> W4Plan:
    """32- or 64-row tiles; four columns a thread only when N % 4 == 0 and the
    wide blocks still fill every SM."""
    bm = 32 if M <= 32 else 64
    bn = 128 if four_columns_fill(N, sms) else 32
    return W4Plan("simt", bm, bn, 1, 0, -(-M // bm) * -(-N // bn))


def w4_dequant_matmul_plain(x2d: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                            zps: torch.Tensor, *, gs: int, signed: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands.

    x2d (M, K_pad); data (K_pad/2, N) uint8; scales/zps (G_pad/2, 2, N)
    float32. Returns (M, N) float32.
    """
    M, K_pad = x2d.shape
    half_rows, N = data.shape
    pairs = half_rows // gs
    w = data.reshape(pairs, gs, N).to(torch.int16)
    nibbles = torch.stack([w & 0x0F, w >> 4], dim=1)  # (P, 2, gs, N)
    if signed:
        nibbles = torch.where(nibbles > 7, nibbles - 16, nibbles)
    xg = x2d.to(torch.float32).reshape(M, pairs * 2, gs).transpose(0, 1)  # (G, M, gs)
    dots = torch.bmm(xg, nibbles.reshape(pairs * 2, gs, N).to(torch.float32))  # (G, M, N)
    xsum = xg.sum(dim=-1, keepdim=True)  # (G, M, 1)
    s = scales.reshape(pairs * 2, 1, N)
    z = zps.reshape(pairs * 2, 1, N)
    return ((dots - xsum * z) * s).sum(dim=0)


def _check_operands(x2d, data, scales, zps, gs):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w4_matmul: x must be float32 or bfloat16, got {x2d.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float32 or zps.dtype != torch.float32:
        raise TypeError("w4_matmul: data must be uint8 and scales/zps float32")
    if x2d.ndim != 2 or data.ndim != 2:
        raise ValueError("w4_matmul: x and data must be 2-D")
    M, K_pad = x2d.shape
    half_rows, N = data.shape
    if gs <= 0 or half_rows % gs != 0 or K_pad != 2 * half_rows:
        raise ValueError(f"w4_matmul: x {tuple(x2d.shape)} does not match packed data "
                         f"{tuple(data.shape)} with group size {gs}")
    if tuple(scales.shape) != (half_rows // gs, 2, N) or zps.shape != scales.shape:
        raise ValueError(f"w4_matmul: scales/zps must be {(half_rows // gs, 2, N)}")
    for t in (x2d, data, scales, zps):
        if t.device != x2d.device:
            raise ValueError("w4_matmul: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("w4_matmul: operands must be contiguous")
    if data.data_ptr() % 4:
        raise ValueError("w4_matmul: packed data must be 4-byte aligned")


def w4_matmul(x2d: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, zps: torch.Tensor,
              *, gs: int, signed: bool) -> torch.Tensor:
    """Launch the W4 kernel on CUDA tensors; CPU tensors get the plain version.

    Operands as :func:`w4_dequant_matmul_plain`; returns (M, N) float32.
    """
    _check_operands(x2d, data, scales, zps, gs)
    if x2d.device.type == "cpu":
        return w4_dequant_matmul_plain(x2d, data, scales, zps, gs=gs, signed=signed)
    if x2d.device.type != "cuda":
        raise ValueError(f"w4_matmul: unsupported device {x2d.device}")
    M, K_pad = x2d.shape
    N = data.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    if M == 0 or N == 0:
        return out
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    plan = w4_plan(M, K_pad, N, gs, x2d.dtype, sms)
    if plan.route == "mma" and any(t.data_ptr() % CP_ASYNC_BYTES for t in (x2d, data)):
        plan = _simt_plan(M, N, sms)  # a view at an odd offset: no 16-byte copies
    ws = counters = None
    if plan.splits > 1:
        ws, counters = split_scratch(x2d.device, plan)
    err = kernel_library().oqt_w4_matmul(
        ptr(x2d), int(x2d.dtype == torch.bfloat16), ptr(data), ptr(scales), ptr(zps),
        ptr(out), M, K_pad, N, gs, int(signed), int(plan.route == "mma"), plan.bm, plan.bn,
        plan.split_chunks, ptr(ws), ptr(counters), stream_ptr(x2d.device),
    )
    check_launch(err, "oqt_w4_matmul")
    global launches
    launches += 1
    return out


def expand_w4_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale/zp as (G_pad/2, 2, N) float32 group-pair rows, pad groups (1, 0).

    A QTensor whose scales ``engine.prepare_kernel_scales`` already baked
    passes through."""
    _, N = qt.meta.shape
    G_pad = 2 * qt.data.shape[0] // qt.meta.pack_group
    scale = qt.scale.to(torch.float32)
    zp = qt.zero_point.to(torch.float32)
    if scale.ndim == 3:
        return scale, zp
    strat = qt.meta.strat
    if strat == QuantizationStrategy.GROUP:
        G = scale.shape[0]
        scale = torch.cat([scale, scale.new_ones((G_pad - G, N))], dim=0)
        zp = torch.cat([zp, zp.new_zeros((G_pad - G, N))], dim=0)
    elif strat == QuantizationStrategy.CHANNEL:
        scale = scale[None, :].expand(G_pad, N)
        zp = zp[None, :].expand(G_pad, N)
    else:
        scale = scale.reshape(1, 1).expand(G_pad, N)
        zp = zp.reshape(1, 1).expand(G_pad, N)
    return (scale.reshape(G_pad // 2, 2, N).contiguous(),
            zp.reshape(G_pad // 2, 2, N).contiguous())


def w4_operands(x: torch.Tensor, qt: QTensor) -> tuple[tuple, dict]:
    """The (x2d, data, scales, zps) operands and keyword arguments that
    :func:`w4_matmul` and its plain version take for ``x @ dequant(qt)``."""
    K, _ = qt.meta.shape
    # Zero x columns meet the zero pad rows of the packed weight.
    x2d = pad_to_multiple(x.reshape(-1, K), 1, 2 * qt.data.shape[0]).contiguous()
    scales, zps = expand_w4_scales(qt)
    return (x2d, qt.data, scales, zps), dict(gs=qt.meta.pack_group,
                                             signed=qt.meta.qt.is_signed)


def w4_dequant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequant(qt)`` for a packed 4-bit QTensor. x: (..., K) -> (..., N) f32."""
    operands, kwargs = w4_operands(x, qt)
    return w4_matmul(*operands, **kwargs).reshape(*x.shape[:-1], qt.meta.shape[1])


def _w4_predicate(x, qt: QTensor, bias) -> bool:
    return qt.meta.packed and qt.meta.fmt == QFormat.QDQ


@register_kernel(_w4_predicate)
def _w4_kernel_entry(x, qt: QTensor, bias):
    # Activation QDQ around the weight-only kernel: an A8 site that no A8
    # kernel covers still computes the reference's result.
    y = w4_dequant_matmul(qdq_prologue(x, qt), qt)
    return qdq_epilogue(y, qt, bias)
