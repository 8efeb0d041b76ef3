"""W4A8 (dynamic int8 activations x packed 4-bit weights): CUDA kernel, wrapper,
plain version, and the activation quantizer shared with W8A8.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/matmul_w4a8.py``
(``_w4a8_call`` -> ``_w4a8_kernel``) with ``csrc/matmul_w4a8.cu``. The
activations are quantized per tensor to symmetric int8 by
:func:`quantize_activation_int8` (plain torch, as the reference's jnp
prologue runs outside its kernel); the kernel dots the int8 codes against
the raw nibbles in int32 and folds the zero point in through the int32 sum
of the codes: ``(x_q . w - sum(x_q) * zp) * (sx * s)`` per group.

What bounds it on the card: bytes. One Gemma-3-270M layer's four sites at
decode (M = 32) read ~3.5 MB of packed weights and scales and write ~0.9 MB
of float32, ~1.4 us at 3.35 TB/s. The dot runs on the tensor cores
(``mma.sync`` m16n8k32 s8, the Q8 kernel's core, each packed weight word
feeding one mma of its low nibbles and one of its high ones), and at decode
K is split until the grid fills the SMs: the splits add their per-group
int32 sums (exact in any order) into the tile's scratch, and the last block
folds every pair into float32 in the plain version's order, so the two stay
bit-equal. N % 16 != 0, a group size that is not a multiple of 32, an
operand off a 16-byte boundary or K_pad >= 2^17 keeps the ``__dp4a`` kernel
of the first port. :func:`w4a8_plan` chooses the route, the tile and the
split; the source note in ``csrc/matmul_w4a8.cu`` gives the design.
``PERF.md`` holds its times beside the plain version's and ``torch._int_mm``'s
on the int32 core (a yardstick the port never calls).

Unlike the TPU predicate there is no ``N % 128`` or ``gs % 8`` condition
(the kernel masks ragged M, N and K edges), and a dynamic int8 spec with
``reduce_range`` is left to the W4 kernel behind the QDQ prologue, whose
result follows that spec (the reference's kernel would quantize to +-127
there). Nor does the predicate test the zero point: the kernel folds it in
as float32 (``sum(x_q) * zp``), so an integer or a float zero point gives
the reference's result, and ``engine.prepare_kernel_scales`` holds both as
float32. Which sites run A8 is decided once, by ``ops.convert_to_w4a8``,
which skips float (HQQ) zero points as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat
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
from onnx_quantize_tpu_torch.ops.kernels.matmul_q8 import CP_ASYNC_BYTES, MAX_K, MMA_K, _tiles
from onnx_quantize_tpu_torch.ops.reference import qdq_epilogue

__all__ = ["W4A8Plan", "w4a8_plan", "quantize_activation_int8", "w4a8_matmul",
           "w4a8_matmul_plain", "w4a8_operands", "w4a8_dequant_matmul",
           "takes_int8_activations", "check_a8_operands"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version. ``route_launches``
# splits them by the route the launch plan chose.
launches = 0
route_launches = {"mma": 0, "simt": 0}


@dataclasses.dataclass(frozen=True)
class W4A8Plan:
    """How one W4A8 call launches: ``route`` "mma" (s8 tensor cores) or
    "simt" (``__dp4a`` on the CUDA cores); a block covers ``bm`` rows of M and
    ``bn`` columns; ``splits`` blocks share each (bm, bn) tile along K, each
    walking ``split_slices`` slices of 32 packed rows (mma route; 0 for
    simt); ``blocks`` in all; ``groups`` scale groups along K_pad."""

    route: str
    bm: int
    bn: int
    splits: int
    split_slices: int
    blocks: int
    groups: int

    @property
    def tiles(self) -> int:
        return self.blocks // self.splits

    @property
    def scratch_elems(self) -> int:
        """int32 elements of K-split scratch: each tile's per-group dots and
        row sums."""
        return self.tiles * self.groups * (self.bm * self.bn + self.bm)


def w4a8_plan(M: int, K_pad: int, N: int, gs: int, sms: int) -> W4A8Plan:
    """The launch plan of ``csrc/matmul_w4a8.cu`` for x_q (M, K_pad) against
    packed (K_pad/2, N) weights with group size ``gs`` on a card of ``sms``
    SMs.

    The mma route needs N % 16 == 0 (weight rows move in 16-byte ``cp.async``
    chunks), ``gs % 32 == 0`` (an mma slice of 32 packed rows lies inside one
    group pair) and K_pad < 2^17 (no int32 overflow without ``.satfinite``).
    Tiles are 32 rows by 64 columns up to M = 64 and by 128 above. While the
    tiles number fewer than 3/8 of the SMs, K is split into ranges of whole
    slices until they do (a split's atomics and the last block's fold cost
    more than further blocks gain: at M = 32 the Gemma-3-270M qkv site
    launches 72 blocks, o and down 60, gate_up 64 unsplit; none splits at
    M = 4096). Anything else takes the simt route:
    32- or 64-row tiles, four columns a thread where N % 4 == 0 and the wide
    blocks still fill every SM.
    """
    groups = K_pad // gs
    if N % CP_ASYNC_BYTES or gs % MMA_K or K_pad >= MAX_K:
        return _simt_plan(M, N, sms, groups)
    bm, bn = 32, 64 if M <= 64 else 128
    tiles = _tiles(M, N, bm, bn)
    slices = K_pad // 2 // MMA_K
    per = slices
    fill = sms * 3 // 8
    if tiles < fill:
        per = max(1, slices // -(-fill // tiles))
    splits = -(-slices // per)
    return W4A8Plan("mma", bm, bn, splits, per, tiles * splits, groups)


def _simt_plan(M: int, N: int, sms: int, groups: int) -> W4A8Plan:
    bm = 32 if M <= 32 else 64
    bn = 128 if four_columns_fill(N, sms) else 32
    return W4A8Plan("simt", bm, bn, 1, 0, _tiles(M, N, bm, bn), groups)


def quantize_activation_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes and their float32 scale, bit-equal to
    the reference's ``quantize_activation_int8``: float32 first, the absmax
    over the whole tensor, ``scale = absmax / 127`` (1 when absmax is 0),
    codes ``clamp(round_half_even(x / scale), -127, 127)``."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax()
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def w4a8_matmul_plain(x_q: torch.Tensor, sx: torch.Tensor, data: torch.Tensor,
                      scales: torch.Tensor, zps: torch.Tensor, *, gs: int,
                      signed: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands.

    x_q (M, K_pad) int8; sx a float32 scalar; data (K_pad/2, N) uint8;
    scales/zps (G_pad/2, 2, N) float32. The integer dots run as float32
    products of integer values, exact while every partial stays below 2^24
    (127 * 15 * gs); TF32 must be off on a card. The float32 epilogue
    follows the kernel's operations in its order (one group pair after the
    other), so the two agree bit for bit. Returns (M, N) float32.
    """
    M, K_pad = x_q.shape
    half_rows, N = data.shape
    pairs = half_rows // gs
    w = data.reshape(pairs, gs, N).to(torch.int16)
    nibbles = torch.stack([w & 0x0F, w >> 4], dim=1)  # (P, 2, gs, N), raw
    if signed:
        nibbles = torch.where(nibbles > 7, nibbles - 16, nibbles)
    xg = x_q.to(torch.float32).reshape(M, 2 * pairs, gs).transpose(0, 1)  # (G, M, gs)
    dots = torch.bmm(xg, nibbles.reshape(2 * pairs, gs, N).to(torch.float32))  # (G, M, N)
    xsum = xg.sum(dim=-1, keepdim=True)  # exact: integers below 2^24
    s = sx * scales.reshape(2 * pairs, 1, N)
    terms = (dots - xsum * zps.reshape(2 * pairs, 1, N)) * s
    acc = terms[0] + terms[1]
    for p in range(1, pairs):
        acc = acc + (terms[2 * p] + terms[2 * p + 1])
    return acc


def check_a8_operands(name: str, x_q, sx, data, *rest) -> None:
    """The checks both A8 wrappers make: int8 codes with one float32 scale,
    2-D codes and weight, every operand contiguous on x_q's device, and the
    weight 4-byte aligned (the kernels load it a word at a time)."""
    if x_q.dtype != torch.int8 or sx.dtype != torch.float32 or sx.numel() != 1:
        raise TypeError(f"{name}: x_q must be int8 and sx one float32")
    if x_q.ndim != 2 or data.ndim != 2:
        raise ValueError(f"{name}: x_q and data must be 2-D")
    for t in (x_q, sx, data, *rest):
        if t.device != x_q.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if data.data_ptr() % 4:
        raise ValueError(f"{name}: weight data must be 4-byte aligned")


def _check_operands(x_q, sx, data, scales, zps, gs):
    check_a8_operands("w4a8_matmul", x_q, sx, data, scales, zps)
    if data.dtype != torch.uint8 or scales.dtype != torch.float32 or zps.dtype != torch.float32:
        raise TypeError("w4a8_matmul: data must be uint8 and scales/zps float32")
    half_rows, N = data.shape
    if gs <= 0 or half_rows % gs != 0 or x_q.shape[1] != 2 * half_rows:
        raise ValueError(f"w4a8_matmul: x_q {tuple(x_q.shape)} does not match packed data "
                         f"{tuple(data.shape)} with group size {gs}")
    if tuple(scales.shape) != (half_rows // gs, 2, N) or zps.shape != scales.shape:
        raise ValueError(f"w4a8_matmul: scales/zps must be {(half_rows // gs, 2, N)}")


def w4a8_matmul(x_q: torch.Tensor, sx: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                zps: torch.Tensor, *, gs: int, signed: bool) -> torch.Tensor:
    """Launch the W4A8 kernel on CUDA tensors; CPU tensors get the plain version.

    Operands as :func:`w4a8_matmul_plain`; returns (M, N) float32.
    """
    _check_operands(x_q, sx, data, scales, zps, gs)
    if x_q.device.type == "cpu":
        return w4a8_matmul_plain(x_q, sx, data, scales, zps, gs=gs, signed=signed)
    if x_q.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x_q.device}")
    M, K_pad = x_q.shape
    N = data.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return out
    sms = torch.cuda.get_device_properties(x_q.device).multi_processor_count
    plan = w4a8_plan(M, K_pad, N, gs, sms)
    if plan.route == "mma" and any(t.data_ptr() % CP_ASYNC_BYTES for t in (x_q, data)):
        plan = _simt_plan(M, N, sms, plan.groups)  # a view at an odd offset: no 16-byte copies
    ws = counters = None
    if plan.splits > 1:
        ws, counters = split_scratch(x_q.device, plan)
    err = kernel_library().oqt_w4a8_matmul(
        ptr(x_q), ptr(sx), ptr(data), ptr(scales), ptr(zps), ptr(out), M, K_pad, N, gs,
        int(signed), int(plan.route == "mma"), plan.bm, plan.bn, plan.split_slices, ptr(ws),
        ptr(counters), stream_ptr(x_q.device),
    )
    check_launch(err, "oqt_w4a8_matmul")
    global launches
    launches += 1
    route_launches[plan.route] += 1
    return out


def w4a8_operands(x: torch.Tensor, qt: QTensor) -> tuple[tuple, dict]:
    """The (x_q, sx, data, scales, zps) operands and keyword arguments that
    :func:`w4a8_matmul` and its plain version take for ``quant(x) @ dequant(qt)``."""
    # Imported here: importing matmul_w4 registers the W4 kernel, which must
    # come after this module's (the registry's import order).
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import expand_w4_scales

    K, _ = qt.meta.shape
    x_q, sx = quantize_activation_int8(x.reshape(-1, K))
    # Zero codes meet the zero pad rows of the packed weight.
    x_q = pad_to_multiple(x_q, 1, 2 * qt.data.shape[0]).contiguous()
    scales, zps = expand_w4_scales(qt)
    return (x_q, sx, qt.data, scales, zps), dict(gs=qt.meta.pack_group,
                                                 signed=qt.meta.qt.is_signed)


def w4a8_dequant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``quant_int8(x) @ dequant(qt)`` for a packed 4-bit QTensor. x: (..., K) -> (..., N)."""
    operands, kwargs = w4a8_operands(x, qt)
    return w4a8_matmul(*operands, **kwargs).reshape(*x.shape[:-1], qt.meta.shape[1])


def takes_int8_activations(qt: QTensor) -> bool:
    """The site quantizes its input to per-tensor symmetric int8 on the fly
    (the A8 kernels' activation spec)."""
    spec = qt.meta.input_quant
    return (qt.meta.fmt == QFormat.QDQ and spec.mode == "dynamic" and spec.dtype == "int8"
            and spec.symmetric and not spec.reduce_range)


def _w4a8_predicate(x, qt: QTensor, bias) -> bool:
    # Integer zero points only: HQQ's float zero point cannot fold into the
    # int8 sums, so such a site takes W4 behind the activation QDQ.
    return qt.meta.packed and not qt.meta.float_zero_point and takes_int8_activations(qt)


@register_kernel(_w4a8_predicate)
def _w4a8_kernel_entry(x, qt: QTensor, bias):
    return qdq_epilogue(w4a8_dequant_matmul(x, qt), qt, bias)
