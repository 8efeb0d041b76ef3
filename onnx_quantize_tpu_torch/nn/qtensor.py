"""QTensor: a quantized weight over torch tensors.

Counterpart of ``onnx_quantize_tpu/nn/qtensor.py`` with the same layout, so
packed bytes and scales compare equal between the two packages:

  * weights keep the logical ``(K, N)`` orientation; group scales are
    ``(n_groups, N)``;
  * 4-bit weights use *group-pair* nibble packing: the low nibble of packed
    row ``p*gs + r`` holds logical row ``(2p)*gs + r`` (scale group ``2p``)
    and the high nibble holds ``(2p+1)*gs + r`` (group ``2p+1``). Logical
    rows past K are zero. Non-group strategies use one virtual group pair
    spanning the two K halves.

The engine may re-lay group scales as padded ``(G_pad/2, 2, N)`` float32
rows (``engine.prepare_kernel_scales``); both layouts are valid everywhere.

Beside the weight, a QTensor carries its site's execution spec: how the
input and output activations are quantized (:class:`ActQuantSpec`, "none"
by default) and their static qparams, when there are any. A quantized bias
is a :class:`QBias`.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

__all__ = ["ActQuantSpec", "QTensorMeta", "QTensor", "QBias", "make_qtensor", "pack_layout",
           "unpack_k_pairs"]


@dataclasses.dataclass(frozen=True)
class ActQuantSpec:
    """Static description of one activation quantization (input or output)."""

    mode: str  # "none" | "static" | "dynamic"
    dtype: str = "uint8"  # QuantType value
    symmetric: bool = False
    reduce_range: bool = False

    @property
    def quant_type(self) -> QuantType:
        return QuantType(self.dtype)


_NO_ACT = ActQuantSpec(mode="none")


@dataclasses.dataclass(frozen=True)
class QTensorMeta:
    """Static metadata of a quantized weight."""

    quant_type: str  # QuantType value
    strategy: str  # QuantizationStrategy value
    group_size: int  # resolved; -1 for channel/tensor
    symmetric: bool
    reduce_range: bool
    shape: tuple[int, int]  # logical (K, N)
    format: str = "qdq"  # QFormat value
    packed: bool = False  # 4-bit group-pair nibble packing along K
    pack_group: int = 0  # rows per nibble group (gs for GROUP, ceil(K/2) else)
    input_quant: ActQuantSpec = _NO_ACT
    output_quant: ActQuantSpec = _NO_ACT
    # Quantized with float zero points (HQQ). Recorded when the site is
    # quantized, since ``engine.prepare_kernel_scales`` holds every packed
    # zero point as float32: such a site never takes the W4A8 kernel, whose
    # int8 fold needs integer zero points.
    float_zero_point: bool = False

    @property
    def qt(self) -> QuantType:
        return QuantType(self.quant_type)

    @property
    def strat(self) -> QuantizationStrategy:
        return QuantizationStrategy(self.strategy)

    @property
    def fmt(self) -> QFormat:
        return QFormat(self.format)


@dataclasses.dataclass
class QTensor:
    """Quantized weight: integer data, float32 scale, zero point, metadata,
    and the static activation qparams (None unless the spec is static)."""

    data: torch.Tensor  # (K, N) int8/uint8, or (K_pad/2, N) uint8 when packed
    scale: torch.Tensor  # scalar | (N,) | (n_groups, N) | (G_pad/2, 2, N)
    zero_point: torch.Tensor  # same shape family as scale
    meta: QTensorMeta
    input_scale: torch.Tensor | None = None
    input_zero_point: torch.Tensor | None = None
    output_scale: torch.Tensor | None = None
    output_zero_point: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.meta.shape

    def to(self, device) -> "QTensor":
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, data=self.data.to(device), scale=self.scale.to(device),
            zero_point=self.zero_point.to(device), input_scale=move(self.input_scale),
            input_zero_point=move(self.input_zero_point),
            output_scale=move(self.output_scale),
            output_zero_point=move(self.output_zero_point),
        )


@dataclasses.dataclass
class QBias:
    """Quantized bias vector (per tensor), dequantized at execution.

    QDQ Gemm: RTN per tensor in the weight dtype. QLINEAR Gemm: int32 with
    ``scale = x_scale * w_scale`` and zero point 0, added to the integer
    accumulator as it is.
    """

    data: torch.Tensor  # (N,)
    scale: torch.Tensor
    zero_point: torch.Tensor
    quant_type: str  # QuantType value

    def dequantize(self) -> torch.Tensor:
        return (self.data.to(torch.float32) - self.zero_point.to(torch.float32)) * (
            self.scale.to(torch.float32))

    def to(self, device) -> "QBias":
        return dataclasses.replace(self, data=self.data.to(device), scale=self.scale.to(device),
                                   zero_point=self.zero_point.to(device))


def pack_layout(K: int, strategy: QuantizationStrategy, group_size: int):
    """Group-pair packing geometry: (rows_per_group, padded_group_count)."""
    if strategy == QuantizationStrategy.GROUP and group_size and group_size > 0:
        gs = min(group_size, K)
    else:
        gs = (K + 1) // 2
    n_groups = -(-K // gs)
    if n_groups % 2 == 1:
        n_groups += 1
    return gs, n_groups


def _pack_group_pairs(q: torch.Tensor, gs: int, n_groups_pad: int) -> torch.Tensor:
    """Pack (K, N) 4-bit container values into the group-pair nibble layout."""
    K, N = q.shape
    K_pad = n_groups_pad * gs
    u = (q.to(torch.int16) & 0x0F).to(torch.uint8)  # two's complement nibble
    if K_pad != K:
        u = torch.cat([u, u.new_zeros((K_pad - K, N))], dim=0)
    u = u.reshape(n_groups_pad // 2, 2, gs, N)
    return (u[:, 0] | (u[:, 1] << 4)).reshape(K_pad // 2, N)


def unpack_k_pairs(data: torch.Tensor, K: int, signed: bool, pack_group: int) -> torch.Tensor:
    """Unpack the group-pair nibble layout back to (K, N) container values."""
    half_rows, N = data.shape
    d = data.reshape(half_rows // pack_group, pack_group, N)
    low = d & 0x0F
    high = d >> 4
    full = torch.stack([low, high], dim=1).reshape(2 * half_rows, N)[:K]
    if signed:
        s = full.to(torch.int8)
        return torch.where(s > 7, s - 16, s)
    return full


def _layout_scale(scale: torch.Tensor, zp: torch.Tensor, strategy: QuantizationStrategy,
                  N: int):
    """Algorithm-layout scale/zp -> QTensor layout (``(n_groups, N)`` for GROUP)."""
    if strategy == QuantizationStrategy.GROUP:
        n_groups = scale.numel() // N
        scale = scale.reshape(N, n_groups).T.contiguous()
        zp = zp.reshape(N, n_groups).T.contiguous()
    return scale, zp


def make_qtensor(
    q_weight: torch.Tensor,
    scale: torch.Tensor,
    zero_point: torch.Tensor,
    *,
    quant_type: QuantType,
    strategy: QuantizationStrategy,
    group_size: int,
    symmetric: bool,
    reduce_range: bool,
    fmt: QFormat = QFormat.QDQ,
    input_quant: ActQuantSpec = _NO_ACT,
    output_quant: ActQuantSpec = _NO_ACT,
    input_scale: torch.Tensor | None = None,
    input_zero_point: torch.Tensor | None = None,
    output_scale: torch.Tensor | None = None,
    output_zero_point: torch.Tensor | None = None,
) -> QTensor:
    """Build a QTensor from algorithm outputs (``(K, N)`` q-weight + qparams)."""
    K, N = q_weight.shape
    scale, zero_point = _layout_scale(scale, zero_point, strategy, N)
    packed = quant_type.bitwidth == 4
    if packed:
        gs, n_groups_pad = pack_layout(K, strategy, group_size)
        data = _pack_group_pairs(q_weight, gs, n_groups_pad)
    else:
        gs = 0
        data = q_weight.contiguous()
    meta = QTensorMeta(
        quant_type=quant_type.value,
        strategy=strategy.value,
        group_size=group_size if group_size else -1,
        symmetric=symmetric,
        reduce_range=reduce_range,
        shape=(K, N),
        format=fmt.value,
        packed=packed,
        pack_group=gs,
        input_quant=input_quant,
        output_quant=output_quant,
        float_zero_point=zero_point.is_floating_point(),
    )
    return QTensor(data=data, scale=scale, zero_point=zero_point, meta=meta,
                   input_scale=input_scale, input_zero_point=input_zero_point,
                   output_scale=output_scale, output_zero_point=output_zero_point)
