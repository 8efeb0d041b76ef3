"""Shared quantization enums (strategy / format).

Counterpart of ``onnx_quantize_tpu/core/enums.py``; the values are the same
strings, so configs and QTensor metadata translate between the two packages.
"""

from __future__ import annotations

import enum

__all__ = ["QuantizationStrategy", "QFormat"]


class QuantizationStrategy(str, enum.Enum):
    """How qparams are shared across a weight tensor."""

    TENSOR = "tensor"
    CHANNEL = "channel"
    GROUP = "group"


class QFormat(str, enum.Enum):
    """Quantized-execution format.

    QDQ: weights stored quantized, dequantized inside the matmul. QLINEAR: full
    integer compute with static input and output activations (the Q8 kernel).
    """

    QDQ = "qdq"
    QLINEAR = "qlinear"
