"""Quantization element types and their integer ranges.

Counterpart of ``onnx_quantize_tpu/core/dtypes.py`` without the JAX and
ml_dtypes parts: 4-bit values live in 8-bit torch containers, so no 4-bit
array dtype is needed.
"""

from __future__ import annotations

import enum

import torch

__all__ = ["QuantType"]


# Full asymmetric ranges.
_DTYPE_RANGES: dict[str, tuple[int, int]] = {
    "uint4": (0, 15),
    "int4": (-8, 7),
    "uint8": (0, 255),
    "int8": (-128, 127),
    "uint32": (0, 2**32 - 1),
    "int32": (-(2**31), 2**31 - 1),
}

# Symmetric ranges for signed types.
_SYMMETRIC_RANGES: dict[str, tuple[int, int]] = {
    "int4": (-7, 7),
    "int8": (-127, 127),
    "int32": (-(2**31 - 1), 2**31 - 1),
}

# Reduced ranges. Note int8 is (-64, 64), not (-64, 63).
_REDUCED_RANGES: dict[str, tuple[int, int]] = {
    "uint4": (0, 7),
    "int4": (-4, 3),
    "uint8": (0, 127),
    "int8": (-64, 64),
    "uint32": (0, 2**31 - 1),
    "int32": (-(2**30), 2**30),
}

# 8/32-bit torch container used for (unpacked) integer codes. torch has no
# uint32 arithmetic worth relying on, so uint32 codes live in int64.
_CONTAINER_DTYPES = {
    "int4": torch.int8,
    "uint4": torch.uint8,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "uint32": torch.int64,
}

_BITWIDTH = {"int4": 4, "uint4": 4, "int8": 8, "uint8": 8, "int32": 32, "uint32": 32}


class QuantType(enum.Enum):
    """Enumeration of supported quantization element types."""

    QInt4 = "int4"
    QUInt4 = "uint4"
    QInt8 = "int8"
    QUInt8 = "uint8"
    QInt32 = "int32"
    QUInt32 = "uint32"

    @classmethod
    def from_string(cls, value: str) -> "QuantType":
        key = value.lower().strip()
        for member in cls:
            if member.value == key:
                return member
        raise ValueError(
            f"Invalid quantization type '{value}'. "
            f"Expected one of: {', '.join(m.value for m in cls)}"
        )

    @property
    def container_dtype(self) -> torch.dtype:
        """Torch dtype holding the (unpacked) integer codes."""
        return _CONTAINER_DTYPES[self.value]

    @property
    def bitwidth(self) -> int:
        return _BITWIDTH[self.value]

    @property
    def is_signed(self) -> bool:
        return not self.value.startswith("u")

    def qrange(self, is_symmetric: bool, reduce_range: bool = False) -> tuple[int, int]:
        """Return the (qmin, qmax) integer range.

        Reduced range wins over symmetric; symmetric applies only to signed
        types.
        """
        if reduce_range:
            return _REDUCED_RANGES[self.value]
        if is_symmetric and self.value in _SYMMETRIC_RANGES:
            return _SYMMETRIC_RANGES[self.value]
        return _DTYPE_RANGES[self.value]
