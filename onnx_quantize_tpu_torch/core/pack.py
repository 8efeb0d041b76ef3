"""4-bit nibble packing of flat arrays.

Counterpart of ``onnx_quantize_tpu/core/pack.py``: two 4-bit values per byte,
the even element in the low nibble and the odd one in the high nibble, an
odd-length array padded with one zero nibble; signed int4 as two's-complement
nibbles ((-8..-1) -> (8..15)). 8- and 32-bit types pass through, cast to
their container dtype.

Two implementations with one layout: numpy (:func:`pack`, :func:`unpack`)
for the host and checkpoints, and torch (:func:`pack_torch`,
:func:`unpack_torch`) on the tensor's device, where the reference has its jnp
pair. (Weights use the group-pair layout of ``nn/qtensor.py``; this flat
layout is the reference's storage format.)
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType

__all__ = ["pack", "unpack", "pack_torch", "unpack_torch"]

# The host containers are the reference's numpy ones (uint32 stays uint32;
# the torch containers hold it in int64).
_NUMPY_CONTAINERS = {"int4": np.int8, "uint4": np.uint8, "int8": np.int8, "uint8": np.uint8,
                     "int32": np.int32, "uint32": np.uint32}


def _np_container(quant_type: QuantType):
    return _NUMPY_CONTAINERS[quant_type.value]


def pack(array: np.ndarray, quant_type: QuantType) -> np.ndarray:
    """Pack an integer array for storage (4-bit types two to a uint8 byte)."""
    array = np.asarray(array)
    if quant_type.bitwidth != 4:
        return array.astype(_np_container(quant_type))
    vals = array.astype(np.int32).ravel()
    if quant_type is QuantType.QInt4:
        vals = np.where(vals < 0, vals + 16, vals)
    flat = vals.astype(np.uint8)
    if flat.size % 2 == 1:
        flat = np.concatenate([flat, np.zeros(1, dtype=np.uint8)])
    return ((flat[0::2] & 0x0F) | ((flat[1::2] & 0x0F) << 4)).astype(np.uint8)


def unpack(array: np.ndarray, dims: tuple[int, ...], quant_type: QuantType) -> np.ndarray:
    """Unpack to the container dtype with shape ``dims``."""
    array = np.asarray(array)
    if quant_type.bitwidth != 4:
        return array.astype(_np_container(quant_type)).reshape(dims)
    count = int(np.prod(dims))
    packed = array.ravel().astype(np.uint8)
    out = np.empty(packed.size * 2, dtype=np.uint8)
    out[0::2] = packed & 0x0F
    out[1::2] = (packed >> 4) & 0x0F
    out = out[:count]
    if quant_type is QuantType.QInt4:
        signed = out.astype(np.int8)
        return np.where(signed > 7, signed - 16, signed).astype(np.int8).reshape(dims)
    return out.reshape(dims)


def pack_torch(array: torch.Tensor, quant_type: QuantType) -> torch.Tensor:
    """:func:`pack` on the tensor's device."""
    if quant_type.bitwidth != 4:
        return array.to(quant_type.container_dtype)
    vals = array.to(torch.int32).reshape(-1)
    if quant_type is QuantType.QInt4:
        vals = torch.where(vals < 0, vals + 16, vals)
    flat = vals.to(torch.uint8)
    if flat.numel() % 2 == 1:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return (flat[0::2] & 0x0F) | ((flat[1::2] & 0x0F) << 4)


def unpack_torch(array: torch.Tensor, dims: tuple[int, ...],
                 quant_type: QuantType) -> torch.Tensor:
    """:func:`unpack` on the tensor's device."""
    if quant_type.bitwidth != 4:
        return array.to(quant_type.container_dtype).reshape(dims)
    count = int(np.prod(dims))
    packed = array.reshape(-1).to(torch.uint8)
    out = torch.stack([packed & 0x0F, packed >> 4], dim=1).reshape(-1)[:count]
    if quant_type is QuantType.QInt4:
        signed = out.to(torch.int8)
        return torch.where(signed > 7, signed - 16, signed).reshape(dims)
    return out.reshape(dims)
