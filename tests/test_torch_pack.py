"""4-bit nibble packing in the port, held to the JAX package.

Counterpart of ``tests/core/test_pack.py``: the numpy pair and the torch pair
(the reference's jnp pair) give the JAX package's bytes and values exactly.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.core import pack as jpack
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.pack import pack, pack_torch, unpack, unpack_torch


def test_pack_uint4_hand_computed():
    # even element -> low nibble, odd element -> high nibble
    packed = pack(np.array([1, 2, 3, 4], dtype=np.uint8), QuantType.QUInt4)
    np.testing.assert_array_equal(packed, np.array([0x21, 0x43], dtype=np.uint8))


def test_pack_int4_twos_complement():
    packed = pack(np.array([-1, 7, -8, 0], dtype=np.int8), QuantType.QInt4)
    np.testing.assert_array_equal(packed, np.array([0x7F, 0x08], dtype=np.uint8))


def test_pack_odd_length_pads_zero_nibble():
    packed = pack(np.array([5, 6, 7], dtype=np.uint8), QuantType.QUInt4)
    np.testing.assert_array_equal(packed, np.array([0x65, 0x07], dtype=np.uint8))


def _values(qt, shape, seed=42):
    lo, hi = qt.qrange(is_symmetric=False)
    dtype = np.int8 if qt.is_signed else np.uint8
    return np.random.default_rng(seed).integers(lo, hi + 1, size=shape).astype(dtype)


@pytest.mark.parametrize("qt", [QuantType.QInt4, QuantType.QUInt4])
@pytest.mark.parametrize("shape", [(6,), (3, 5), (4, 4), (7,)])
def test_pack_unpack_roundtrip_4bit_equal_jax(qt, shape):
    arr = _values(qt, shape)
    packed = pack(arr, qt)
    out = unpack(packed, shape, qt)
    np.testing.assert_array_equal(out, arr)
    assert out.dtype == arr.dtype
    jqt = JQuantType(qt.value)
    np.testing.assert_array_equal(packed, jpack.pack(arr, jqt))
    jout = jpack.unpack(packed, shape, jqt)
    np.testing.assert_array_equal(out, jout)
    assert out.dtype == jout.dtype


@pytest.mark.parametrize("qt", [QuantType.QInt8, QuantType.QUInt8, QuantType.QInt32,
                                QuantType.QUInt32])
def test_pack_8_32bit_passthrough(qt):
    lo = -100 if qt.is_signed else 0
    arr = np.random.default_rng(42).integers(lo, 100, size=(4, 3))
    packed = pack(arr, qt)
    jqt = JQuantType(qt.value)
    assert packed.dtype == jqt.container_dtype
    np.testing.assert_array_equal(unpack(packed, (4, 3), qt), arr.astype(jqt.container_dtype))
    assert unpack(packed, (4, 3), qt).dtype == jpack.unpack(packed, (4, 3), jqt).dtype


@pytest.mark.parametrize("qt", [QuantType.QInt4, QuantType.QUInt4])
@pytest.mark.parametrize("shape", [(5, 4), (7,), (3, 3)])
def test_torch_pack_matches_numpy(qt, shape):
    arr = _values(qt, shape, seed=7)
    packed = pack(arr, qt)
    t = torch.from_numpy(arr)
    assert pack_torch(t, qt).dtype == torch.uint8
    np.testing.assert_array_equal(pack_torch(t, qt).numpy(), packed)
    out = unpack_torch(torch.from_numpy(packed), shape, qt)
    assert out.dtype == qt.container_dtype
    np.testing.assert_array_equal(out.numpy(), unpack(packed, shape, qt))


@pytest.mark.parametrize("qt", [QuantType.QInt8, QuantType.QUInt8, QuantType.QInt32])
def test_torch_pack_8_32bit_passthrough(qt):
    t = torch.arange(12).reshape(4, 3)
    assert pack_torch(t, qt).dtype == qt.container_dtype
    assert torch.equal(unpack_torch(pack_torch(t, qt), (4, 3), qt), t.to(qt.container_dtype))
