"""The reference's MatMulNBits layout in the port, held to the JAX package.

Counterpart of ``tests/test_interop.py``: import from blobs built by an
independent statement of the published layout (not by the exporter), the
0x8 pad nibble of an odd block count, export/import round trips, HQQ float
zero points, the symmetric default and the refusals. Cross-package: the
port's exported bytes, scales and zero points equal JAX's export of the same
site, and JAX's export imports into the port with equal codes. Integer data
exact; dequantized weights within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu import interop as jinterop
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jmake_qtensor
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import (
    MatMulNBits,
    export_matmul_nbits,
    from_jax_params,
    import_matmul_nbits,
)
from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor, unpack_k_pairs
from onnx_quantize_tpu_torch.ops.reference import dequantize_weight


def _mk(q, scale, zp, qt_type, gs, symmetric=False):
    return make_qtensor(torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(zp),
                        quant_type=qt_type, strategy=QuantizationStrategy.GROUP, group_size=gs,
                        symmetric=symmetric, reduce_range=False)


def _reference_pack(q, scale, zp, bits, gs):
    """Independent re-statement of the reference blob layout (test oracle)."""
    K, N = q.shape
    n_blocks = K // gs
    rows = q.T.reshape(N * n_blocks, gs).astype(np.uint8)
    blob = (rows[:, ::2] & 0x0F) | ((rows[:, 1::2] & 0x0F) << 4) if bits == 4 else rows
    blob = blob.reshape(N, n_blocks, gs * bits // 8)
    scales = scale.reshape(n_blocks, N).T.copy()
    zpT = zp.reshape(n_blocks, N).T.astype(np.uint8)
    if bits == 4 and n_blocks > 1:
        if n_blocks % 2 == 1:
            zpT = np.concatenate([zpT, np.full((N, 1), 0x8, np.uint8)], axis=1)
        zp_out = (zpT[:, ::2] & 0x0F) | ((zpT[:, 1::2] & 0x0F) << 4)
    else:
        zp_out = zpT
    return blob, scales, zp_out


def _codes(qt, K):
    return (unpack_k_pairs(qt.data, K, False, qt.meta.pack_group) if qt.meta.packed
            else qt.data).numpy()


@pytest.mark.parametrize("bits,gs,K,N", [(4, 16, 64, 8), (4, 32, 96, 16), (8, 16, 48, 8)])
def test_import_from_independent_reference_blob(bits, gs, K, N):
    rng = np.random.default_rng(0)
    n_blocks = K // gs
    q = rng.integers(0, 2**bits, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((n_blocks, N))).astype(np.float32)
    zp = rng.integers(0, 2**bits, size=(n_blocks, N)).astype(np.uint8)
    blob, scales_ref, zp_ref = _reference_pack(q, scale, zp, bits, gs)
    qt = import_matmul_nbits(blob, scales_ref, zp_ref, K=K, N=N, bits=bits, block_size=gs,
                             device="cpu")
    np.testing.assert_array_equal(_codes(qt, K), q)
    expect = (q.astype(np.float32) - np.repeat(zp, gs, axis=0)) * np.repeat(scale, gs, axis=0)
    np.testing.assert_allclose(dequantize_weight(qt).numpy(), expect, rtol=1e-6)
    # JAX's import of the same blobs: equal codes and qparams.
    jqt = jinterop.import_matmul_nbits(blob, scales_ref, zp_ref, K=K, N=N, bits=bits,
                                       block_size=gs)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(qt.zero_point.numpy(), np.asarray(jqt.zero_point))


def test_odd_block_zp_padding_nibble():
    """Odd n_blocks: the zp pad nibble is 0x8, per the reference example."""
    K, N, gs = 48, 4, 16  # 3 blocks
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = np.full((3, N), 0.5, np.float32)
    zp = rng.integers(0, 16, size=(3, N)).astype(np.uint8)
    qt = _mk(q, scale.reshape(N * 3, 1, order="F"), zp.reshape(N * 3, 1, order="F"),
             QuantType.QUInt4, gs)
    art = export_matmul_nbits(qt)
    assert art.zero_points.shape == (N, 2)
    np.testing.assert_array_equal(art.zero_points[:, -1] >> 4, np.full(N, 0x8))
    np.testing.assert_array_equal(art.zero_points[:, 0] & 0x0F, zp[0])
    np.testing.assert_array_equal(art.zero_points[:, 0] >> 4, zp[1])
    np.testing.assert_array_equal(art.zero_points[:, 1] & 0x0F, zp[2])


@pytest.mark.parametrize("bits,gs,K,N", [(4, 16, 64, 8), (4, 64, 128, 128), (8, 32, 64, 8)])
def test_export_import_round_trip_and_bytes_equal_jax(bits, gs, K, N):
    rng = np.random.default_rng(2)
    n_blocks = K // gs
    qt_type = QuantType.QUInt4 if bits == 4 else QuantType.QUInt8
    q = rng.integers(0, 2**bits, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((N * n_blocks, 1))).astype(np.float32)
    zp = rng.integers(0, 2**bits, size=(N * n_blocks, 1)).astype(np.float32)
    qt = _mk(q, scale, zp, qt_type, gs)
    art = export_matmul_nbits(qt)
    assert isinstance(art, MatMulNBits)
    assert (art.K, art.N, art.bits, art.block_size) == (K, N, bits, gs)
    qt2 = import_matmul_nbits(art.data, art.scales, art.zero_points, K=K, N=N, bits=bits,
                              block_size=gs, device="cpu")
    np.testing.assert_allclose(dequantize_weight(qt2).numpy(), dequantize_weight(qt).numpy(),
                               rtol=1e-6)
    blob, scales_ref, zp_ref = _reference_pack(q, qt.scale.numpy(),
                                               qt.zero_point.numpy().astype(np.uint8), bits, gs)
    np.testing.assert_array_equal(art.data, blob)
    np.testing.assert_array_equal(art.scales, scales_ref)
    np.testing.assert_array_equal(art.zero_points, zp_ref)
    # JAX's export of the same site: the same bytes, scales and zero points.
    jqt = jmake_qtensor(q, scale, zp, quant_type=JQuantType(qt_type.value),
                        strategy=JStrategy.GROUP, group_size=gs, symmetric=False,
                        reduce_range=False)
    jart = jinterop.export_matmul_nbits(jqt)
    for field in ("data", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(art, field), getattr(jart, field))
        assert getattr(art, field).dtype == getattr(jart, field).dtype
    # The engine's baked scale layout exports the same artifact.
    baked = prepare_kernel_scales({"w": qt})["w"]
    if baked.scale.ndim == 3:
        for field in ("data", "scales", "zero_points"):
            np.testing.assert_array_equal(getattr(export_matmul_nbits(baked), field),
                                          getattr(art, field))
    # JAX's site bridged into the port exports JAX's bytes too.
    bridged = from_jax_params({"w": jqt}, device="cpu")["w"]
    np.testing.assert_array_equal(export_matmul_nbits(bridged).data, jart.data)


def test_float_zp_round_trip():
    """HQQ-style float zero points stay unpacked floats end to end."""
    K, N, gs = 64, 8, 16
    rng = np.random.default_rng(3)
    n_blocks = K // gs
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((N * n_blocks, 1))).astype(np.float32)
    zp = (rng.random((N * n_blocks, 1)) * 15).astype(np.float32)
    qt = _mk(q, scale, zp, QuantType.QUInt4, gs)
    art = export_matmul_nbits(qt)
    assert np.issubdtype(art.zero_points.dtype, np.floating)
    assert art.zero_points.shape == (N, n_blocks)
    qt2 = import_matmul_nbits(art.data, art.scales, art.zero_points, K=K, N=N, bits=4,
                              block_size=gs, device="cpu")
    assert qt2.meta.float_zero_point
    np.testing.assert_allclose(dequantize_weight(qt2).numpy(), dequantize_weight(qt).numpy(),
                               rtol=1e-6)


def test_symmetric_import_without_zp():
    K, N, gs = 32, 8, 16
    rng = np.random.default_rng(4)
    q = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    scale = (0.01 + rng.random((N * 2, 1))).astype(np.float32)
    blob, scales_ref, _ = _reference_pack(q, scale.reshape(N, 2).T, np.zeros((2, N), np.uint8),
                                          4, gs)
    qt = import_matmul_nbits(blob, scales_ref, None, K=K, N=N, bits=4, block_size=gs,
                             device="cpu")
    assert qt.meta.symmetric and not qt.meta.float_zero_point
    np.testing.assert_array_equal(qt.zero_point.numpy(), 8)  # the unsigned midpoint
    jqt = jinterop.import_matmul_nbits(blob, scales_ref, None, K=K, N=N, bits=4, block_size=gs)
    np.testing.assert_array_equal(qt.zero_point.numpy(), np.asarray(jqt.zero_point))


def test_rejections():
    with pytest.raises(ValueError, match="bits"):
        import_matmul_nbits(np.zeros((1, 1, 8), np.uint8), np.ones((1, 1)), None,
                            K=16, N=1, bits=5, block_size=16, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        import_matmul_nbits(np.zeros((1, 1, 8), np.uint8), np.ones((1, 1)), None,
                            K=20, N=1, bits=4, block_size=16, device="cpu")
    qt = make_qtensor(torch.zeros((16, 8), dtype=torch.int8), torch.ones((8, 1)),
                      torch.zeros((8, 1)), quant_type=QuantType.QInt4,
                      strategy=QuantizationStrategy.GROUP, group_size=16, symmetric=True,
                      reduce_range=False)
    with pytest.raises(ValueError, match="uint4/uint8"):
        export_matmul_nbits(qt)
