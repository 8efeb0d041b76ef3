"""Bridges to the port's QTensor: the JAX package's param trees, and the
reference's MatMulNBits artifact layout.

``from_jax_params`` walks a param tree of ``onnx_quantize_tpu`` (nested dicts
whose leaves are arrays, or QTensors read by attribute) and returns the same
tree over torch tensors, so both packages can run on the same weights. It
needs no JAX import: array leaves go through ``numpy.asarray``, a QTensor is
recognised by its ``data``/``scale``/``zero_point``/``meta`` attributes (its
static activation qparams cross with it; float zero points, as HQQ's, set
``QTensorMeta.float_zero_point``) and a QBias by
``data``/``scale``/``zero_point``/``quant_type``. Whatever leaves a tree holds
(q/k/v biases, an untied lm_head) cross the same way. The tree lands on the
CUDA device unless the caller names another.

``import_matmul_nbits``/``export_matmul_nbits`` translate a weights-only
group-quantized site from/to the reference's ``com.microsoft::MatMulNBits``
initializers (counterpart of ``onnx_quantize_tpu/interop.py``):

* ``data``: ``(N, n_blocks, block_size * bits // 8)`` uint8, the (K, N)
  codes transposed to (N, K), split into K-groups and (4-bit) nibble packed
  with the low nibble holding the even K index;
* ``scales``: ``(N, n_blocks)``;
* ``zero_points``: float (HQQ) or int; int 4-bit zero points with
  ``n_blocks > 1`` are nibble packed per row, padded to an even count with
  the 0x8 nibble; ``n_blocks == 1`` and float zero points stay unpacked.

The blobs are numpy arrays, as the reference's are, however they were
extracted from the model file.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.nn.qtensor import (
    ActQuantSpec,
    QBias,
    QTensor,
    QTensorMeta,
    make_qtensor,
    unpack_k_pairs,
)

__all__ = ["from_jax_params", "MatMulNBits", "import_matmul_nbits", "export_matmul_nbits"]


def _array_to_torch(a, device: torch.device | str) -> torch.Tensor:
    """An array (numpy, or anything ``numpy.asarray`` takes) as a torch tensor.

    bfloat16 arrays (an ml_dtypes dtype in numpy) cross as their bits."""
    arr = np.array(a, copy=True, order="C")  # a private, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _is_jax_qtensor(leaf) -> bool:
    return all(hasattr(leaf, name) for name in ("data", "scale", "zero_point", "meta"))


def _is_jax_qbias(leaf) -> bool:
    return all(hasattr(leaf, name) for name in ("data", "scale", "zero_point", "quant_type"))


def _act_spec(spec) -> ActQuantSpec:
    return ActQuantSpec(mode=spec.mode, dtype=spec.dtype, symmetric=spec.symmetric,
                        reduce_range=spec.reduce_range)


def _qtensor_to_torch(leaf, device) -> QTensor:
    m = leaf.meta
    meta = QTensorMeta(
        quant_type=m.quant_type, strategy=m.strategy, group_size=m.group_size,
        symmetric=m.symmetric, reduce_range=m.reduce_range, shape=tuple(m.shape),
        format=m.format, packed=m.packed, pack_group=m.pack_group,
        input_quant=_act_spec(m.input_quant), output_quant=_act_spec(m.output_quant),
        float_zero_point=bool(np.issubdtype(np.asarray(leaf.zero_point).dtype, np.floating)),
    )

    def optional(a):
        return None if a is None else _array_to_torch(a, device)

    return QTensor(data=_array_to_torch(leaf.data, device),
                   scale=_array_to_torch(leaf.scale, device),
                   zero_point=_array_to_torch(leaf.zero_point, device), meta=meta,
                   input_scale=optional(leaf.input_scale),
                   input_zero_point=optional(leaf.input_zero_point),
                   output_scale=optional(leaf.output_scale),
                   output_zero_point=optional(leaf.output_zero_point))


def from_jax_params(tree, device: torch.device | str = "cuda"):
    """The JAX package's param tree as the port's, on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    if _is_jax_qtensor(tree):
        return _qtensor_to_torch(tree, device)
    if _is_jax_qbias(tree):
        return QBias(data=_array_to_torch(tree.data, device),
                     scale=_array_to_torch(tree.scale, device),
                     zero_point=_array_to_torch(tree.zero_point, device),
                     quant_type=str(tree.quant_type))
    return _array_to_torch(tree, device)


@dataclasses.dataclass(frozen=True)
class MatMulNBits:
    """A reference-layout MatMulNBits site: the op's initializers and attributes."""

    data: np.ndarray          # (N, n_blocks, blob_size) uint8
    scales: np.ndarray        # (N, n_blocks)
    zero_points: np.ndarray   # packed uint8 / unpacked int / float, per layout
    K: int
    N: int
    bits: int
    block_size: int


def _unpack_nibble_rows(packed: np.ndarray, count: int) -> np.ndarray:
    """(rows, ceil(count/2)) packed uint8 -> (rows, count), low nibble first."""
    full = np.stack([packed & 0x0F, (packed >> 4) & 0x0F], axis=-1).reshape(packed.shape[0], -1)
    return full[:, :count]


def _pack_nibble_rows(vals: np.ndarray) -> np.ndarray:
    """(rows, count) -> (rows, ceil(count/2)) uint8; an odd count pads with the
    reference's 0x8 nibble."""
    rows, count = vals.shape
    v = vals.astype(np.uint8)
    if count % 2 == 1:
        v = np.concatenate([v, np.full((rows, 1), 0x8, np.uint8)], axis=1)
    return (v[:, ::2] & 0x0F) | ((v[:, 1::2] & 0x0F) << 4)


def import_matmul_nbits(data, scales, zero_points, *, K: int, N: int, bits: int,
                        block_size: int, device: torch.device | str = "cuda") -> QTensor:
    """A QTensor on ``device`` from MatMulNBits initializers: uint container
    values, GROUP strategy over K with ``block_size``, weights-only QDQ.
    ``zero_points=None`` is the symmetric default, the unsigned midpoint
    (an integer zero point here, so the site stays eligible for W4A8)."""
    if bits not in (4, 8):
        raise ValueError(f"MatMulNBits bits must be 4 or 8, got {bits}")
    if K % block_size != 0:
        raise ValueError(
            f"MatMulNBits requires block_size | K (got K={K}, block_size={block_size})")
    n_blocks = K // block_size
    qt_type = QuantType.QUInt4 if bits == 4 else QuantType.QUInt8

    blob = np.asarray(data, np.uint8).reshape(N, n_blocks, -1)
    if bits == 4:
        rows = _unpack_nibble_rows(blob.reshape(N * n_blocks, -1), block_size)
    else:
        rows = blob.reshape(N * n_blocks, block_size)
    q = np.ascontiguousarray(rows.reshape(N, K).T)  # (K, N) container values

    scales = np.asarray(scales).reshape(N, n_blocks)
    symmetric = zero_points is None
    if symmetric:
        zp = np.full((N, n_blocks), 1 << (bits - 1), np.uint8)
    else:
        zp_arr = np.asarray(zero_points)
        if np.issubdtype(zp_arr.dtype, np.floating):
            zp = zp_arr.reshape(N, n_blocks)  # HQQ's float zero points, never packed
        elif bits == 4 and n_blocks > 1:
            zp = _unpack_nibble_rows(zp_arr.reshape(N, -1), n_blocks)
        else:
            zp = zp_arr.reshape(N, n_blocks)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # make_qtensor's algorithm layout, (N * n_groups, 1) row-major over the
    # output channels: the reference's (N, n_blocks) flattened.
    return make_qtensor(t(q), t(scales.reshape(-1, 1)), t(np.asarray(zp).reshape(-1, 1)),
                        quant_type=qt_type, strategy=QuantizationStrategy.GROUP,
                        group_size=block_size, symmetric=symmetric, reduce_range=False,
                        fmt=QFormat.QDQ)


def export_matmul_nbits(qt: QTensor) -> MatMulNBits:
    """A weights-only GROUP QTensor (uint4/uint8, block_size | K) in the
    reference's blob layout: the inverse of :func:`import_matmul_nbits`. Takes
    the logical and the engine's baked scale layout."""
    meta = qt.meta
    K, N = meta.shape
    bits = meta.qt.bitwidth
    if meta.strat != QuantizationStrategy.GROUP:
        raise ValueError("MatMulNBits export requires GROUP strategy")
    if meta.qt not in (QuantType.QUInt4, QuantType.QUInt8):
        raise ValueError(f"MatMulNBits export supports uint4/uint8 weights, got {meta.qt}")
    block_size = min(meta.group_size if meta.group_size > 0 else K, K)
    if K % block_size != 0:
        raise ValueError(f"MatMulNBits export requires block_size | K (K={K}, bs={block_size})")
    n_blocks = K // block_size

    data = unpack_k_pairs(qt.data, K, False, meta.pack_group) if meta.packed else qt.data
    q = data.cpu().numpy().astype(np.uint8)
    rows = q.T.reshape(N * n_blocks, block_size)  # (N, K) split into K-groups
    blob = _pack_nibble_rows(rows) if bits == 4 else rows
    blob = blob.reshape(N, n_blocks, block_size * bits // 8)

    scale = qt.scale.cpu().numpy()
    zp = qt.zero_point.cpu().numpy()
    if scale.ndim == 3:  # the engine's baked (G_pad/2, 2, N) layout
        scale = scale.reshape(-1, N)[:n_blocks]
        zp = zp.reshape(-1, N)[:n_blocks]
    scales = scale.reshape(n_blocks, N).T.copy()
    zpT = zp.reshape(n_blocks, N).T
    if np.issubdtype(zpT.dtype, np.floating) and not np.all(zpT == np.round(zpT)):
        zero_points = zpT.copy()  # HQQ's float zero points stay unpacked
    elif bits == 4 and n_blocks > 1:
        zero_points = _pack_nibble_rows(zpT.astype(np.uint8))
    else:
        zero_points = zpT.astype(np.uint8).copy()
    return MatMulNBits(data=blob, scales=scales, zero_points=zero_points, K=K, N=N, bits=bits,
                       block_size=block_size)
