"""Bridge from the JAX package's param trees to the port's.

``from_jax_params`` walks a param tree of ``onnx_quantize_tpu`` (nested dicts
whose leaves are arrays, or QTensors read by attribute) and returns the same
tree over torch tensors, so both packages can run on the same weights. It
needs no JAX import: array leaves go through ``numpy.asarray``, a QTensor is
recognised by its ``data``/``scale``/``zero_point``/``meta`` attributes (its
static activation qparams cross with it) and a QBias by
``data``/``scale``/``zero_point``/``quant_type``. The tree lands on the CUDA
device unless the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, QTensor, QTensorMeta

__all__ = ["from_jax_params"]


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
