"""Bridge from the JAX package's param trees to the port's.

``from_jax_params`` walks a param tree of ``onnx_quantize_tpu`` (nested dicts
whose leaves are arrays, or QTensors read by attribute) and returns the same
tree over torch tensors, so both packages can run on the same weights. It
needs no JAX import: array leaves go through ``numpy.asarray``, and a QTensor
is recognised by its ``data``/``scale``/``zero_point``/``meta`` attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor, QTensorMeta

__all__ = ["from_jax_params"]


def _array_to_torch(a, device: torch.device | str = "cpu") -> torch.Tensor:
    """An array (numpy, or anything ``numpy.asarray`` takes) as a torch tensor.

    bfloat16 arrays (an ml_dtypes dtype in numpy) cross as their bits."""
    arr = np.array(a, copy=True, order="C")  # a private, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _is_jax_qtensor(leaf) -> bool:
    return all(hasattr(leaf, name) for name in ("data", "scale", "zero_point", "meta"))


def _qtensor_to_torch(leaf, device) -> QTensor:
    m = leaf.meta
    if m.input_quant.mode != "none" or m.output_quant.mode != "none":
        raise NotImplementedError(
            "Activation-quantized QTensors are not ported to PyTorch yet; see ROADMAP.md, "
            "Queue A item 10."
        )
    meta = QTensorMeta(
        quant_type=m.quant_type, strategy=m.strategy, group_size=m.group_size,
        symmetric=m.symmetric, reduce_range=m.reduce_range, shape=tuple(m.shape),
        format=m.format, packed=m.packed, pack_group=m.pack_group,
    )
    return QTensor(data=_array_to_torch(leaf.data, device),
                   scale=_array_to_torch(leaf.scale, device),
                   zero_point=_array_to_torch(leaf.zero_point, device), meta=meta)


def from_jax_params(tree, device: torch.device | str = "cpu"):
    """The JAX package's param tree as the port's, on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    if _is_jax_qtensor(tree):
        return _qtensor_to_torch(tree, device)
    return _array_to_torch(tree, device)
