"""Tensor-parallel quantized matmuls, one rank's part.

Counterpart of ``onnx_quantize_tpu/parallel/tp_ops.py``. Every rank calls
the function with the same global ``x`` and QTensor; it takes its own shard
by its coordinate on ``axis``, runs the Hopper kernel at the local shape
(``ops.quantized_matmul``, the same registry as one device) and the
collective explicitly:

  * column-parallel: x whole, N split; the output all-gathered, or kept as
    the rank's N block for a following row-parallel op;
  * row-parallel: x split along features, K split; one all-reduce;
  * the column->row pair (q/k/v->o, gate/up->down) with one all-reduce and
    no gather between the two (the Megatron MLP schedule).

Call them inside ``parallel.mesh.use_mesh(mesh)`` or pass ``mesh``; the
result is, on every rank, the JAX function's result where that is
replicated, and the rank's block of it where it is split.
"""

from __future__ import annotations

import dataclasses

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.parallel.comm import all_gather, all_reduce
from onnx_quantize_tpu_torch.parallel.mesh import P, Mesh, shard_local, use_mesh
from onnx_quantize_tpu_torch.parallel.tp import _qtensor_spec, localize_meta, shard_params_local

__all__ = ["column_parallel_matmul", "row_parallel_matmul", "tp_pair_matmul"]


def local_qtensor(qt: QTensor, mesh: Mesh, axis: str, kind: str) -> QTensor:
    """This rank's column ("column") or row ("row") shard of a global QTensor."""
    qt = dataclasses.replace(qt, meta=localize_meta(qt.meta, mesh.shape[axis], kind))
    return shard_params_local(qt, _qtensor_spec(qt, kind, axis), mesh)


def _matmul(x, qt, bias=None):
    from onnx_quantize_tpu_torch.ops import quantized_matmul

    return quantized_matmul(x, qt, bias)


def column_parallel_matmul(x, qt: QTensor, mesh: Mesh, *, axis: str = "model", bias=None,
                           gather_output: bool = True):
    """x whole, weight split along N: the local kernel, then (with
    ``gather_output``) one all-gather of the (M, N/tp) blocks."""
    with use_mesh(mesh):
        b = None if bias is None else shard_local(bias, P(axis), mesh)
        y = _matmul(x, local_qtensor(qt, mesh, axis, "column"), b)
        return all_gather(y, axis, dim=y.ndim - 1) if gather_output else y


def row_parallel_matmul(x, qt: QTensor, mesh: Mesh, *, axis: str = "model", bias=None):
    """x split along features, weight along K: the local kernel, one
    all-reduce, then the bias."""
    with use_mesh(mesh):
        x_loc = shard_local(x, P(*([None] * (x.ndim - 1)), axis), mesh)
        y = all_reduce(_matmul(x_loc, local_qtensor(qt, mesh, axis, "row")), axis)
        return y if bias is None else y + bias


def tp_pair_matmul(x, qt_up: QTensor, qt_down: QTensor, mesh: Mesh, activation=None, *,
                   axis: str = "model"):
    """A column->row pair (up_proj -> down_proj) with a single all-reduce: the
    intermediate stays N-split on its rank."""
    with use_mesh(mesh):
        h = _matmul(x, local_qtensor(qt_up, mesh, axis, "column"))
        if activation is not None:
            h = activation(h)
        return all_reduce(_matmul(h, local_qtensor(qt_down, mesh, axis, "row")), axis)
