"""Quantized matmuls with the collective pipelined around the local kernel.

Counterpart of ``onnx_quantize_tpu/parallel/collective.py``:

* :func:`allgather_matmul` — a column-parallel matmul whose rows arrive
  split over the axis (a sequence-parallel residual stream): in each of the
  ``tp`` steps the rank starts the ring shift of the row block it holds,
  runs the local kernel on that block, then waits for the next one;
* :func:`matmul_reduce_scatter` — a row-parallel matmul whose sum leaves
  split by rows: the partial-sum accumulator rides the ring, each rank adding
  its block as it passes;
* :func:`sequence_parallel_pair` — the two as one Megatron pair, rows split
  in and out, the intermediate N-split on its rank.

The shifts go through ``comm.ppermute_start`` (``batch_isend_irecv``), so
the local kernel is queued before the wait. Under nccl they overlap the
kernel; under gloo a CUDA block is staged through host memory first, and the
overlap is the host transfer's only.

Every rank calls with the global input and weight and gets its block of the
JAX function's result: (M, N/tp) for :func:`allgather_matmul`, (M/tp, N) for
the other two.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.parallel.comm import axis_index, axis_size, ppermute_start
from onnx_quantize_tpu_torch.parallel.mesh import P, Mesh, shard_local, use_mesh
from onnx_quantize_tpu_torch.parallel.tp_ops import local_qtensor

__all__ = ["allgather_matmul", "matmul_reduce_scatter", "sequence_parallel_pair"]


def _ring_perm(tp: int, fwd: bool = True):
    if fwd:
        return [(i, (i + 1) % tp) for i in range(tp)]
    return [(i, (i - 1) % tp) for i in range(tp)]


def _matmul(x, qt):
    from onnx_quantize_tpu_torch.ops import quantized_matmul

    return quantized_matmul(x, qt, None)


def _ag_matmul_local(x_loc, qt_loc, axis: str):
    """all_gather(x) @ W_local, pipelined. ``x_loc``: (M/tp, K), this rank's
    row block; returns (M, N/tp)."""
    tp, idx = axis_size(axis), axis_index(axis)
    m_blk = x_loc.shape[0]
    out = torch.zeros((m_blk * tp, qt_loc.meta.shape[1]), dtype=torch.float32,
                      device=x_loc.device)
    cur = x_loc
    for step in range(tp):
        # After `step` backward shifts this rank holds the block that started
        # on rank (idx + step): start the next shift, compute its rows.
        pending = ppermute_start([cur], axis, _ring_perm(tp, fwd=False)) if step + 1 < tp else None
        row = ((idx + step) % tp) * m_blk
        out[row:row + m_blk] = _matmul(cur, qt_loc).to(torch.float32)
        if pending is not None:
            cur = pending.wait()[0]
    return out


def _matmul_rs_local(h_loc, qt_loc, axis: str):
    """(h @ W_local) reduce-scattered over rows. ``h_loc``: (M, K/tp);
    returns (M/tp, N), this rank's summed row block."""
    tp, idx = axis_size(axis), axis_index(axis)
    y = _matmul(h_loc, qt_loc).to(torch.float32)
    m_blk = y.shape[0] // tp

    def blk(i):
        i %= tp
        return y[i * m_blk:(i + 1) * m_blk]

    # Invariant: at step s the accumulator on rank d carries block
    # b = d - 1 - s (mod tp); made on rank b + 1, it rides the forward ring
    # picking up each rank's partial and lands summed on its owner after
    # tp - 1 hops.
    acc = blk(idx - 1)
    for step in range(1, tp):
        acc = ppermute_start([acc], axis, _ring_perm(tp, fwd=True)).wait()[0]
        acc = acc + blk(idx - 1 - step)
    return acc


def allgather_matmul(x, qt: QTensor, mesh: Mesh, *, axis: str = "model"):
    """Column-parallel matmul from an M-split ``x`` (M, K): this rank's
    (M, N/tp) block of the (M, N) result."""
    with use_mesh(mesh):
        return _ag_matmul_local(shard_local(x, P(axis, None), mesh),
                                local_qtensor(qt, mesh, axis, "column"), axis)


def matmul_reduce_scatter(h, qt: QTensor, mesh: Mesh, *, axis: str = "model"):
    """Row-parallel matmul from a K-split ``h`` (M, K): this rank's (M/tp, N)
    row block of the summed result."""
    with use_mesh(mesh):
        return _matmul_rs_local(shard_local(h, P(None, axis), mesh),
                                local_qtensor(qt, mesh, axis, "row"), axis)


def sequence_parallel_pair(x, qt_up: QTensor, qt_down: QTensor, mesh: Mesh, activation=None,
                           *, axis: str = "model"):
    """Rows split in, pipelined all-gather + column matmul, the activation on
    the rank's N block, row matmul + pipelined reduce-scatter, rows split
    out: this rank's (M/tp, N_out) block."""
    with use_mesh(mesh):
        x_loc = shard_local(x, P(axis, None), mesh)
        h = _ag_matmul_local(x_loc, local_qtensor(qt_up, mesh, axis, "column"), axis)
        if activation is not None:
            h = activation(h)
        return _matmul_rs_local(h.to(x_loc.dtype), local_qtensor(qt_down, mesh, axis, "row"),
                                axis)
