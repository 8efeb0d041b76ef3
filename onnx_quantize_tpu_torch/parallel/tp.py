"""Whole-model tensor parallelism: spec trees, meta localization, and each
rank's slice of a param tree.

Counterpart of ``onnx_quantize_tpu/parallel/tp.py``. The Megatron schedule
the engine's mesh path runs, each rank on its local weight shard with the
Hopper kernels at the local shapes:

  * column-parallel (q/k/v, gate/up, lm_head): weight split along N, input
    whole; the output stays split and feeds the paired row-parallel matmul;
  * row-parallel (o_proj, down_proj): weight split along K, input
    feature-local, one all-reduce after the local matmul, the bias after it
    (``nn.Linear.tp_reduce``);
  * embedding: vocab rows split, a masked lookup and an all-reduce;
  * lm_head: vocab-split logits, one all-gather at the end.

This module holds the model-agnostic part: :func:`localize_params` rewrites
QTensor metas to per-rank shapes (and re-lays-out fused columns),
:func:`build_param_specs` makes the partition-spec tree, and
:func:`shard_params_local` takes this rank's slice of a tree by it. The
engine runs them in that order on the global logical tree and only then
bakes the kernel scales of its local tree (a row-parallel shard holds an
even number of whole groups, so baking the shard gives the same pairs as
slicing a baked global tree). Models opt in with ``tp_localize(tp, axis)``
(``models/gemma3.py``).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor, QTensorMeta
from onnx_quantize_tpu_torch.parallel.mesh import P, shard_local

__all__ = ["site_kind", "localize_meta", "localize_params", "build_param_specs",
           "shard_params_local"]


def site_kind(name: str, rules):
    """First matching rule wins; unmatched sites replicate.

    A kind is a string ("column" / "row" / "replicate" / "vocab" / "expert")
    or, for horizontally fused sites, ``("fused_column", ((size, subkind),
    ...))`` where each segment is "column" (split over tp) or "replicate"."""
    for pattern, kind in rules:
        if re.search(pattern, name):
            return kind
    return "replicate"


def _fused_column_perm(tp: int, segments) -> tuple[np.ndarray, int]:
    """Column permutation turning a fused [seg0|seg1|...] weight into
    per-rank contiguous chunks [seg0_i|seg1_i|...] (replicated segments
    duplicated into every chunk). Returns (global column index, local width)."""
    offsets = np.cumsum([0] + [int(s) for s, _ in segments])
    cols = []
    for i in range(tp):
        for (size, sub), off in zip(segments, offsets):
            if sub == "column":
                if size % tp != 0:
                    raise ValueError(f"fused segment width {size} not divisible by tp={tp}")
                w = size // tp
                cols.append(np.arange(off + i * w, off + (i + 1) * w))
            elif sub == "replicate":
                cols.append(np.arange(off, off + size))
            else:
                raise ValueError(f"fused segment kind {sub!r} not supported")
    perm = np.concatenate(cols)
    return perm, perm.size // tp


def _take_columns(x, perm: np.ndarray):
    """``x`` with its last axis gathered by ``perm`` (scalars as they are)."""
    if x is None or x.ndim == 0:
        return x
    return x.index_select(x.ndim - 1, torch.as_tensor(perm, device=x.device))


def _localize_fused_qtensor(qt: QTensor, tp: int, segments) -> QTensor:
    """Re-lay-out a fused column-parallel QTensor's columns: the packed data
    (packed along K, so columns move freely), grouped scales (G, N) or
    (G_pad/2, 2, N), and per-channel scales (N,) follow one permutation."""
    perm, n_local = _fused_column_perm(tp, segments)
    meta = dataclasses.replace(qt.meta, shape=(qt.meta.shape[0], n_local))
    return dataclasses.replace(
        qt, data=_take_columns(qt.data, perm), scale=_take_columns(qt.scale, perm),
        zero_point=_take_columns(qt.zero_point, perm), meta=meta)


def localize_meta(meta: QTensorMeta, tp: int, kind: str) -> QTensorMeta:
    """Per-shard QTensorMeta for a column/row split quantized weight."""
    K, N = meta.shape
    if kind == "column":
        if N % tp != 0:
            raise ValueError(f"column-parallel N={N} not divisible by tp={tp}")
        return dataclasses.replace(meta, shape=(K, N // tp))
    if kind == "row":
        if K % tp != 0:
            raise ValueError(f"row-parallel K={K} not divisible by tp={tp}")
        K_local = K // tp
        if meta.packed:
            # Group-pair nibble packing: a K shard must hold an even number of
            # whole groups; non-GROUP packing interleaves the two K halves into
            # one virtual pair, which no K split keeps.
            gs = meta.pack_group
            if meta.strat.value != "group":
                raise ValueError(
                    "row-parallel 4-bit weight requires GROUP strategy "
                    f"(got {meta.strategy}: packing spans the K halves)")
            if K_local % gs != 0 or (K_local // gs) % 2 != 0:
                raise ValueError(
                    f"row-parallel shard K/tp={K_local} must be an even "
                    f"multiple of group_size={gs}")
        return dataclasses.replace(meta, shape=(K_local, N))
    return meta


def _qtensor_spec(qt: QTensor, kind: str, axis: str) -> QTensor:
    """A QTensor whose children are partition specs."""
    if kind == "expert":
        # Stacked MoE experts: every array child carries a leading expert
        # axis; split it, keep each expert's slices whole.
        def ch(x):
            return None if x is None else P(axis)

        return dataclasses.replace(
            qt, data=P(axis), scale=ch(qt.scale), zero_point=ch(qt.zero_point),
            input_scale=ch(qt.input_scale), input_zero_point=ch(qt.input_zero_point),
            output_scale=ch(qt.output_scale), output_zero_point=ch(qt.output_zero_point))
    nd = qt.scale.ndim
    if kind == "column":
        wspec = P(None, axis)
        # N is always the last scale axis: (N,), (G, N) and (G_pad/2, 2, N).
        sspec = P() if nd == 0 else P(*([None] * (nd - 1)), axis)
    elif kind == "row":
        wspec = P(axis, None)
        # Grouped scales follow their K groups (the leading axis of both the
        # logical and the baked layout); per-channel (N,) and per-tensor whole.
        sspec = P(axis, *([None] * (nd - 1))) if nd >= 2 else P()
    else:
        wspec = sspec = P()

    def act(x):
        return None if x is None else P()

    return dataclasses.replace(
        qt, data=wspec, scale=sspec, zero_point=sspec, input_scale=act(qt.input_scale),
        input_zero_point=act(qt.input_zero_point), output_scale=act(qt.output_scale),
        output_zero_point=act(qt.output_zero_point))


def localize_params(params: dict, rules, tp: int) -> dict:
    """Rewrite QTensor metas to per-shard shapes by the TP rules.

    Tensors stay global (each rank takes its slice with
    :func:`shard_params_local`), except at fused horizontal sites
    (``_fused_qkv`` / ``_fused_gate_up``), whose columns are re-laid-out into
    per-rank [q_i|k_i|v_i] chunks so that the contiguous N split lands each
    rank's segments together (replicated KV segments duplicated)."""

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        name = ".".join(path[:-1])
        kind = site_kind(name, rules)
        if isinstance(kind, tuple) and kind[0] == "fused_column":
            if isinstance(tree, QTensor):
                return _localize_fused_qtensor(tree, tp, kind[1])
            if isinstance(tree, torch.Tensor) and tree.ndim == 2 and path[-1] == "w":
                return _take_columns(tree, _fused_column_perm(tp, kind[1])[0])
            return tree
        if isinstance(tree, QTensor):
            meta = localize_meta(tree.meta, tp, kind)
            if kind == "row" and tree.meta.output_quant.mode == "static":
                raise ValueError(f"row-parallel site {name} cannot requantize its output "
                                 "statically before the all-reduce")
            return dataclasses.replace(tree, meta=meta)
        return tree

    return visit(params, ())


def build_param_specs(params: dict, rules, axis: str = "model"):
    """Partition-spec tree mirroring ``params`` (QTensor and QBias nodes
    included). Kinds: column / row / replicate / vocab (embedding rows split)
    / expert (the leading axis of stacked experts split)."""

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        if tree is None:
            return None
        name = ".".join(path[:-1])
        leaf_key = path[-1]
        kind = site_kind(name, rules)
        if isinstance(kind, tuple) and kind[0] == "fused_column":
            # Permuted into per-rank chunks by localize_params: plain column.
            kind = "column"
        if isinstance(tree, QTensor):
            return _qtensor_spec(tree, kind, axis)
        if isinstance(tree, QBias):
            spec = P(axis) if kind == "column" else P()
            return QBias(data=spec, scale=P(), zero_point=P(), quant_type=tree.quant_type)
        if kind == "expert":
            return P(axis)
        if leaf_key == "w" and tree.ndim == 2:
            if kind == "column":
                return P(None, axis)
            if kind in ("row", "vocab"):
                return P(axis, None)
            return P()
        if leaf_key == "b":
            # Row-parallel biases are added after the all-reduce, so they
            # replicate; column-parallel biases split with N.
            return P(axis) if kind == "column" else P()
        if leaf_key == "prescale":
            # The prescale multiplies x's features: row-parallel x is feature-local.
            return P(axis) if kind == "row" else P()
        return P()

    return visit(params, ())


def shard_params_local(params, specs, mesh):
    """This rank's slice of every tensor of ``params`` under ``specs`` (a tree
    from :func:`build_param_specs`); metas as they are."""
    if isinstance(params, dict):
        return {k: shard_params_local(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, (QTensor, QBias)):
        return dataclasses.replace(params, **{
            f.name: shard_params_local(getattr(params, f.name), getattr(specs, f.name), mesh)
            for f in dataclasses.fields(params) if f.name not in ("meta", "quant_type")})
    if params is None:
        return None
    return shard_local(params, specs, mesh)
