"""Tensor-parallel layouts of a quantized param tree, site by site.

Counterpart of ``onnx_quantize_tpu/parallel/sharding.py``: per-site Megatron
layouts, column-parallel (q/k/v, gate/up, lm_head: packed data ``(K/2, N)``
and scale rows ``(G, N)`` split along N together) and row-parallel (o_proj,
down_proj: in-features split, grouped scales with their K groups),
embeddings split by vocab rows, everything else whole. A row split of a
grouped weight whose groups do not align with the shards warns and
replicates instead.

The JAX package places global arrays for the compiler to partition; the
port has no such compiler, so here a layout is this rank's slice: each
function returns the local tensors, QTensor metas set to the local shapes.
"""

from __future__ import annotations

import dataclasses
import logging

from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor
from onnx_quantize_tpu_torch.parallel.mesh import P, Mesh, shard_local
from onnx_quantize_tpu_torch.parallel.tp import site_kind

logger = logging.getLogger(__name__)

__all__ = ["GEMMA3_TP_RULES", "shard_params", "qtensor_shardings"]

# site-name regex -> "column" | "row" | "replicate"
GEMMA3_TP_RULES: list[tuple[str, str]] = [
    (r"\.attn\.(q_proj|k_proj|v_proj)$", "column"),
    (r"\.attn\.o_proj$", "row"),
    (r"\.mlp\.(gate_proj|up_proj)$", "column"),
    (r"\.mlp\.down_proj$", "row"),
    (r"^lm_head$", "column"),
]


def _weight_spec(kind: str) -> P:
    if kind == "column":
        return P(None, "model")
    if kind == "row":
        return P("model", None)
    return P()


def qtensor_shardings(qt: QTensor, kind: str, mesh: Mesh) -> QTensor:
    """This rank's slice of a QTensor under the TP layout (data and scales together)."""
    if kind == "row" and qt.meta.strategy == "group":
        shards = mesh.shape["model"]
        K, gs = qt.meta.shape[0], qt.meta.group_size
        if (K // shards) % gs != 0:
            logger.warning(
                "Row-parallel sharding of %s-grouped weight with gs=%d does not "
                "align with %d shards; replicating.", qt.meta.strategy, gs, shards)
            kind = "replicate"
    wspec = _weight_spec(kind)
    nd = qt.scale.ndim
    if kind == "column":
        sspec = P() if nd == 0 else P(*([None] * (nd - 1)), "model")
    elif kind == "row":
        sspec = P("model", *([None] * (nd - 1))) if nd >= 2 else P()
    else:
        sspec = P()
    K, N = qt.meta.shape
    tp = mesh.shape["model"]
    shape = {"column": (K, N // tp), "row": (K // tp, N)}.get(kind, (K, N))

    def put(x, spec):
        return None if x is None else shard_local(x, spec, mesh)

    return dataclasses.replace(
        qt, data=put(qt.data, wspec), scale=put(qt.scale, sspec),
        zero_point=put(qt.zero_point, sspec), meta=dataclasses.replace(qt.meta, shape=shape))


def shard_params(model, params: dict, mesh: Mesh, rules=None) -> dict:
    """This rank's slice of a (possibly quantized) param tree by the TP plan."""
    if rules is None:
        rules = GEMMA3_TP_RULES
    sites = {s.name for s in model.linear_sites()}

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        name = ".".join(path[:-1])  # drop the leaf key ("w"/"b"/"prescale")
        leaf_key = path[-1]
        kind = site_kind(name, rules)
        if isinstance(tree, QTensor):
            return qtensor_shardings(tree, kind, mesh)
        if isinstance(tree, QBias):
            spec = P("model") if kind == "column" else P()
            return dataclasses.replace(tree, data=shard_local(tree.data, spec, mesh))
        if leaf_key == "w" and name in sites and tree.ndim == 2:
            return shard_local(tree, _weight_spec(kind), mesh)
        if leaf_key == "w" and name == "embed" and tree.ndim == 2:
            return shard_local(tree, P("model", None), mesh)
        if leaf_key == "b" and name in sites:
            return shard_local(tree, P("model") if kind == "column" else P(), mesh)
        if leaf_key == "prescale":
            return shard_local(tree, P("model") if kind == "row" else P(), mesh)
        return tree

    return visit(params, ())
