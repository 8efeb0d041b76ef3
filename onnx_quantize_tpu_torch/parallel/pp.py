"""Pipeline parallelism: a decoder split into stages over the ``pipe`` axis.

Counterpart of ``onnx_quantize_tpu/parallel/pp.py``: each rank of the axis
holds a contiguous stage of decoder layers (the stage params stacked along a
leading axis, each rank taking its index), microbatches stream through the
GPipe fill and drain, and the only traffic is one activation ring shift a
step. Scope: full-sequence scoring and prefill; decode with a cache is the
TP engine's (at one token a step the bubble is all latency).

Requirements: ``num_layers % stages == 0``, and each position within a stage
has one attention flavor across stages (every Llama/Qwen/MoE layer is
global; Gemma-3 needs layers-per-stage a multiple of ``sliding_pattern``).

A rank computes only in the steps where a microbatch is at its stage (the
JAX program runs every stage every step and masks); the ring shift runs
every step. Usage, on every rank::

    stage_params, shared = pipeline_stage_params(model, params, stages=2)
    logits = pp_logits(model, stage_params, shared, ids, mesh, microbatches=4)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.parallel.comm import all_gather, all_reduce, ppermute
from onnx_quantize_tpu_torch.parallel.mesh import Mesh, use_mesh

__all__ = ["pipeline_stage_params", "pp_logits", "make_pipeline_mesh"]


def make_pipeline_mesh(stages: int, ranks=None, axis: str = "pipe") -> Mesh:
    """A one-axis mesh over the first ``stages`` ranks."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    if len(ranks) < stages:
        raise ValueError(f"need >= {stages} ranks, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:stages]), (axis,))


def _stack(leaves: list):
    """One layer position's leaf stacked across stages."""
    if isinstance(leaves[0], QTensor):
        meta = leaves[0].meta
        if any(not isinstance(qt, QTensor) or qt.meta != meta for qt in leaves[1:]):
            raise ValueError("pipeline stages must be quantized identically "
                             "(QTensor metas differ across stages)")
        return dataclasses.replace(leaves[0], **{
            f.name: None if getattr(leaves[0], f.name) is None
            else torch.stack([getattr(qt, f.name) for qt in leaves])
            for f in dataclasses.fields(QTensor) if f.name != "meta"})
    if isinstance(leaves[0], dict):
        return {k: _stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    return None if leaves[0] is None else torch.stack(leaves)


def _index(tree, i: int):
    """Stage ``i``'s view of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{
            f.name: None if getattr(tree, f.name) is None else getattr(tree, f.name)[i]
            for f in dataclasses.fields(QTensor) if f.name != "meta"})
    return None if tree is None else tree[i]


def pipeline_stage_params(model, params: dict, stages: int):
    """Split a decoder param tree into (stacked stage params, shared params).

    Stage ``s`` holds layers ``[s*L/S, (s+1)*L/S)``; each layer position's
    params are stacked across stages along a new leading axis. ``shared``
    (embed, final_norm, lm_head) is whole on every rank."""
    cfg = model.cfg
    L = cfg.num_layers
    if stages < 2:
        raise ValueError("pipeline needs stages >= 2")
    if L % stages != 0:
        raise ValueError(f"num_layers={L} not divisible by stages={stages}")
    per_stage = L // stages
    for j in range(per_stage):
        flavors = {cfg.is_global_layer(s * per_stage + j) for s in range(stages)}
        if len(flavors) != 1:
            raise ValueError(
                f"layer position {j} mixes local/global attention across "
                f"stages (sliding_pattern={cfg.sliding_pattern}); choose "
                "stages so layers-per-stage is a multiple of the pattern")
    stage_tree = {f"pos.{j}": _stack([params[f"layers.{s * per_stage + j}"]
                                      for s in range(stages)])
                  for j in range(per_stage)}
    shared = {k: params[k] for k in ("embed", "final_norm", "lm_head")}
    return stage_tree, shared


@torch.inference_mode()
def pp_logits(model, stage_tree, shared, ids, mesh: Mesh, *, axis: str = "pipe",
              microbatches: int | None = None, use_flash: bool | str = False):
    """Full-sequence logits (B, T, V) through the GPipe fill and drain, on
    every rank of the axis. ``ids``: (B, T) with ``B % microbatches == 0``;
    ``microbatches`` defaults to the stage count."""
    from onnx_quantize_tpu_torch.models.gemma3 import make_attention_mask

    cfg = model.cfg
    S = mesh.shape[axis]
    stage = mesh.coords[axis]
    n_mb = microbatches or S
    device = shared["embed"]["w"].device
    ids = (ids if isinstance(ids, torch.Tensor) else torch.from_numpy(np.asarray(ids))).to(
        device=device, dtype=torch.int64)
    B, T = ids.shape
    if B % n_mb != 0:
        raise ValueError(f"batch {B} not divisible by microbatches={n_mb}")
    mb = B // n_mb
    per_stage = cfg.num_layers // S
    local = _index(stage_tree, stage)
    positions = torch.arange(T, dtype=torch.int32, device=device)[None].expand(mb, T)
    masks = {flavor: make_attention_mask(cfg, positions, positions, is_global=flavor)
             for flavor in (False, True)}

    def apply_stage(x):
        for j in range(per_stage):
            block = model.layers[j]  # static flavors agree across stages
            x = block(local[f"pos.{j}"], x, positions, masks[block.attn.is_global],
                      use_flash=use_flash)
        return x

    with use_mesh(mesh):
        x_all = model.embed(shared["embed"], ids.reshape(n_mb, mb, T))
        if cfg.scale_embeddings:
            x_all = x_all * math.sqrt(cfg.hidden_size)
        x_all = x_all.to(cfg.torch_dtype)
        recv = torch.zeros((mb, T, cfg.hidden_size), dtype=x_all.dtype, device=device)
        done = torch.zeros((n_mb, mb, T, cfg.hidden_size), dtype=x_all.dtype, device=device)
        ring = [(i, (i + 1) % S) for i in range(S)]
        for t in range(n_mb + S - 1):
            # Stage s works on microbatch t - s in steps s .. s + n_mb - 1.
            if stage <= t < stage + n_mb:
                y = apply_stage(x_all[t] if stage == 0 else recv)
                if stage == S - 1:
                    done[t - (S - 1)] = y
            else:
                y = torch.zeros_like(recv)
            recv = ppermute(y, axis, ring)
        # Every rank gets the finished activations (one rank contributes each),
        # then scores its share of the microbatches and the shares are gathered.
        done = all_reduce(done.to(torch.float32), axis).to(x_all.dtype)
        if n_mb % S == 0:
            share = n_mb // S
            h = model.final_norm(shared["final_norm"], done[stage * share:(stage + 1) * share])
            logits = all_gather(model.lm_head(shared["lm_head"], h), axis, dim=0)
        else:
            h = model.final_norm(shared["final_norm"], done)
            logits = model.lm_head(shared["lm_head"], h)
    return logits.reshape(B, T, -1)
