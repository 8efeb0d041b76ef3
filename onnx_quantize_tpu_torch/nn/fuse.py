"""Horizontal fusion of same-input linear sites (q/k/v, gate/up).

Counterpart of ``onnx_quantize_tpu/nn/fuse.py``: packed data, scales and zero
points concatenate along N (same K, same group geometry), so one fused
matmul computes exactly the concatenation of the per-site outputs with fewer
launches. Applied after quantization.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor

__all__ = ["fuse_sites", "can_fuse"]


def _compatible_meta(a: QTensor, b: QTensor) -> bool:
    ma, mb = a.meta, b.meta
    return dataclasses.replace(ma, shape=(ma.shape[0], 0)) == dataclasses.replace(
        mb, shape=(mb.shape[0], 0)
    )


def can_fuse(site_params: list[dict]) -> bool:
    """All sites quantized alike (or all float), no bias."""
    if any(p.get("b") is not None for p in site_params):
        return False
    leaves = [p.get("w") for p in site_params]
    if all(isinstance(w, QTensor) for w in leaves):
        first = leaves[0]
        if first.meta.strategy == "tensor":
            return False  # per-tensor weight scales differ between sites
        return all(_compatible_meta(first, w) for w in leaves[1:])
    if all(isinstance(w, torch.Tensor) for w in leaves):
        return all(w.ndim == 2 and w.shape[0] == leaves[0].shape[0] for w in leaves)
    return False


def fuse_sites(site_params: list[dict]):
    """Fuse the weights of compatible sites; returns (fused_w, split_sizes)."""
    leaves = [p["w"] for p in site_params]
    sizes = [(w.meta.shape[1] if isinstance(w, QTensor) else w.shape[1]) for w in leaves]
    if not isinstance(leaves[0], QTensor):
        return torch.cat(leaves, dim=1), sizes
    first = leaves[0]
    if first.meta.strat.value == "tensor":
        raise ValueError("Cannot fuse per-tensor-quantized weights (scales differ).")
    fused = QTensor(
        data=torch.cat([w.data for w in leaves], dim=1),
        scale=torch.cat([w.scale for w in leaves], dim=-1),
        zero_point=torch.cat([w.zero_point for w in leaves], dim=-1),
        meta=dataclasses.replace(first.meta, shape=(first.meta.shape[0], sum(sizes))),
    )
    return fused, sizes
