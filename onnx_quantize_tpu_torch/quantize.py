"""quantize(): weight-only RTN QDQ over a model's param tree.

Counterpart of ``onnx_quantize_tpu/quantize.py`` for the ported slice:

    model + params + QConfig
      -> build the plan over the model's Linear sites (ignore regexes)
      -> untie shared weights
      -> per-site RTN + QTensor packing

Sites that are already QTensors are left as they are, so mixed configs are
applied as sequential calls with complementary ignore patterns (the body in
W4, then the lm_head in int8 with ``ignore=[r"^layers\\."]``).
"""

from __future__ import annotations

import logging

import torch

from onnx_quantize_tpu_torch.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu_torch.core.qconfig import QConfig
from onnx_quantize_tpu_torch.nn.module import Module
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, make_qtensor
from onnx_quantize_tpu_torch.plan import PlanEntry, QuantPlan, build_plan
from onnx_quantize_tpu_torch.utils import tree_get, untie_params

logger = logging.getLogger(__name__)

__all__ = ["quantize"]


def _transform_site(entry: PlanEntry, params: dict) -> None:
    w_args = entry.qconfig.weights
    site_params = tree_get(params, entry.site.param_path)
    if isinstance(site_params["w"], QTensor):
        logger.info("Site %s already quantized; skipping.", entry.name)
        return
    if site_params.get("b") is not None:
        # A QDQ bias is RTN-quantized per tensor unless the site qualifies for
        # the nbits kernel; no model of the ported slice has biased sites.
        raise NotImplementedError(
            f"Quantizing the biased site {entry.name} is not ported to PyTorch yet; "
            "see ROADMAP.md, Queue A item 10."
        )
    gs = entry.group_size if entry.group_size is not None else -1
    q, scale, zp = rtn_quantize(
        site_params["w"], w_args.dtype, strategy=w_args.strategy, group_size=gs,
        is_symmetric=w_args.symmetric, reduce_range=w_args.reduce_range,
    )
    site_params["w"] = make_qtensor(
        q, scale, zp, quant_type=w_args.dtype, strategy=w_args.strategy,
        group_size=gs, symmetric=w_args.symmetric, reduce_range=w_args.reduce_range,
    )


@torch.no_grad()
def quantize(model: Module, params: dict, qconfig: QConfig):
    """Quantize ``params`` of ``model`` per ``qconfig``.

    Returns ``(quantized_params, plan)``. The input tree is not mutated;
    quantized sites carry :class:`QTensor` weights on the weights' device.
    """
    if not isinstance(qconfig, QConfig):
        raise TypeError(f"qconfig must be a QConfig, got {type(qconfig)}")
    if not isinstance(model, Module):
        raise TypeError(f"model must be a Module, got {type(model)}")
    if qconfig.weights is None:
        return params, QuantPlan()
    plan = build_plan(model.linear_sites(), qconfig)
    params = untie_params(params, [e.site.param_path for e in plan])
    for entry in plan:
        _transform_site(entry, params)
    return params, plan
