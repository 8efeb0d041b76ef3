"""quantize(): a model's param tree through its weight algorithm, QDQ or QLINEAR.

Counterpart of ``onnx_quantize_tpu/quantize.py``:

    model + params + QConfig
      -> build the plan over the model's Linear sites (ignore regexes)
      -> untie shared weights
      -> calibrate (static activations, captured inputs), stamp the
         qconfig, run the pre-passes (SmoothQuant, AWQ), re-calibrate
      -> per site, the weight algorithm (RTN, GPTQ, HQQ) + QTensor packing,
         stamped with the activation specs and the calibrated qparams;
         biases quantized (QBias) as the format requires

Sites that are already QTensors are left as they are, so mixed configs are
applied as sequential calls with complementary ignore patterns (the body in
W4, then the lm_head in int8 with ``ignore=[r"^layers\\."]``).
"""

from __future__ import annotations

import logging

import torch

from onnx_quantize_tpu_torch.algorithms.rtn import quantize_bias, rtn_quantize
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.core.qconfig import QActivationArgs, QConfig
from onnx_quantize_tpu_torch.nn.module import Module
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, QTensor, make_qtensor
from onnx_quantize_tpu_torch.plan import PlanEntry, QuantPlan, build_plan
from onnx_quantize_tpu_torch.prepasses import apply_pre_passes
from onnx_quantize_tpu_torch.utils import tree_get, untie_params

logger = logging.getLogger(__name__)

__all__ = ["quantize", "is_nbits_kernel_compatible"]


def is_nbits_kernel_compatible(qconfig: QConfig, name: str = "") -> bool:
    """Grouped weight-only configs that keep a float bias (the reference's
    MatMulNBits gate): weight-only, uint4/uint8, group strategy, group size a
    power of two >= 16."""
    weights_only = qconfig.input_activations is None and qconfig.output_activations is None
    w = qconfig.weights
    if not weights_only or w.dtype not in (QuantType.QUInt4, QuantType.QUInt8):
        return False
    if w.strategy != QuantizationStrategy.GROUP:
        return False
    gs = w.group_size
    if gs != -1 and (gs < 16 or (gs & (gs - 1)) != 0):
        logger.debug("Found incompatibility for the nbits kernel in %s: group_size should "
                     "be a power of 2 greater than or equal to 16.", name)
        return False
    return True


def _act_spec(qargs: QActivationArgs | None) -> ActQuantSpec:
    if qargs is None:
        return ActQuantSpec(mode="none")
    return ActQuantSpec(mode="static" if qargs.is_static else "dynamic",
                        dtype=qargs.dtype.value, symmetric=qargs.symmetric,
                        reduce_range=qargs.reduce_range)


def _quantize_bias_qdq(bias: torch.Tensor, qconfig: QConfig) -> QBias:
    """QDQ Gemm bias: RTN per tensor in the weight dtype."""
    w = qconfig.weights
    b_q, b_scale, b_zp = rtn_quantize(
        bias.reshape(-1, 1), w.dtype, strategy=QuantizationStrategy.TENSOR, group_size=-1,
        is_symmetric=w.symmetric, reduce_range=w.reduce_range, clip_ratio=w.clip_ratio,
        mse=w.mse, zp_dtype=w.zp_dtype,
    )
    return QBias(data=b_q.reshape(-1), scale=b_scale, zero_point=b_zp,
                 quant_type=w.dtype.value)


def _transform_site(entry: PlanEntry, params: dict) -> None:
    qconfig = entry.qconfig
    w_args = qconfig.weights
    site_params = tree_get(params, entry.site.param_path)
    if isinstance(site_params["w"], QTensor):
        logger.info("Site %s already quantized; skipping.", entry.name)
        return
    in_spec = _act_spec(qconfig.input_activations)
    out_spec = _act_spec(qconfig.output_activations)
    for kind, spec, scale in (("input", in_spec, entry.input_scale),
                              ("output", out_spec, entry.output_scale)):
        if spec.mode == "static" and scale is None:
            raise RuntimeError(
                f"Static {kind} activation quantization requested for {entry.name} "
                f"but no calibrated {kind} scale is present."
            )
    gs = entry.group_size if entry.group_size is not None else -1
    weight = site_params["w"].to(torch.float32)
    q, scale, zp = w_args.algorithm.quantize_weights(weight, qconfig, entry)
    qt = make_qtensor(
        q, scale, zp, quant_type=w_args.dtype, strategy=w_args.strategy,
        group_size=gs, symmetric=w_args.symmetric, reduce_range=w_args.reduce_range,
        fmt=qconfig.format, input_quant=in_spec, output_quant=out_spec,
        input_scale=entry.input_scale, input_zero_point=entry.input_zero_point,
        output_scale=entry.output_scale, output_zero_point=entry.output_zero_point,
    )
    site_params["w"] = qt

    bias = site_params.get("b")
    if bias is not None and entry.site.op_type == "Gemm":
        bias = bias.to(torch.float32)
        if qt.meta.fmt == QFormat.QLINEAR:
            b_q, b_scale, _ = quantize_bias(bias, entry.input_scale, scale.to(torch.float32))
            site_params["b"] = QBias(
                data=b_q, scale=b_scale,
                zero_point=torch.zeros((), dtype=torch.int32, device=b_q.device),
                quant_type=QuantType.QInt32.value)
        elif not is_nbits_kernel_compatible(qconfig, entry.name):
            # The grouped weight-only (nbits) case keeps its float bias.
            site_params["b"] = _quantize_bias_qdq(bias, qconfig)
    # The captured inputs can be large; free them once consumed.
    entry.captured_input = None


@torch.no_grad()
def quantize(model: Module, params: dict, qconfig: QConfig):
    """Quantize ``params`` of ``model`` per ``qconfig``.

    Returns ``(quantized_params, plan)``. The input tree is not mutated;
    quantized sites carry :class:`QTensor` weights (and :class:`QBias`
    biases where the format requires) on the weights' device, and a site a
    pre-pass rescaled carries its input ``prescale``. Calibration (static
    activations, the inputs GPTQ and the pre-passes read) runs first, on the
    device the params live on unless ``qconfig.calibration_params.backend``
    names another; the algorithms run on the weights' device.
    """
    if not isinstance(qconfig, QConfig):
        raise TypeError(f"qconfig must be a QConfig, got {type(qconfig)}")
    if not isinstance(model, Module):
        raise TypeError(f"model must be a Module, got {type(model)}")
    if qconfig.weights is None:
        return params, QuantPlan()
    model.finalize()
    plan = build_plan(model.linear_sites(), qconfig)
    params = untie_params(params, [e.site.param_path for e in plan])
    apply_pre_passes(model, params, plan, qconfig)
    for entry in plan:
        _transform_site(entry, params)
    return params, plan
