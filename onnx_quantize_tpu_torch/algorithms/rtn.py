"""Round-to-nearest weight quantization.

Counterpart of ``onnx_quantize_tpu/algorithms/rtn.py``: layout preprocess ->
qparams -> quantize -> layout postprocess, with scale/zp squeezed for
tensor/channel strategies and kept ``(rows, 1)`` for the group strategy; and
the int32 bias quantizer of the QLINEAR format (``bias_scale = w_scale *
x_scale``, zero point 0). Runs on the device the weight lives on.
``quantize_weights`` is the entry ``RTNConfig`` dispatches to.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import (
    compute_qparams_from_array,
    postprocess_array,
    preprocess_array,
    quantize_from_qparams,
)

__all__ = ["rtn_quantize", "quantize_bias", "quantize_weights"]


def rtn_quantize(
    array: torch.Tensor,
    quant_type: QuantType,
    strategy: QuantizationStrategy,
    group_size: int,
    is_symmetric: bool,
    reduce_range: bool,
    clip_ratio: float = 1.0,
    mse: bool = False,
    zp_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize a ``(in_features, out_features)`` weight round-to-nearest.

    Returns ``(q_weight, scale, zero_point)``: ``q_weight`` in the original
    layout and the quantized container dtype; scale/zp are scalars (tensor),
    ``(out,)`` vectors (channel), or ``(out * n_groups, 1)`` (group).
    """
    array = array.to(torch.float32)
    pre = preprocess_array(array, strategy, group_size)
    scale, zp = compute_qparams_from_array(pre, quant_type, strategy, group_size, is_symmetric,
                                           reduce_range, clip_ratio=clip_ratio, mse=mse,
                                           zp_dtype=zp_dtype)
    q = quantize_from_qparams(pre, scale, zp, quant_type, is_symmetric, reduce_range)
    if strategy in {QuantizationStrategy.TENSOR, QuantizationStrategy.CHANNEL}:
        scale, zp = scale.squeeze(), zp.squeeze()
    q = postprocess_array(q, array.shape, strategy, group_size)
    return q.contiguous(), scale, zp


def quantize_weights(config, weight: torch.Tensor, qconfig, entry=None):
    """RTN of one site's weight under its stamped qconfig (``RTNConfig``'s
    entry; the group size resolved per site by the plan entry)."""
    w = qconfig.weights
    group_size = entry.group_size if entry is not None else w.group_size
    return rtn_quantize(weight, w.dtype, strategy=w.strategy,
                        group_size=group_size if group_size is not None else -1,
                        is_symmetric=w.symmetric, reduce_range=w.reduce_range,
                        clip_ratio=w.clip_ratio, mse=w.mse, zp_dtype=w.zp_dtype)


def quantize_bias(bias: torch.Tensor, input_scale, weight_scale):
    """Quantize a float32 bias vector to int32 with ``bias_scale = w_scale *
    x_scale`` and zero point 0 (int32, asymmetric full range). Returns
    ``(q_bias, bias_scale, 0)``."""
    assert bias.ndim == 1 and bias.dtype == torch.float32
    input_scale = torch.as_tensor(input_scale, device=bias.device)
    weight_scale = torch.as_tensor(weight_scale, device=bias.device)
    assert input_scale.numel() == 1
    assert weight_scale.dtype == torch.float32
    assert weight_scale.numel() == 1 or weight_scale.numel() == bias.numel()
    bias_scale = weight_scale * input_scale
    qbias = quantize_from_qparams(bias, bias_scale, 0, QuantType.QInt32, is_symmetric=False,
                                  reduce_range=False)
    return qbias, bias_scale, 0
