"""Plain PyTorch semantics of a quantized matmul, QDQ and QLINEAR.

Counterpart of ``onnx_quantize_tpu/ops/reference.py``:

  * QDQ: the weights are dequantized into a float matmul; activations are
    fake-quantized (static qparams) or quantized per tensor from their own
    range (dynamic, the ONNX DynamicQuantizeLinear rule). A weight-only site
    runs the dot in the caller's dtype; a site with activation QDQ keeps the
    whole chain in float32. A quantized bias (QBias) is dequantized.
  * QLINEAR: the input is quantized with its static qparams, the integer dot
    with zero-point corrections and the int32 bias is exact, and the
    accumulator is requantized with ``x_scale * w_scale / y_scale`` to the
    output's codes, then dequantized.

This is the oracle the kernels' plain versions are tested against.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import compute_qparams
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, QTensor, unpack_k_pairs

__all__ = ["unpack_weight", "weight_qparams_2d", "dequantize_weight", "static_fake_quant",
           "dynamic_quantize_params", "qdq_prologue", "qdq_epilogue", "quantized_matmul_ref",
           "_qdq_matmul", "_qlinear_matmul"]


def unpack_weight(qt: QTensor) -> torch.Tensor:
    """Unpack a QTensor's data to its (K, N) integer container values."""
    K, _ = qt.meta.shape
    if qt.meta.packed:
        return unpack_k_pairs(qt.data, K, signed=qt.meta.qt.is_signed,
                              pack_group=qt.meta.pack_group)
    return qt.data


def weight_qparams_2d(qt: QTensor):
    """(scale, zp) as float32 in the logical layout (scalar / (N,) / (G, N)).

    Accepts the engine's baked kernel layout ((G_pad/2, 2, N) padded group
    pairs, see ``engine.prepare_kernel_scales``) and slices it back to the
    real (G, N) rows."""
    scale = qt.scale.to(torch.float32)
    zp = qt.zero_point.to(torch.float32)
    if scale.ndim == 3:
        K, N = qt.meta.shape
        G = -(-K // qt.meta.pack_group)
        scale = scale.reshape(-1, N)[:G]
        zp = zp.reshape(-1, N)[:G]
    return scale, zp


def dequantize_weight(qt: QTensor) -> torch.Tensor:
    """Dequantize a QTensor to (K, N) float32 per its strategy."""
    K, N = qt.meta.shape
    w = unpack_weight(qt).to(torch.float32)
    scale, zp = weight_qparams_2d(qt)
    strat = qt.meta.strat
    if strat == QuantizationStrategy.TENSOR:
        return (w - zp) * scale
    if strat == QuantizationStrategy.CHANNEL:
        return (w - zp[None, :]) * scale[None, :]
    n_groups = scale.shape[0]
    w = w.reshape(n_groups, K // n_groups, N)
    return ((w - zp[:, None, :]) * scale[:, None, :]).reshape(K, N)


def static_fake_quant(x: torch.Tensor, scale, zero_point, spec: ActQuantSpec) -> torch.Tensor:
    """QuantizeLinear -> DequantizeLinear with given qparams, in float32."""
    qmin, qmax = spec.quant_type.qrange(spec.symmetric, spec.reduce_range)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale) + zp, qmin, qmax)
    return (q - zp) * scale


def dynamic_quantize_params(x: torch.Tensor, spec: ActQuantSpec):
    """Per-tensor qparams from x's own range (ONNX DynamicQuantizeLinear)."""
    rmin = torch.clamp(x.min().to(torch.float32), max=0.0)
    rmax = torch.clamp(x.max().to(torch.float32), min=0.0)
    return compute_qparams(rmin, rmax, spec.quant_type, spec.symmetric, spec.reduce_range,
                           zp_dtype=torch.float32)


def _fake_quant(x: torch.Tensor, spec: ActQuantSpec, scale, zero_point) -> torch.Tensor:
    if spec.mode == "none":
        return x
    if spec.mode == "dynamic":
        scale, zero_point = dynamic_quantize_params(x, spec)
    return static_fake_quant(x, scale, zero_point, spec)


def qdq_prologue(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Input-side activation QDQ (x unchanged at a weight-only site)."""
    return _fake_quant(x, qt.meta.input_quant, qt.input_scale, qt.input_zero_point)


def _bias_value(bias):
    return bias.dequantize() if isinstance(bias, QBias) else bias


def qdq_epilogue(y: torch.Tensor, qt: QTensor, bias) -> torch.Tensor:
    """Bias add (a QBias dequantized), then output-side activation QDQ."""
    b = _bias_value(bias)
    if b is not None:
        y = y + b
    return _fake_quant(y, qt.meta.output_quant, qt.output_scale, qt.output_zero_point)


def _qdq_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """One QDQ site: ``quant(x) @ dequant(W) (+ b)``, then quant(y), as float32.

    A weight-only site dots in x's dtype (as the JAX oracle does); a site
    with activation QDQ keeps the full float32 chain, since the fake-quantized
    operand is the semantics there.
    """
    weight_only = qt.meta.input_quant.mode == "none"
    compute_dtype = x.dtype if weight_only else torch.float32
    w = dequantize_weight(qt).to(compute_dtype)
    y = torch.matmul(qdq_prologue(x, qt).to(compute_dtype), w).to(torch.float32)
    return qdq_epilogue(y, qt, bias)


def _qlinear_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """One QLINEAR site (QLinearMatMul / QGemm semantics), as float32.

    x is cast to float32 before its quantization, as the reference's type
    promotion does. The integer dot runs as a float64 product, exact for
    these operands (each product below 2^16, every sum far below 2^53).
    """
    meta = qt.meta
    K, N = meta.shape
    in_spec, out_spec = meta.input_quant, meta.output_quant
    iqmin, iqmax = in_spec.quant_type.qrange(in_spec.symmetric, in_spec.reduce_range)
    oqmin, oqmax = out_spec.quant_type.qrange(out_spec.symmetric, out_spec.reduce_range)
    x_scale = qt.input_scale.to(torch.float32)
    x_zp = qt.input_zero_point.to(torch.int32)
    x2d = x.reshape(-1, K).to(torch.float32)
    x_q = torch.clamp(torch.round(x2d / x_scale).to(torch.int32) + x_zp, iqmin, iqmax)

    w_q = unpack_weight(qt).to(torch.int32)
    w_zp = qt.zero_point.to(torch.int32)  # a scalar, or (N,) per channel
    acc = torch.matmul((x_q - x_zp).to(torch.float64),
                       (w_q - w_zp).to(torch.float64)).to(torch.int32)
    if bias is not None:
        if not isinstance(bias, QBias):
            raise TypeError("A QLINEAR Gemm site requires an int32-quantized bias (QBias).")
        acc = acc + bias.data.to(torch.int32)

    y_scale = qt.output_scale.to(torch.float32)
    y_zp = qt.output_zero_point.to(torch.float32)
    requant = x_scale * qt.scale.to(torch.float32) / y_scale
    y_q = torch.clamp(torch.round(acc.to(torch.float32) * requant) + y_zp, oqmin, oqmax)
    return ((y_q - y_zp) * y_scale).reshape(*x.shape[:-1], N)


def quantized_matmul_ref(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """One quantized site with plain PyTorch semantics, QDQ or QLINEAR."""
    if qt.meta.fmt == QFormat.QLINEAR:
        return _qlinear_matmul(x, qt, bias)
    return _qdq_matmul(x, qt, bias)
