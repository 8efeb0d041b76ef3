"""Plain PyTorch semantics of a QDQ quantized matmul.

Counterpart of the QDQ part of ``onnx_quantize_tpu/ops/reference.py``: the
weights are dequantized into a float matmul; activations are fake-quantized
(static qparams) or quantized per tensor from their own range (dynamic, the
ONNX DynamicQuantizeLinear rule). A weight-only site runs the dot in the
caller's dtype; a site with activation QDQ keeps the whole chain in float32.
This is the oracle the kernels' plain versions are tested against. The
QLINEAR format and quantized biases are not ported yet (ROADMAP.md, Queue B
#7 and Queue A item 10).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import compute_qparams
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QTensor, unpack_k_pairs

__all__ = ["unpack_weight", "weight_qparams_2d", "dequantize_weight", "static_fake_quant",
           "dynamic_quantize_params", "qdq_prologue", "qdq_epilogue", "_qdq_matmul"]


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


def qdq_epilogue(y: torch.Tensor, qt: QTensor, bias) -> torch.Tensor:
    """Bias add (a float bias: the bridge refuses quantized ones), then
    output-side activation QDQ."""
    if bias is not None:
        y = y + bias
    return _fake_quant(y, qt.meta.output_quant, qt.output_scale, qt.output_zero_point)


def _qdq_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """One QDQ site: ``quant(x) @ dequant(W) (+ b)``, then quant(y), as float32.

    A weight-only site dots in x's dtype (as the JAX oracle does); a site
    with activation QDQ keeps the full float32 chain, since the fake-quantized
    operand is the semantics there.
    """
    if qt.meta.fmt != QFormat.QDQ:
        raise NotImplementedError(
            "The QLINEAR format is not ported to PyTorch yet; see ROADMAP.md, Queue B #7."
        )
    weight_only = qt.meta.input_quant.mode == "none"
    compute_dtype = x.dtype if weight_only else torch.float32
    w = dequantize_weight(qt).to(compute_dtype)
    y = torch.matmul(qdq_prologue(x, qt).to(compute_dtype), w).to(torch.float32)
    return qdq_epilogue(y, qt, bias)
