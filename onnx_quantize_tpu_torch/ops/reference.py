"""Plain PyTorch semantics of a weight-only QDQ quantized matmul.

Counterpart of the QDQ weight-only part of
``onnx_quantize_tpu/ops/reference.py``: the weights are dequantized into a
float matmul run in the caller's dtype with float32 accumulation. This is
the oracle the kernels' plain versions are tested against. Activation QDQ
and the QLINEAR format are not ported yet (ROADMAP.md, Queue B #5-#7).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, unpack_k_pairs

__all__ = ["unpack_weight", "weight_qparams_2d", "dequantize_weight", "_qdq_matmul"]


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


def _qdq_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """One weight-only QDQ site: ``x @ dequant(W) (+ b)`` in float32.

    The dot runs in x's dtype (as the JAX oracle does) with float32 output.
    """
    if qt.meta.fmt != QFormat.QDQ:
        raise NotImplementedError(
            "The QLINEAR format is not ported to PyTorch yet; see ROADMAP.md, Queue B #7."
        )
    w = dequantize_weight(qt).to(x.dtype)
    y = torch.matmul(x, w).to(torch.float32)
    if bias is not None:
        y = y + bias
    return y
