"""Quantized op dispatch.

``quantized_matmul`` is the single execution chokepoint for quantized linear
sites (counterpart of ``onnx_quantize_tpu/ops/__init__.py``). It hands the
site to the registered kernel whose predicate covers the QTensor's config;
the kernel's wrapper launches the Hopper kernel for CUDA tensors and runs
the kernel's plain version for CPU tensors. A config no kernel covers runs
the plain reference on the CPU and raises on any other device: there is no
path from a CUDA tensor to a plain implementation.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import select_kernel
from onnx_quantize_tpu_torch.ops.reference import _qdq_matmul

__all__ = ["quantized_matmul"]


def quantized_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """``x @ dequant(qt) (+ bias)`` as float32. x: (..., K) -> (..., N)."""
    kernel = select_kernel(x, qt, bias)
    if kernel is not None:
        return kernel(x, qt, bias)
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"No Hopper kernel covers the quantized weight {qt.meta}; "
            "see ROADMAP.md, Queue B, for the kernels still to be ported."
        )
    return _qdq_matmul(x, qt, bias)
