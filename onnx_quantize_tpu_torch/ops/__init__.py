"""Quantized op dispatch.

``quantized_matmul`` is the single execution chokepoint for quantized linear
sites (counterpart of ``onnx_quantize_tpu/ops/__init__.py``). It hands the
site to the registered kernel whose predicate covers the QTensor's config;
the kernel's wrapper launches the Hopper kernel for CUDA tensors and runs
the kernel's plain version for CPU tensors. A config no kernel covers runs
the plain reference on the CPU and raises on any other device: there is no
path from a CUDA tensor to a plain implementation.

``convert_to_w4a8`` switches a quantized tree to dynamic int8 activations,
so the W4A8 and W8A8 kernels take its sites.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QTensor
from onnx_quantize_tpu_torch.ops.kernels import select_kernel
from onnx_quantize_tpu_torch.ops.reference import quantized_matmul_ref

__all__ = ["quantized_matmul", "convert_to_w4a8"]

_DYNAMIC_INT8 = ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True)


def convert_to_w4a8(params):
    """Switch weight-only QTensors to dynamic symmetric int8 activations (A8).

    Counterpart of the JAX package's ``ops.convert_to_w4a8``, with its
    eligibility rules: packed 4-bit weights with integer zero points (the
    W4A8 kernel) and symmetric 8-bit weights (the W8A8 kernel). Sites whose
    input quantization is already set, HQQ-style float zero points and
    asymmetric 8-bit weights are left as they are. The weights are unchanged;
    only the execution spec differs. A float zero point is read from
    ``QTensorMeta.float_zero_point``, set when the site was quantized, so the
    rule holds also after the engine baked the kernel scales (which holds
    every packed zero point as float32).
    """

    def eligible(qt: QTensor) -> bool:
        if qt.meta.input_quant.mode != "none":
            return False
        if qt.meta.packed:
            return not qt.meta.float_zero_point
        return qt.meta.qt.bitwidth == 8 and qt.meta.symmetric

    def visit(tree):
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, QTensor) and eligible(tree):
            return dataclasses.replace(
                tree, meta=dataclasses.replace(tree.meta, input_quant=_DYNAMIC_INT8))
        return tree

    return visit(params)


def quantized_matmul(x: torch.Tensor, qt: QTensor, bias=None) -> torch.Tensor:
    """``x @ dequant(qt) (+ bias)`` as float32. x: (..., K) -> (..., N)."""
    kernel = select_kernel(x, qt, bias)
    if kernel is not None:
        return kernel(x, qt, bias)
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"No Hopper kernel covers the quantized weight {qt.meta}: the kernels take QDQ "
            "weights packed in 4 bits or stored in 8, and QLINEAR sites with calibrated "
            "input and output scales; other weight formats run only on the CPU reference."
        )
    return quantized_matmul_ref(x, qt, bias)
