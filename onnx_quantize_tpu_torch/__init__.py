"""PyTorch + CUDA port of onnx_quantize_tpu for NVIDIA Hopper.

RTN quantization into packed QTensors (weight-only, or with dynamic int8 /
uint8 activations), a Gemma-3 model, and an inference engine whose
quantized linear sites run hand-written Hopper kernels (``ops/kernels``,
sources in ``csrc``) on CUDA tensors and the kernels' plain PyTorch versions
on CPU tensors. Module paths mirror the JAX
package ``onnx_quantize_tpu``; this package never imports JAX.
"""

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.core.qconfig import QActivationArgs, QConfig, QWeightArgs
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, QTensorMeta
from onnx_quantize_tpu_torch.quantize import quantize

__all__ = [
    "QConfig", "QWeightArgs", "QActivationArgs", "QuantType", "QFormat", "QuantizationStrategy",
    "QTensor", "QTensorMeta", "quantize",
]
