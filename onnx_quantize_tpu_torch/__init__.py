"""PyTorch + CUDA port of onnx_quantize_tpu for NVIDIA Hopper.

Post-training quantization into packed QTensors by RTN, GPTQ or HQQ (with
the MSE range search), after the SmoothQuant or AWQ pre-pass, weight-only or
with int8/uint8 activations (dynamic, or static calibrated by minmax,
percentile or entropy); a Gemma-3 model; and an inference engine whose
quantized linear sites run hand-written Hopper kernels (``ops/kernels``,
sources in ``csrc``) on CUDA tensors and the kernels' plain PyTorch versions
on CPU tensors. Module paths mirror the JAX package ``onnx_quantize_tpu``;
this package never imports JAX.
"""

from onnx_quantize_tpu_torch._logging import set_log_level
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy
from onnx_quantize_tpu_torch.core.qconfig import (
    AwqConfig,
    CalibrationParams,
    GPTQConfig,
    HqqConfig,
    QActivationArgs,
    QConfig,
    QWeightArgs,
    RotateConfig,
    RTNConfig,
    SmoothQuantConfig,
)
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, QTensorMeta
from onnx_quantize_tpu_torch.quantize import quantize

__all__ = [
    "quantize", "QConfig", "QuantType", "QWeightArgs", "QActivationArgs", "QFormat",
    "QuantizationStrategy", "RTNConfig", "GPTQConfig", "HqqConfig", "AwqConfig",
    "RotateConfig", "SmoothQuantConfig", "CalibrationParams", "QTensor", "QTensorMeta",
    "set_log_level",
]
