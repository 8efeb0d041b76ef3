from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

__all__ = ["QuantType", "QFormat", "QuantizationStrategy"]
