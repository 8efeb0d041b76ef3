from onnx_quantize_tpu_torch.nn.layers import Embedding, RMSNorm, apply_rope
from onnx_quantize_tpu_torch.nn.module import Linear, Module, apply_linear
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, QTensorMeta, make_qtensor

__all__ = [
    "Module", "Linear", "apply_linear", "Embedding", "RMSNorm", "apply_rope",
    "QTensor", "QTensorMeta", "make_qtensor",
]
