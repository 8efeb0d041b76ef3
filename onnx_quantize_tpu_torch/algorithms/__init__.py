from onnx_quantize_tpu_torch.algorithms.rtn import quantize_bias, rtn_quantize

__all__ = ["rtn_quantize", "quantize_bias"]
