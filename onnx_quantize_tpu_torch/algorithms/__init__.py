from onnx_quantize_tpu_torch.algorithms.rtn import rtn_quantize

__all__ = ["rtn_quantize"]
