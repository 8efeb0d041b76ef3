from onnx_quantize_tpu_torch.algorithms.gptq import accumulate_hessian, gptq_quantize
from onnx_quantize_tpu_torch.algorithms.hqq import hqq_quantize
from onnx_quantize_tpu_torch.algorithms.rtn import quantize_bias, rtn_quantize

__all__ = ["rtn_quantize", "quantize_bias", "gptq_quantize", "accumulate_hessian", "hqq_quantize"]
