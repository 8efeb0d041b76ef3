from onnx_quantize_tpu_torch.engine.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.engine.kv_cache import KVCacheConfig, init_cache
from onnx_quantize_tpu_torch.engine.sampling import SamplingParams, sample

__all__ = ["InferenceEngine", "prepare_kernel_scales", "KVCacheConfig", "init_cache",
           "SamplingParams", "sample"]
