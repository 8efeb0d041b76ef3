from onnx_quantize_tpu_torch.engine.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.engine.kv_cache import KVCacheConfig, init_cache
from onnx_quantize_tpu_torch.engine.sampling import (
    SamplingParams,
    batch_sampling_arrays,
    sample,
    sample_batch,
)
from onnx_quantize_tpu_torch.engine.scheduler import ContinuousBatchingScheduler, Request
from onnx_quantize_tpu_torch.engine.spec_scheduler import SpeculativeScheduler
from onnx_quantize_tpu_torch.engine.speculative import SpeculativeDecoder

__all__ = ["InferenceEngine", "prepare_kernel_scales", "KVCacheConfig", "init_cache",
           "SamplingParams", "sample", "sample_batch", "batch_sampling_arrays",
           "ContinuousBatchingScheduler", "Request", "SpeculativeDecoder",
           "SpeculativeScheduler"]
