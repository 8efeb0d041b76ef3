from onnx_quantize_tpu_torch.models.gemma3 import (
    GEMMA3_270M,
    Gemma3,
    Gemma3Config,
    fuse_gemma3_projections,
)
from onnx_quantize_tpu_torch.models.llama import (
    LLAMA32_1B,
    LLAMA32_3B,
    QWEN25_05B,
    Llama,
    llama_config,
    tiny_llama_config,
)

__all__ = ["Gemma3", "Gemma3Config", "GEMMA3_270M", "fuse_gemma3_projections", "Llama",
           "llama_config", "tiny_llama_config", "LLAMA32_1B", "LLAMA32_3B", "QWEN25_05B"]
