from onnx_quantize_tpu_torch.models.gemma3 import (
    GEMMA3_270M,
    Gemma3,
    Gemma3Config,
    fuse_gemma3_projections,
)

__all__ = ["Gemma3", "Gemma3Config", "GEMMA3_270M", "fuse_gemma3_projections"]
