from onnx_quantize_tpu_torch.models.bert import BertClassifier, BertConfig
from onnx_quantize_tpu_torch.models.gemma3 import (
    GEMMA3_1B,
    GEMMA3_4B,
    GEMMA3_270M,
    Gemma3,
    Gemma3Config,
    Gemma3MoEMLP,
    fuse_gemma3_projections,
)
from onnx_quantize_tpu_torch.models.llama import (
    LLAMA32_1B,
    LLAMA32_3B,
    QWEN25_05B,
    Llama,
    llama_config,
    load_llama_hf,
    tiny_llama_config,
)
from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf
from onnx_quantize_tpu_torch.models.moe import (
    MIXTRAL_8X7B,
    QWEN15_MOE_A27B,
    MoE,
    fuse_moe_experts,
    load_mixtral_hf,
    load_qwen_moe_hf,
    moe_config,
    stack_moe_experts,
    tiny_moe_config,
)
from onnx_quantize_tpu_torch.models.transformer import TransformerConfig, TransformerLM

__all__ = ["Gemma3", "Gemma3Config", "Gemma3MoEMLP", "GEMMA3_270M", "GEMMA3_1B", "GEMMA3_4B",
           "fuse_gemma3_projections",
           "Llama", "llama_config", "tiny_llama_config", "LLAMA32_1B", "LLAMA32_3B", "QWEN25_05B",
           "MoE", "moe_config", "tiny_moe_config", "QWEN15_MOE_A27B", "MIXTRAL_8X7B",
           "stack_moe_experts", "fuse_moe_experts", "load_gemma3_hf", "load_llama_hf",
           "load_qwen_moe_hf", "load_mixtral_hf", "TransformerLM", "TransformerConfig",
           "BertClassifier", "BertConfig"]
