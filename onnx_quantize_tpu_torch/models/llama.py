"""Llama/Qwen-family causal LMs on the shared decoder.

Counterpart of ``onnx_quantize_tpu/models/llama.py``: the Llama architecture
is the Gemma-3 decoder with a handful of conventions flipped (no QK-norm,
pre-norm only, SiLU MLP, unscaled embeddings, plain-w RMSNorm, one rope theta
with optional llama3 frequency scaling, no sliding window).
:func:`llama_config` expresses them as ``Gemma3Config`` switches, so the
quantizer, the kernels, the engine and fusion serve Llama models with no new
execution code. :func:`load_llama_hf` imports a local HF Llama or Qwen-2
safetensors checkpoint through ``models/import_hf.py``'s Llama-shaped loader.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.models.import_hf import glu_site, load_llama_shaped_hf

__all__ = ["llama_config", "Llama", "LLAMA32_1B", "LLAMA32_3B", "QWEN25_05B",
           "tiny_llama_config", "load_llama_hf"]

# The decoder class is shared; the config carries the family differences.
Llama = Gemma3


def llama_config(
    *,
    vocab_size: int,
    hidden_size: int,
    intermediate_size: int,
    num_layers: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int | None = None,
    rope_theta: float = 500_000.0,
    rope_scaling: tuple | None = None,
    rms_norm_eps: float = 1e-5,
    tie_lm_head: bool = True,
    attn_bias: bool = False,
    dtype: str = "float32",
) -> Gemma3Config:
    """A Gemma3Config in the Llama conventions. ``attn_bias=True`` adds q/k/v
    biases (the Qwen-2 convention; those sites are "Gemm" sites)."""
    head_dim = head_dim or hidden_size // num_heads
    return Gemma3Config(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        rope_theta=rope_theta,
        rope_local_base=rope_theta,  # unused: every layer is global
        sliding_window=0,
        sliding_pattern=1,  # (i + 1) % 1 == 0: every layer global
        rms_norm_eps=rms_norm_eps,
        query_pre_attn_scalar=float(head_dim),  # 1 / sqrt(head_dim)
        use_qk_norm=False,
        sandwich_norms=False,
        mlp_activation="silu",
        scale_embeddings=False,
        rms_one_plus=False,
        tie_lm_head=tie_lm_head,
        rope_scaling=rope_scaling,
        attn_bias=attn_bias,
        dtype=dtype,
    )


# Llama-3.2 text configs (HF ``config.json`` values): tied lm_head, llama3
# rope scaling (factor 32, low 1, high 4, original context 8192).
LLAMA32_1B = llama_config(
    vocab_size=128_256, hidden_size=2048, intermediate_size=8192,
    num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
    rope_scaling=(32.0, 1.0, 4.0, 8192),
)

LLAMA32_3B = llama_config(
    vocab_size=128_256, hidden_size=3072, intermediate_size=8192,
    num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
    rope_scaling=(32.0, 1.0, 4.0, 8192),
)

# Qwen-2.5-0.5B (HF config.json): GQA with q/k/v biases, theta 1e6, tied head.
QWEN25_05B = llama_config(
    vocab_size=151_936, hidden_size=896, intermediate_size=4864,
    num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
    rope_theta=1_000_000.0, rms_norm_eps=1e-6, attn_bias=True,
)


def tiny_llama_config(**kw) -> Gemma3Config:
    """Scaled-down Llama-convention config for tests."""
    base = dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
    )
    base.update(kw)
    return llama_config(**base)


def load_llama_hf(model, directory: str, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> dict:
    """The framework param tree from a local HF Llama checkpoint directory (or
    Qwen-2's, whose q/k/v biases land in the Gemm sites' ``b``), as ``dtype``
    on ``device``. The lm_head is tied to the embedding unless the checkpoint
    carries its own."""
    def mlp_fn(prefix: str, proj) -> dict:
        return glu_site(proj, f"{prefix}.mlp.gate_proj.weight", f"{prefix}.mlp.up_proj.weight",
                        f"{prefix}.mlp.down_proj.weight")

    return load_llama_shaped_hf(model, directory, mlp_fn, dtype, device)
