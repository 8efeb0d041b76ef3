"""Layers that are not quantizable sites: embedding, RMSNorm, rotary.

Counterpart of ``onnx_quantize_tpu/nn/layers.py`` (single-device part).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.nn.module import Module

__all__ = ["Embedding", "RMSNorm", "apply_rope"]


class Embedding(Module):
    """Token embedding (a gather, not a quantizable matmul site)."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.features = features
        self.dtype = dtype

    def init(self, generator: torch.Generator) -> dict:
        w = torch.randn((self.vocab_size, self.features), generator=generator,
                        device=generator.device) * 0.02
        return {"w": w.to(self.dtype)}

    def forward(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        return params["w"][ids]


class RMSNorm(Module):
    """RMSNorm computed in float32 with the Gemma gain ``1 + w`` (zero-init).

    The Llama convention (gain ``w``, ones-init) waits with the Llama port
    (ROADMAP.md, Queue A item 11).
    """

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.eps = eps
        self.dtype = dtype

    def init(self, generator: torch.Generator) -> dict:
        return {"w": torch.zeros((self.features,), dtype=self.dtype, device=generator.device)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * (1.0 + params["w"].to(torch.float32))).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """Rotary position embedding, neox rotate-half convention.

    x: (B, T, num_heads, head_dim); positions: (B, T). The llama3 frequency
    scaling waits with the Llama port (ROADMAP.md, Queue A item 11).
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=x.device) * (2.0 / head_dim)
    inv_freq = 1.0 / (base ** exponents)
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[:, :, None, :]  # (B, T, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
