"""Layers that are not quantizable sites: embedding, RMSNorm, rotary.

Counterpart of ``onnx_quantize_tpu/nn/layers.py``.
"""

from __future__ import annotations

import math

import torch

from onnx_quantize_tpu_torch.core.numerics import true_div
from onnx_quantize_tpu_torch.nn.module import Module

__all__ = ["Embedding", "RMSNorm", "apply_rope", "yarn_inv_freq", "yarn_mscale"]


class Embedding(Module):
    """Token embedding (a gather, not a quantizable matmul site)."""

    def __init__(self, vocab_size: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.features = features
        self.dtype = dtype
        # Tensor-parallel marker (set by ``tp_localize``): the table's vocab
        # rows are split over this mesh axis; the lookup zeroes ids outside
        # the local rows and sums the partial embeddings over the axis.
        self.tp_vocab_axis: str | None = None

    def init(self, generator: torch.Generator) -> dict:
        w = torch.randn((self.vocab_size, self.features), generator=generator,
                        device=generator.device) * 0.02
        return {"w": w.to(self.dtype)}

    def forward(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        w = params["w"]
        if self.tp_vocab_axis is None:
            return w[ids]
        from onnx_quantize_tpu_torch.parallel.comm import all_reduce, axis_index

        rows = w.shape[0]
        local = ids - axis_index(self.tp_vocab_axis) * rows
        valid = (local >= 0) & (local < rows)
        emb = torch.where(valid[..., None], w[local.clamp(0, rows - 1)], 0)
        # One rank holds each row, so the sum is exact; it runs in float32.
        return all_reduce(emb.to(torch.float32), self.tp_vocab_axis).to(w.dtype)


class RMSNorm(Module):
    """RMSNorm computed in float32.

    ``one_plus=True`` (Gemma convention): gain ``1 + w``, zero-init.
    ``one_plus=False`` (Llama convention): gain ``w``, ones-init.
    """

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 one_plus: bool = True):
        super().__init__()
        self.features = features
        self.eps = eps
        self.dtype = dtype
        self.one_plus = one_plus

    def init(self, generator: torch.Generator) -> dict:
        fill = torch.zeros if self.one_plus else torch.ones
        return {"w": fill((self.features,), dtype=self.dtype, device=generator.device)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        gain = params["w"].to(torch.float32)
        return (normed * ((1.0 + gain) if self.one_plus else gain)).to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention-temperature factor ``0.1 * mscale * ln(factor) + 1``
    (1 at ``factor <= 1``), as DeepSeek-V2's modelling file computes it."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original_max_position: int,
                  beta_fast: float, beta_slow: float, device=None) -> torch.Tensor:
    """YaRN's (dim/2,) float32 inverse frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): the frequencies that turn fewer than
    ``beta_slow`` times over the original context are divided by ``factor``,
    those that turn more than ``beta_fast`` times are kept, and a linear
    ramp over the dimensions between blends the two."""
    def correction_dim(rotations: float) -> float:
        return (dim * math.log(original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    idx = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    freq_extra = 1.0 / (base ** (idx / dim))
    freq_inter = 1.0 / (factor * base ** (idx / dim))
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0.0, 1.0)
    keep = 1.0 - ramp
    return freq_inter * (1.0 - keep) + freq_extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               scaling: tuple | None = None, yarn: tuple | None = None) -> torch.Tensor:
    """Rotary position embedding, neox rotate-half convention.

    x: (B, T, num_heads, head_dim); positions: (B, T). ``scaling``: llama3
    frequency scaling as ``(factor, low_freq_factor, high_freq_factor,
    original_max_position)``: wavelengths beyond ``orig/low`` divide by
    ``factor``, those below ``orig/high`` are kept, and the band between
    interpolates (in float32, as the reference). ``yarn``: YaRN scaling as
    ``(factor, original_max_position, beta_fast, beta_slow, mscale,
    mscale_all_dim)`` (:func:`yarn_inv_freq`), cos and sin scaled by
    ``yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all_dim)``.
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    exponents = torch.arange(half, dtype=torch.float32, device=x.device) * (2.0 / head_dim)
    inv_freq = 1.0 / (base ** exponents)
    if yarn is not None:
        factor, orig, beta_fast, beta_slow, mscale, mscale_all = yarn
        inv_freq = yarn_inv_freq(head_dim, base, factor, orig, beta_fast, beta_slow, x.device)
        amp = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
    if scaling is not None:
        factor, low_f, high_f, orig_ctx = scaling
        # Divisions by device scalars: one IEEE division each, on every device.
        wavelen = torch.full_like(inv_freq, 2.0 * math.pi) / inv_freq
        smooth = true_div(torch.full_like(inv_freq, orig_ctx) / wavelen - low_f, high_f - low_f)
        smooth = smooth.clamp(0.0, 1.0)
        inv_freq = true_div((1.0 - smooth) * inv_freq, factor) + smooth * inv_freq
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[:, :, None, :]  # (B, T, 1, half)
    sin = torch.sin(angles)[:, :, None, :]
    if yarn is not None and amp != 1.0:
        cos, sin = cos * amp, sin * amp
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
