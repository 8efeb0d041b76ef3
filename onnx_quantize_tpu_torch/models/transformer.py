"""Generic pre-norm transformer LM (GPT-style): the second model family.

Counterpart of ``onnx_quantize_tpu/models/transformer.py``: standard MHA with
biases (so the attention projections, ``fc_in`` and ``fc_out`` are *Gemm*
sites), LayerNorm in float32, the tanh GELU MLP, learned positional
embeddings and an untied, bias-free lm_head (a *MatMul* site). BASELINE
config 2 (int8 per-channel weights with dynamic asymmetric uint8 inputs)
targets this family; on a CUDA device each of its sites runs the W8 kernel
behind the activation QDQ, and a QLINEAR tree runs the Q8 kernel.

Attention is einsum and softmax in float32 with the causal logits filled
with -1e30, as the reference computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from onnx_quantize_tpu_torch.core.numerics import true_div
from onnx_quantize_tpu_torch.nn.layers import Embedding
from onnx_quantize_tpu_torch.nn.module import Context, InputSpec, Linear, Module

__all__ = ["TransformerConfig", "TransformerLM", "LayerNorm"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 512
    hidden_size: int = 128
    intermediate_size: int = 512
    num_layers: int = 2
    num_heads: int = 4
    max_seq: int = 256
    layer_norm_eps: float = 1e-5


class LayerNorm(Module):
    """LayerNorm in float32 (``rsqrt(var + eps)``), cast back to the input's
    dtype."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.features = features
        self.eps = eps

    def init(self, generator: torch.Generator) -> dict:
        return {"w": torch.ones((self.features,), device=generator.device),
                "b": torch.zeros((self.features,), device=generator.device)}

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        normed = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (normed * params["w"] + params["b"]).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           keep: torch.Tensor) -> torch.Tensor:
    """Softmax attention over (B, T, H, hd) with the logits where ``keep``
    (broadcast to (B, H, T, S)) is false filled with -1e30 in float32."""
    B, T, H, hd = q.shape
    logits = true_div(torch.einsum("bthd,bshd->bhts", q, k), math.sqrt(hd))
    logits = torch.where(keep, logits.to(torch.float32), -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, H * hd)


class MHA(Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = Linear(d, d, use_bias=True)
        self.k_proj = Linear(d, d, use_bias=True)
        self.v_proj = Linear(d, d, use_bias=True)
        self.o_proj = Linear(d, d, use_bias=True)

    def forward(self, params, x, ctx: Context | None = None):
        B, T, d = x.shape
        H = self.cfg.num_heads
        q, k, v = (proj(params[name], x, ctx=ctx).reshape(B, T, H, d // H)
                   for name, proj in (("q_proj", self.q_proj), ("k_proj", self.k_proj),
                                      ("v_proj", self.v_proj)))
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        return self.o_proj(params["o_proj"], attend(q, k, v, causal), ctx=ctx)


class Block(Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attn = MHA(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=True)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, use_bias=True)

    def forward(self, params, x, ctx: Context | None = None):
        x = x + self.attn(params["attn"], self.ln1(params["ln1"], x), ctx=ctx)
        h = self.fc_in(params["fc_in"], self.ln2(params["ln2"], x), ctx=ctx)
        h = F.gelu(h, approximate="tanh")
        return x + self.fc_out(params["fc_out"], h, ctx=ctx)


class TransformerLM(Module):
    """Blocks under the param keys ``h.0``, ``h.1``, ... ``forward`` returns
    the logits (B, T, vocab)."""

    def __init__(self, cfg: TransformerConfig = TransformerConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = Embedding(cfg.max_seq, cfg.hidden_size)
        self.h = torch.nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, use_bias=False)
        self.input_specs = [InputSpec("input_ids", (16,), np.int32)]
        self.finalize()

    def forward(self, params, input_ids, ctx: Context | None = None):
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = self.embed(params["embed"], input_ids) + self.pos_embed(params["pos_embed"], pos)
        for i, block in enumerate(self.h):
            x = block(params[f"h.{i}"], x, ctx=ctx)
        x = self.ln_f(params["ln_f"], x)
        return self.lm_head(params["lm_head"], x, ctx=ctx)
