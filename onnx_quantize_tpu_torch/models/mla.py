"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 section 2.1) on
the shared decoder.

A layer with ``cfg.kv_lora_rank > 0`` projects each token to its queries
(``q_proj``: per head ``q_nope`` of ``qk_nope_head_dim`` and ``q_pe`` of
``qk_rope_head_dim``) and to one latent row shared by every head
(``kv_a_proj``: ``c`` of ``kv_lora_rank``, RMS-normalized by ``kv_a_norm``,
and ``k_pe`` of ``qk_rope_head_dim``). RoPE (YaRN where the config has it)
turns ``q_pe`` and ``k_pe``. The published form decompresses the latent per
head through ``kv_b_proj`` (rank -> heads x (nope + v)): ``k = [c W_UK ;
k_pe]`` and ``v = c W_UV``. This module computes the absorbed form instead,
which reads the latent rows and never forms per-head K or V:

    q_lat = q_nope W_UK^T                       (heads x rank a token)
    score = (q_lat . c + q_pe . k_pe) x scale
    out   = (softmax(score) . c) W_UV

Over the engine's int8 latent cache the two scales a row fold in as
``_attend`` folds the K/V scales: ``q_lat . c`` by the ``c`` scale, ``q_pe
. k_pe`` by the ``k_pe`` scale, and the probabilities by the ``c`` scale
before they meet the codes. The queries run in blocks, so that no (B,
heads, T, S) float32 tensor of a long prompt is whole. ``kv_b_proj`` stays a
float weight: its halves meet the queries and the attention output per head
as batched products, which the W4 kernel's (M, K) x (K, N) does not take.

The softmax scale is ``(nope + rope) ** -0.5 x mscale ** 2``, with ``mscale
= yarn_mscale(factor, mscale_all_dim)`` under YaRN, as the original
modelling file sets it (the Hugging Face port keeps ``(nope + rope) ** -0.5``
alone). RoPE rotates halves here (``apply_rope``); the published weights
rotate adjacent pairs (2i, 2i + 1), so their rope columns are permuted once
at import (``models/deepseek_v2.py::rope_pairs_to_halves``).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch import tracing
from onnx_quantize_tpu_torch.engine.kv_cache import LatentKV
from onnx_quantize_tpu_torch.nn.layers import RMSNorm, apply_rope, yarn_mscale
from onnx_quantize_tpu_torch.nn.module import Linear, Module, apply_linear
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.reference import dequantize_weight

__all__ = ["LatentAttention", "latent_attend", "softmax_scale"]

# Elements of one (B, heads, T_block, S) float32 score block: the query
# block shrinks so that a block's scores and probabilities stay ~0.5 GB each.
_BLOCK_ELEMS = 1 << 27


def softmax_scale(cfg) -> float:
    """``(nope + rope) ** -0.5``, times ``mscale ** 2`` under YaRN."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.rope_yarn is not None:
        factor, *_, mscale_all = cfg.rope_yarn
        scale *= yarn_mscale(factor, mscale_all) ** 2
    return scale


def _query_block(B: int, H: int, T: int, S: int) -> int:
    return max(1, min(T, _BLOCK_ELEMS // max(1, B * H * S)))


def latent_attend(q_nope, q_pe, kv: LatentKV, mask, w_b, cfg) -> torch.Tensor:
    """Attention in the absorbed form over latent rows.

    q_nope (B, T, H, nope) and q_pe (B, T, H, rope), rope applied; ``kv``
    the rows (B, S, rank + rope), int8 codes with their (B, S, 2) scales or
    float; mask (B, 1, T, >= S) additive float32; ``w_b`` kv_b_proj's
    (rank, H x (nope + v)) weight. Returns (B, T, H x v) in q's dtype."""
    B, T, H, nope = q_nope.shape
    r = cfg.kv_lora_rank
    dtype = q_nope.dtype
    wb = w_b.to(dtype).reshape(r, H, nope + cfg.v_head_dim)
    w_uk, w_uv = wb[..., :nope], wb[..., nope:]
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)
    rows = kv.rows.to(dtype)  # int8 codes are exact in bf16
    S = rows.shape[1]
    c, k_pe = rows[..., :r], rows[..., r:]
    if kv.scale is not None:
        c_scale = kv.scale[..., 0][:, None, None, :]  # (B, 1, 1, S)
        pe_scale = kv.scale[..., 1][:, None, None, :]
    scale = softmax_scale(cfg)
    step = _query_block(B, H, T, S)
    outs = []
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        s_c = torch.einsum("bthr,bsr->bhts", q_lat[:, t0:t1], c).to(torch.float32)
        s_pe = torch.einsum("bthp,bsp->bhts", q_pe[:, t0:t1], k_pe).to(torch.float32)
        if kv.scale is not None:
            s_c, s_pe = s_c * c_scale, s_pe * pe_scale
        logits = (s_c + s_pe) * scale + mask[:, :, t0:t1, :S]
        probs = torch.softmax(logits, dim=-1)
        if kv.scale is not None:
            probs = probs * c_scale
        o_lat = torch.einsum("bhts,bsr->bthr", probs.to(dtype), c)
        outs.append(torch.einsum("bthr,rhv->bthv", o_lat, w_uv))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, T, H * cfg.v_head_dim)


class LatentAttention(Module):
    """A DeepSeek-V2 attention layer (see the module docstring). Sites:
    ``q_proj``, ``kv_a_proj`` (fused as ``_fused_qa`` by
    ``fuse_gemma3_projections`` where they quantize alike), ``kv_b_proj``
    and ``o_proj``; ``kv_a_norm`` is the latent's RMSNorm."""

    def __init__(self, cfg, layer_idx: int):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        d, dt, H = cfg.hidden_size, cfg.torch_dtype, cfg.num_heads
        nope, rope, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
        self.q_proj = Linear(d, H * (nope + rope), use_bias=False, dtype=dt)
        self.kv_a_proj = Linear(d, r + rope, use_bias=False, dtype=dt)
        self.kv_a_norm = RMSNorm(r, cfg.rms_norm_eps, dtype=dt, one_plus=cfg.rms_one_plus)
        self.kv_b_proj = Linear(r, H * (nope + cfg.v_head_dim), use_bias=False, dtype=dt)
        self.o_proj = Linear(H * cfg.v_head_dim, d, use_bias=False, dtype=dt)
        # No context-parallel attend over latent rows (the decoder reads the marker).
        self.cp_spec = None

    def _project(self, params, x, positions, ctx=None):
        """(q_nope, q_pe, c, k_pe): the queries per head and the latent row,
        RoPE applied."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        n_q = H * (nope + rope)
        if "_fused_qa" in params:
            qa = apply_linear(params["_fused_qa"], x)
            q, ckv = qa[..., :n_q], qa[..., n_q:]
        else:
            q = self.q_proj(params["q_proj"], x, ctx=ctx)
            ckv = self.kv_a_proj(params["kv_a_proj"], x, ctx=ctx)
        q = q.reshape(B, T, H, nope + rope)
        c = self.kv_a_norm(params["kv_a_norm"], ckv[..., :cfg.kv_lora_rank])
        q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta, yarn=cfg.rope_yarn)
        k_pe = apply_rope(ckv[..., None, cfg.kv_lora_rank:], positions, cfg.rope_theta,
                          yarn=cfg.rope_yarn)[:, :, 0]
        return q[..., :nope], q_pe, c, k_pe

    def forward(self, params, x, positions, mask, kv_write=None, use_flash="auto", ctx=None):
        """As ``Gemma3Attention.forward``: ``kv_write(layer, c, k_pe)``, from
        the engine, stores the new latent rows and returns the
        :class:`LatentKV` attention reads; without it the forward's own
        float rows are read. ``use_flash`` is not used."""
        q_nope, q_pe, c, k_pe = self._project(params, x, positions, ctx)
        kv = (LatentKV(torch.cat([c, k_pe], dim=-1)) if kv_write is None
              else kv_write(self.layer_idx, c, k_pe))
        w_b = params["kv_b_proj"]["w"]
        if isinstance(w_b, QTensor):
            w_b = dequantize_weight(w_b)
        with tracing.span("model.latent_attention"):
            out = latent_attend(q_nope, q_pe, kv, mask, w_b, self.cfg)
        return self.o_proj(params["o_proj"], out.to(x.dtype), ctx=ctx)
