"""A plain float32 DeepSeek-V2 forward for the tests, in the published form.

Imports nothing of the port and no JAX: the weights are a Hugging Face state
dict (``(out, in)`` Linear weights under the checkpoint's names) and the
sizes a ``config.json`` dict. It follows ``modeling_deepseek.py`` of the
DeepSeek-V2-Lite checkpoint and the paper's section 2.1:

* RMSNorm pre-norms (gain w), the residual stream in float32;
* attention decompressed per head: ``q = x Wq`` split into ``q_nope`` and
  ``q_pe``; ``[c ; k_pe] = x Wkv_a``, ``c`` RMS-normalized by
  ``kv_a_layernorm``; ``[k_nope ; v] = c Wkv_b`` per head; RoPE on ``q_pe``
  and ``k_pe`` over adjacent pairs (2i, 2i + 1), YaRN frequencies where
  ``rope_scaling`` is set; ``k = [k_nope ; k_pe]``; causal softmax at
  ``(nope + rope) ** -0.5 x mscale ** 2``;
* layer ``i < first_k_dense_replace`` a SiLU MLP; the others a float32
  softmax router, the top-k experts, their weights left unnormalized (times
  ``routed_scaling_factor``) where ``norm_topk_prob`` is false, and the
  shared experts (one SiLU MLP of ``n_shared_experts x
  moe_intermediate_size``) added ungated;
* an untied lm_head.

Departures: everything runs in float32 with TF32 off (the published code
runs the checkpoint's bf16); cos and sin stay float32 (the original caches
them in the activations' dtype); queries run in blocks of ``_BLOCK``. The
latent rows ``[c ; k_pe]`` may be rounded as a cache would hold them
(``latent``): ``"int8"``, two symmetric absmax / 127 scales a row (one over
``c``, one over ``k_pe``), the program's cache; ``"int8_one_scale"``, one
scale over the whole row; ``"int4"``, two scales at absmax / 7.
"""

from __future__ import annotations

import math

import torch

__all__ = ["forward", "yarn_inv_freq", "yarn_mscale", "round_latent"]

_BLOCK = 64


def yarn_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, rope_scaling: dict) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies."""
    factor = rope_scaling["factor"]
    orig = rope_scaling["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rope_scaling["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rope_scaling["beta_slow"], dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def _rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x (T, H, d) at positions 0..T-1, pairs (2i, 2i + 1) rotated as
    ``modeling_deepseek.py``'s ``apply_rotary_pos_emb`` does (it regroups
    the pairs into halves, then rotates halves)."""
    t, h, d = x.shape
    scaling = cfg.get("rope_scaling")
    base = float(cfg["rope_theta"])
    amp = 1.0
    if scaling:
        inv = yarn_inv_freq(d, base, scaling)
        amp = (yarn_mscale(scaling["factor"], scaling["mscale"])
               / yarn_mscale(scaling["factor"], scaling["mscale_all_dim"]))
    else:
        inv = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = (emb.cos() * amp)[:, None, :], (emb.sin() * amp)[:, None, :]
    x = x.reshape(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _sym(x: torch.Tensor, levels: int) -> torch.Tensor:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def round_latent(c: torch.Tensor, k_pe: torch.Tensor, latent: str):
    """The latent rows as a cache of kind ``latent`` holds them."""
    if latent == "float":
        return c, k_pe
    if latent == "int8":
        return _sym(c, 127), _sym(k_pe, 127)
    if latent == "int4":
        return _sym(c, 7), _sym(k_pe, 7)
    if latent == "int8_one_scale":
        row = _sym(torch.cat([c, k_pe], dim=-1), 127)
        return row[..., :c.shape[-1]], row[..., c.shape[-1]:]
    raise ValueError(f"unknown latent rounding {latent!r}")


def _lin(x, sd, name):
    return x @ sd[name].to(torch.float32).T


def _mlp(x, sd, prefix):
    return _lin(torch.nn.functional.silu(_lin(x, sd, f"{prefix}.gate_proj.weight"))
                * _lin(x, sd, f"{prefix}.up_proj.weight"), sd, f"{prefix}.down_proj.weight")


def _attention(x, sd, p, cfg, latent):
    t = x.shape[0]
    H, nope, rope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = _lin(x, sd, f"{p}.q_proj.weight").view(t, H, nope + rope)
    q_nope, q_pe = q[..., :nope], _rope(q[..., nope:], cfg)
    ckv = _lin(x, sd, f"{p}.kv_a_proj_with_mqa.weight")
    c = _rms(ckv[:, :r], sd[f"{p}.kv_a_layernorm.weight"].to(torch.float32),
             cfg["rms_norm_eps"])
    k_pe = _rope(ckv[:, None, r:], cfg)[:, 0]
    c, k_pe = round_latent(c, k_pe, latent)
    kv = _lin(c, sd, f"{p}.kv_b_proj.weight").view(t, H, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(t, H, rope)], dim=-1)
    v = kv[..., nope:]
    qf = torch.cat([q_nope, q_pe], dim=-1)
    scale = (nope + rope) ** -0.5
    scaling = cfg.get("rope_scaling")
    if scaling and scaling.get("mscale_all_dim"):
        scale *= yarn_mscale(scaling["factor"], scaling["mscale_all_dim"]) ** 2
    out = torch.empty((t, H, dv), dtype=torch.float32)
    for t0 in range(0, t, _BLOCK):
        t1 = min(t, t0 + _BLOCK)
        scores = torch.einsum("thd,shd->hts", qf[t0:t1], k[:t1]) * scale
        causal = torch.arange(t1)[None, :] <= torch.arange(t0, t1)[:, None]
        scores = scores.masked_fill(~causal, float("-inf"))
        out[t0:t1] = torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v[:t1])
    return _lin(out.reshape(t, H * dv), sd, f"{p}.o_proj.weight")


def _moe(x, sd, p, cfg):
    logits = _lin(x, sd, f"{p}.mlp.gate.weight")
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    top_p = top_p * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel():
            y = _mlp(x[rows], sd, f"{p}.mlp.experts.{e}") * top_p[rows, slot][:, None]
            out.index_add_(0, rows, y)
    return out + _mlp(x, sd, f"{p}.mlp.shared_experts")


@torch.no_grad()
def forward(sd: dict, cfg: dict, ids, latent: str = "float") -> torch.Tensor:
    """Logits (T, vocab) of the token list ``ids`` at positions 0..T-1."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps = cfg["rms_norm_eps"]
        x = sd["model.embed_tokens.weight"].to(torch.float32)[torch.as_tensor(ids)]
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}"
            h = _rms(x, sd[f"{p}.input_layernorm.weight"].to(torch.float32), eps)
            x = x + _attention(h, sd, f"{p}.self_attn", cfg, latent)
            h = _rms(x, sd[f"{p}.post_attention_layernorm.weight"].to(torch.float32), eps)
            x = x + (_mlp(h, sd, f"{p}.mlp") if i < cfg["first_k_dense_replace"]
                     else _moe(h, sd, p, cfg))
        x = _rms(x, sd["model.norm.weight"].to(torch.float32), eps)
        return _lin(x, sd, "lm_head.weight")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
