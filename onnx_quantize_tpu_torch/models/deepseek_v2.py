"""DeepSeek-V2 causal LMs on the shared decoder (DeepSeek-V2-Lite).

DeepSeek-V2 (arXiv:2405.04434) is the Llama-convention decoder with three
switches of ``Gemma3Config``: multi-head latent attention in every block
(``kv_lora_rank`` and the head widths beside it, ``models/mla.py``), YaRN
scaling of its rope dims (``rope_yarn``), and an MoE MLP from block
``first_k_dense_replace`` on, whose routed experts are softmax top-k without
renormalization and whose shared experts (one MLP of ``n_shared_experts x
moe_intermediate_size``) are added without a gate. The engine keeps one
latent row a token and layer (``engine/kv_cache.py``).

:func:`load_deepseek_v2_hf` imports a local Hugging Face checkpoint in the
published names. The published weights rotate the rope dims in adjacent
pairs (2i, 2i + 1); the port rotates halves, so the importer permutes the
rope columns of ``q_proj`` and ``kv_a_proj_with_mqa`` once
(:func:`rope_pairs_to_halves`), which leaves every score unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.models.gemma3 import LatentConfig
from onnx_quantize_tpu_torch.models.import_hf import glu_site, hf_getter, read_safetensors
from onnx_quantize_tpu_torch.models.llama import llama_config

__all__ = ["deepseek_v2_config", "DEEPSEEK_V2_LITE", "tiny_deepseek_v2_config",
           "rope_pairs_to_halves", "load_deepseek_v2_hf", "deepseek_v2_tree"]


def deepseek_v2_config(*, hidden_size: int, intermediate_size: int, num_layers: int,
                       num_heads: int, vocab_size: int, kv_lora_rank: int,
                       qk_nope_head_dim: int, qk_rope_head_dim: int, v_head_dim: int,
                       num_experts: int, num_experts_per_tok: int, moe_intermediate_size: int,
                       n_shared_experts: int, first_k_dense_replace: int,
                       norm_topk_prob: bool = False, rope_theta: float = 10_000.0,
                       rope_yarn: tuple | None = None, rms_norm_eps: float = 1e-6,
                       dtype: str = "float32"):
    """A DeepSeek-V2 config in the published keys' terms. ``rope_yarn`` is
    (factor, original_max_position, beta_fast, beta_slow, mscale,
    mscale_all_dim)."""
    base = llama_config(vocab_size=vocab_size, hidden_size=hidden_size,
                        intermediate_size=intermediate_size, num_layers=num_layers,
                        num_heads=num_heads, num_kv_heads=num_heads,
                        head_dim=qk_nope_head_dim + qk_rope_head_dim, rope_theta=rope_theta,
                        rms_norm_eps=rms_norm_eps, tie_lm_head=False, dtype=dtype)
    return LatentConfig(
        **dict(dataclasses.asdict(base), num_experts=num_experts,
               num_experts_per_tok=num_experts_per_tok, moe_intermediate_size=moe_intermediate_size,
               shared_expert_size=n_shared_experts * moe_intermediate_size,
               norm_topk_prob=norm_topk_prob),
        shared_expert_gated=False, first_k_dense_replace=first_k_dense_replace,
        kv_lora_rank=kv_lora_rank, qk_nope_head_dim=qk_nope_head_dim,
        qk_rope_head_dim=qk_rope_head_dim, v_head_dim=v_head_dim, rope_yarn=rope_yarn)


# DeepSeek-V2-Lite (HF config.json): 27 layers, the first dense (10,944
# wide), then 64 routed experts of 1408 top-6 with 2 shared; MLA at rank 512
# with 128 + 64 query/key dims and 128 value dims a head, no q_lora; YaRN
# factor 40 over 4,096 positions.
DEEPSEEK_V2_LITE = deepseek_v2_config(
    hidden_size=2048, intermediate_size=10944, num_layers=27, num_heads=16,
    vocab_size=102_400, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, num_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
    n_shared_experts=2, first_k_dense_replace=1, norm_topk_prob=False,
    rope_theta=10_000.0, rope_yarn=(40.0, 4096, 32.0, 1.0, 0.707, 0.707),
)


def tiny_deepseek_v2_config(**kw):
    """Scaled-down DeepSeek-V2 config for tests: three layers, the first
    dense, 8 experts top-3 with 2 shared, rank 32, 16 + 16 dims a head for
    q/k and 16 for v, YaRN on."""
    base = dict(hidden_size=64, intermediate_size=96, num_layers=3, num_heads=4,
                vocab_size=256, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                v_head_dim=16, num_experts=8, num_experts_per_tok=3, moe_intermediate_size=32,
                n_shared_experts=2, first_k_dense_replace=1,
                rope_yarn=(40.0, 64, 32.0, 1.0, 0.707, 0.707))
    base.update(kw)
    return deepseek_v2_config(**base)


def rope_pairs_to_halves(w: torch.Tensor, heads: int, nope: int, rope: int) -> torch.Tensor:
    """A projection's (in, heads x (nope + rope)) columns with each head's
    rope dims reordered from adjacent pairs (2i, 2i + 1) to halves (i, i +
    rope / 2): the published weights' rotary convention to ``apply_rope``'s.
    ``nope = 0, heads = 1`` takes the rope columns after a leading block of
    other columns when ``w`` has more: kv_a_proj's (in, rank + rope)."""
    lead = w.shape[1] - heads * (nope + rope)
    order = torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])
    cols = [torch.arange(lead)]
    for h in range(heads):
        at = lead + h * (nope + rope)
        cols += [torch.arange(at, at + nope), at + nope + order]
    return w[:, torch.cat(cols).to(w.device)]


def load_deepseek_v2_hf(model, directory: str, dtype: torch.dtype = torch.float32,
                        device: torch.device | str = "cuda") -> dict:
    """The param tree from a local HF DeepSeek-V2 checkpoint directory (no
    q_lora): :func:`deepseek_v2_tree` of its safetensors."""
    return deepseek_v2_tree(model, read_safetensors(directory), dtype, device)


def deepseek_v2_tree(model, hf: dict, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda") -> dict:
    """The param tree from a DeepSeek-V2 state dict in the published names:
    ``self_attn.q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
    ``kv_b_proj``, ``o_proj``; layer ``i < first_k_dense_replace``'s dense
    ``mlp.*``, the others' ``mlp.gate`` router, ``mlp.experts.{e}.*`` and
    ``mlp.shared_experts.*``. The rope columns of q_proj and
    kv_a_proj_with_mqa are permuted to halves (:func:`rope_pairs_to_halves`)."""
    cfg = model.cfg
    get, proj = hf_getter(hf, dtype, device)
    H, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    params: dict = {"embed": {"w": get("model.embed_tokens.weight")},
                    "final_norm": {"w": get("model.norm.weight")},
                    "lm_head": {"w": proj("lm_head.weight")}}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        if i < cfg.first_k_dense_replace:
            mlp = glu_site(proj, f"{p}.mlp.gate_proj.weight", f"{p}.mlp.up_proj.weight",
                           f"{p}.mlp.down_proj.weight")
        else:
            mlp = {"router": {"w": proj(f"{p}.mlp.gate.weight")}}
            for e in range(cfg.num_experts):
                ep = f"{p}.mlp.experts.{e}"
                mlp[f"experts.{e}"] = glu_site(proj, f"{ep}.gate_proj.weight",
                                               f"{ep}.up_proj.weight", f"{ep}.down_proj.weight")
            sp = f"{p}.mlp.shared_experts"
            mlp["shared"] = glu_site(proj, f"{sp}.gate_proj.weight", f"{sp}.up_proj.weight",
                                     f"{sp}.down_proj.weight")
        params[f"layers.{i}"] = {
            "attn": {
                "q_proj": {"w": rope_pairs_to_halves(proj(f"{a}.q_proj.weight"), H, nope, rope)},
                "kv_a_proj": {"w": rope_pairs_to_halves(proj(f"{a}.kv_a_proj_with_mqa.weight"),
                                                        1, 0, rope)},
                "kv_a_norm": {"w": get(f"{a}.kv_a_layernorm.weight")},
                "kv_b_proj": {"w": proj(f"{a}.kv_b_proj.weight")},
                "o_proj": {"w": proj(f"{a}.o_proj.weight")},
            },
            "mlp": mlp,
            "input_norm": {"w": get(f"{p}.input_layernorm.weight")},
            "pre_ffn_norm": {"w": get(f"{p}.post_attention_layernorm.weight")},
        }
    return params
