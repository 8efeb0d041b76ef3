"""Float weights of a DeepSeek-V2 configuration, drawn from the run's seed.

The counterpart of ``weights.py`` for a configuration with multi-head latent
attention (``kv_lora_rank`` in its file): the same seeding, one layer at a
time from ``weights.layer_seed(seed, layer)`` into one flat buffer, and the
embedding and lm_head drawn by ``weights.py`` itself. Leaves are (in, out)
under the port's dotted site names; the attention's rope columns are in the
published layout (adjacent pairs), which the reference reads as they are
and the program permutes at import. RMSNorm gains (the two pre-norms and
``kv_a_layernorm``) are ones and are not drawn. Plain torch only.
"""

from __future__ import annotations

import torch

from h100bench.benchlib import weights

__all__ = ["ShapesMLA", "layer_leaves"]


class ShapesMLA:
    """The sizes a DeepSeek-V2 configuration file states, under the Hugging
    Face keys."""

    def __init__(self, cfg: dict):
        self.hidden = cfg["hidden_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.rank = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope = cfg["qk_rope_head_dim"]
        self.v_dim = cfg["v_head_dim"]
        self.dense_width = cfg["intermediate_size"]
        self.first_dense = cfg["first_k_dense_replace"]
        self.experts = cfg["n_routed_experts"]
        self.top_k = cfg["num_experts_per_tok"]
        self.expert_width = cfg["moe_intermediate_size"]
        self.shared_width = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
        self.vocab = cfg["vocab_size"]
        self.norm_topk = bool(cfg["norm_topk_prob"])
        self.routed_scale = float(cfg.get("routed_scaling_factor", 1.0))
        self.rope_theta = float(cfg["rope_theta"])
        self.rope_scaling = cfg.get("rope_scaling")
        self.eps = float(cfg["rms_norm_eps"])

    def is_dense(self, layer: int) -> bool:
        return layer < self.first_dense

    def linear_shapes(self, layer: int) -> list[tuple[str, tuple[int, int]]]:
        """(site, (in, out)) of one layer's Linear weights, in draw order."""
        d, H = self.hidden, self.heads
        out = [("attn.q_proj", (d, H * (self.nope + self.rope))),
               ("attn.kv_a_proj", (d, self.rank + self.rope)),
               ("attn.kv_b_proj", (self.rank, H * (self.nope + self.v_dim))),
               ("attn.o_proj", (H * self.v_dim, d))]
        if self.is_dense(layer):
            w = self.dense_width
            return out + [("mlp.gate_proj", (d, w)), ("mlp.up_proj", (d, w)),
                          ("mlp.down_proj", (w, d))]
        out.append(("mlp.router", (d, self.experts)))
        for e in range(self.experts):
            out += [(f"mlp.experts.{e}.gate_proj", (d, self.expert_width)),
                    (f"mlp.experts.{e}.up_proj", (d, self.expert_width)),
                    (f"mlp.experts.{e}.down_proj", (self.expert_width, d))]
        return out + [("mlp.shared.gate_proj", (d, self.shared_width)),
                      ("mlp.shared.up_proj", (d, self.shared_width)),
                      ("mlp.shared.down_proj", (self.shared_width, d))]


def layer_leaves(shapes: ShapesMLA, seed: int, layer: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """One layer's float leaves ``{"w": {site: (in, out)}}``, views of one
    buffer drawn in one call."""
    lin = shapes.linear_shapes(layer)
    buf = weights._flat(sum(k * n for _, (k, n) in lin), weights.layer_seed(seed, layer),
                        device, dtype)
    w, at = {}, 0
    for name, (k, n) in lin:
        w[name] = buf[at:at + k * n].view(k, n)
        at += k * n
    return {"w": w}
