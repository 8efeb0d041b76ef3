"""Float weights of a configuration, drawn from the run's seed.

Both sides read these: the program quantizes them with its own quantizer,
and the reference quantizes them again with its own copy of RTN. Each layer
is drawn on its own, from a generator seeded by (seed, layer), in one
``normal_`` call into one flat buffer in the served dtype, so a layer can be
drawn again later (the reference does so layer by layer) and a model larger
than the card's memory in float is never whole.

Leaves follow the port's layout: a Linear weight is (in_features,
out_features); names are the port's dotted site paths inside a layer.
Plain torch only.
"""

from __future__ import annotations

import torch

__all__ = ["Shapes", "layer_leaves", "embed_weight", "lm_head_weight", "layer_seed", "INIT_STD"]

# The published initializer range of both configurations ("initializer_range").
INIT_STD = 0.02
_MASK = (1 << 63) - 1


def layer_seed(seed: int, index: int) -> int:
    """A generator seed for (run seed, part): layers are 0..L-1, the
    embedding -1 and the lm_head -2."""
    return (int(seed) * 1_000_003 + 7_919 * (index + 3)) & _MASK


class Shapes:
    """The sizes a configuration file states, under the Hugging Face keys."""

    def __init__(self, cfg: dict):
        self.hidden = cfg["hidden_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.head_dim = cfg.get("head_dim") or self.hidden // self.heads
        self.experts = cfg.get("num_experts") or cfg.get("num_local_experts")
        self.top_k = cfg["num_experts_per_tok"]
        self.expert_width = cfg.get("moe_intermediate_size") or cfg["intermediate_size"]
        self.shared_width = cfg.get("shared_expert_intermediate_size", 0) or 0
        self.vocab = cfg["vocab_size"]
        self.norm_topk = bool(cfg.get("norm_topk_prob", True))
        self.qkv_bias = bool(cfg.get("qkv_bias", False))
        self.rope_theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])

    def linear_shapes(self) -> list[tuple[str, tuple[int, int]]]:
        """(site, (in, out)) of one layer's Linear weights, in draw order."""
        d, hd = self.hidden, self.head_dim
        out = [("attn.q_proj", (d, self.heads * hd)), ("attn.k_proj", (d, self.kv_heads * hd)),
               ("attn.v_proj", (d, self.kv_heads * hd)), ("attn.o_proj", (self.heads * hd, d)),
               ("mlp.router", (d, self.experts))]
        for e in range(self.experts):
            out += [(f"mlp.experts.{e}.gate_proj", (d, self.expert_width)),
                    (f"mlp.experts.{e}.up_proj", (d, self.expert_width)),
                    (f"mlp.experts.{e}.down_proj", (self.expert_width, d))]
        if self.shared_width:
            out += [("mlp.shared.gate_proj", (d, self.shared_width)),
                    ("mlp.shared.up_proj", (d, self.shared_width)),
                    ("mlp.shared.down_proj", (self.shared_width, d)),
                    ("mlp.shared_gate", (d, 1))]
        return out

    def bias_shapes(self) -> list[tuple[str, int]]:
        if not self.qkv_bias:
            return []
        hd = self.head_dim
        return [("attn.q_proj", self.heads * hd), ("attn.k_proj", self.kv_heads * hd),
                ("attn.v_proj", self.kv_heads * hd)]


def _flat(n: int, seed: int, device, dtype) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty((n,), dtype=dtype, device=device)
    buf.normal_(0.0, INIT_STD, generator=gen)
    return buf


def layer_leaves(shapes: Shapes, seed: int, layer: int, device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """One layer's float leaves: ``{"w": {site: (in, out)}, "b": {site: (out,)}}``,
    views of one buffer drawn in one call. RMSNorm gains are ones (the
    Llama convention's init) and are not drawn."""
    lin = shapes.linear_shapes()
    bias = shapes.bias_shapes()
    total = sum(k * n for _, (k, n) in lin) + sum(n for _, n in bias)
    buf = _flat(total, layer_seed(seed, layer), device, dtype)
    w, b, at = {}, {}, 0
    for name, (k, n) in lin:
        w[name] = buf[at:at + k * n].view(k, n)
        at += k * n
    for name, n in bias:
        b[name] = buf[at:at + n]
        at += n
    return {"w": w, "b": b}


def embed_weight(shapes: Shapes, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    return _flat(shapes.vocab * shapes.hidden, layer_seed(seed, -1), device,
                 dtype).view(shapes.vocab, shapes.hidden)


def lm_head_weight(shapes: Shapes, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """(hidden, vocab), the port's Linear layout."""
    return _flat(shapes.vocab * shapes.hidden, layer_seed(seed, -2), device,
                 dtype).view(shapes.hidden, shapes.vocab)
