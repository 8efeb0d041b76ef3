"""The system under test: onnx_quantize_tpu_torch's model and quantized tree,
built from the benchmark's float weights by the port's own quantizer and
engine layouts.

The set-up draws and quantizes one layer at a time, so the float model is
never whole on the card (a configuration whose float weights outgrow the
card takes the same path): the layer's floats go through the port's
``quantize`` with the configuration's recipe, then ``fuse_gemma3_projections``
-> ``prepare_kernel_scales`` -> ``fuse_moe_experts``, and are freed before
the next layer. RTN works site by site, so the codes equal those of one
whole-model call. ``quantize_s`` is the host clock around those calls,
ended by a device synchronize.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from h100bench.benchlib import weights

__all__ = ["Program", "build_program", "port_config"]


def port_config(cfg: dict):
    """The port's config object for a configuration file."""
    from onnx_quantize_tpu_torch.models.moe import moe_config

    s = weights.Shapes(cfg)
    return moe_config(
        num_experts=s.experts, num_experts_per_tok=s.top_k, moe_intermediate_size=s.expert_width,
        shared_expert_size=s.shared_width, norm_topk_prob=s.norm_topk, vocab_size=s.vocab,
        hidden_size=s.hidden, intermediate_size=cfg["intermediate_size"], num_layers=s.layers,
        num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
        rope_theta=s.rope_theta, rms_norm_eps=s.eps, attn_bias=s.qkv_bias,
        tie_lm_head=bool(cfg.get("tie_word_embeddings", False)), dtype=cfg["torch_dtype"])


@dataclasses.dataclass
class Program:
    model: object
    tree: dict
    quantize_s: float
    dtype: torch.dtype


def _nest(flat: dict, into: dict, key: str) -> None:
    for site, t in flat.items():
        node = into
        parts = site.split(".")
        # "mlp.experts.3.gate_proj": the expert subtree's key is "experts.3".
        merged = []
        i = 0
        while i < len(parts):
            if parts[i] == "experts":
                merged.append(f"experts.{parts[i + 1]}")
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        for p in merged:
            node = node.setdefault(p, {})
        node[key] = t


def _layer_tree(shapes: weights.Shapes, leaves: dict, device, dtype) -> dict:
    tree: dict = {}
    _nest(leaves["w"], tree, "w")
    _nest(leaves["b"], tree, "b")
    for norm in ("input_norm", "pre_ffn_norm"):
        tree[norm] = {"w": torch.ones((shapes.hidden,), dtype=dtype, device=device)}
    return tree


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_program(cfg: dict, seed: int, device) -> Program:
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.models.gemma3 import fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.moe import MoE, fuse_moe_experts
    from onnx_quantize_tpu_torch.utils import tree_map

    recipe = cfg["recipe"]
    pcfg = port_config(cfg)
    dtype = pcfg.torch_dtype
    model = MoE(pcfg)
    one = MoE(dataclasses.replace(pcfg, num_layers=1))
    body_r, head_r = recipe["body"], recipe["lm_head"]
    body = oqt.QConfig(weights=oqt.QWeightArgs(dtype=body_r["dtype"],
                                               group_size=body_r["group_size"]),
                       ignore=list(body_r["ignore"]))
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype=head_r["dtype"], group_size=-1,
                                               symmetric=head_r["symmetric"]),
                       ignore=[r"^layers\."])
    shapes = weights.Shapes(cfg)
    tree = {"embed": {"w": weights.embed_weight(shapes, seed, device, dtype)},
            "final_norm": {"w": torch.ones((shapes.hidden,), dtype=dtype, device=device)}}
    quantize_s = 0.0
    for i in range(shapes.layers):
        leaves = weights.layer_leaves(shapes, seed, i, device, dtype)
        layer = _layer_tree(shapes, leaves, device, dtype)
        del leaves
        _sync(device)
        t0 = time.perf_counter()
        q, _ = oqt.quantize(one, {"layers.0": layer}, body)
        q = fuse_moe_experts(prepare_kernel_scales(fuse_gemma3_projections(q)))
        _sync(device)
        quantize_s += time.perf_counter() - t0
        # Leaves left in float (router, shared gate, biases) are views of the
        # layer's draw: copy them, so the draw is freed with the layer.
        tree[f"layers.{i}"] = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, q["layers.0"])
        del q, layer
    w_head = weights.lm_head_weight(shapes, seed, device, dtype)
    _sync(device)
    t0 = time.perf_counter()
    q, _ = oqt.quantize(one, {"lm_head": {"w": w_head}}, head)
    _sync(device)
    quantize_s += time.perf_counter() - t0
    tree["lm_head"] = q["lm_head"]
    del q, w_head
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return Program(model=model, tree=tree, quantize_s=quantize_s, dtype=dtype)
