"""The system under test for a DeepSeek-V2 configuration: the port's
``DEEPSEEK_V2``-shaped model (``models/deepseek_v2.py``) and its quantized
tree, built from the benchmark's float weights by the port's own quantizer,
importer and engine layouts, as ``program.py`` builds Qwen's.

One layer at a time: the layer's floats (``weights_mla.py``, rope columns in
the published pairs) have their rope columns permuted to the port's halves
by the port's importer (``rope_pairs_to_halves``), go through ``quantize``
with the configuration's recipe on a one-layer model of the layer's kind
(dense or MoE), then ``fuse_gemma3_projections`` -> ``prepare_kernel_scales``
-> ``fuse_moe_experts``, and are freed before the next. ``quantize_s`` is the
host clock around the quantizer and layout calls, ended by a device
synchronize.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from h100bench.benchlib import weights, weights_mla
from h100bench.benchlib.program import Program, _nest, _sync

__all__ = ["build_program", "port_config"]


def port_config(cfg: dict):
    """The port's config object for a DeepSeek-V2 configuration file."""
    from onnx_quantize_tpu_torch.models.deepseek_v2 import deepseek_v2_config

    rs = cfg.get("rope_scaling")
    yarn = None if not rs else (float(rs["factor"]), int(rs["original_max_position_embeddings"]),
                                float(rs["beta_fast"]), float(rs["beta_slow"]),
                                float(rs["mscale"]), float(rs["mscale_all_dim"]))
    return deepseek_v2_config(
        hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        vocab_size=cfg["vocab_size"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], num_experts=cfg["n_routed_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        norm_topk_prob=bool(cfg["norm_topk_prob"]), rope_theta=float(cfg["rope_theta"]),
        rope_yarn=yarn, rms_norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"])


def _layer_tree(s: weights_mla.ShapesMLA, leaves: dict, device, dtype) -> dict:
    from onnx_quantize_tpu_torch.models.deepseek_v2 import rope_pairs_to_halves

    w = dict(leaves["w"])
    w["attn.q_proj"] = rope_pairs_to_halves(w["attn.q_proj"], s.heads, s.nope, s.rope)
    w["attn.kv_a_proj"] = rope_pairs_to_halves(w["attn.kv_a_proj"], 1, 0, s.rope)
    tree: dict = {}
    _nest(w, tree, "w")
    tree["attn"]["kv_a_norm"] = {"w": torch.ones((s.rank,), dtype=dtype, device=device)}
    for norm in ("input_norm", "pre_ffn_norm"):
        tree[norm] = {"w": torch.ones((s.hidden,), dtype=dtype, device=device)}
    return tree


def build_program(cfg: dict, seed: int, device) -> Program:
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.moe import fuse_moe_experts
    from onnx_quantize_tpu_torch.utils import tree_map

    recipe = cfg["recipe"]
    pcfg = port_config(cfg)
    dtype = pcfg.torch_dtype
    model = Gemma3(pcfg)
    # One-layer models of each kind: layer 0 dense, or layer 0 an MoE layer.
    one = {True: Gemma3(dataclasses.replace(pcfg, num_layers=1, first_k_dense_replace=1)),
           False: Gemma3(dataclasses.replace(pcfg, num_layers=1, first_k_dense_replace=0))}
    body_r, head_r = recipe["body"], recipe["lm_head"]
    body = oqt.QConfig(weights=oqt.QWeightArgs(dtype=body_r["dtype"],
                                               group_size=body_r["group_size"]),
                       ignore=list(body_r["ignore"]))
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype=head_r["dtype"], group_size=-1,
                                               symmetric=head_r["symmetric"]),
                       ignore=[r"^layers\."])
    s = weights_mla.ShapesMLA(cfg)
    tree = {"embed": {"w": weights.embed_weight(s, seed, device, dtype)},
            "final_norm": {"w": torch.ones((s.hidden,), dtype=dtype, device=device)}}
    quantize_s = 0.0
    for i in range(s.layers):
        leaves = weights_mla.layer_leaves(s, seed, i, device, dtype)
        layer = _layer_tree(s, leaves, device, dtype)
        del leaves
        _sync(device)
        t0 = time.perf_counter()
        q, _ = oqt.quantize(one[s.is_dense(i)], {"layers.0": layer}, body)
        q = fuse_moe_experts(prepare_kernel_scales(fuse_gemma3_projections(q)))
        _sync(device)
        quantize_s += time.perf_counter() - t0
        # Leaves left in float (router, kv_b_proj) are views of the layer's
        # draw or of its permuted copy: copy them, so the draw is freed.
        tree[f"layers.{i}"] = tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, q["layers.0"])
        del q, layer
    w_head = weights.lm_head_weight(s, seed, device, dtype)
    _sync(device)
    t0 = time.perf_counter()
    q, _ = oqt.quantize(one[True], {"lm_head": {"w": w_head}}, head)
    _sync(device)
    quantize_s += time.perf_counter() - t0
    tree["lm_head"] = q["lm_head"]
    del q, w_head
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return Program(model=model, tree=tree, quantize_s=quantize_s, dtype=dtype)
