"""Mixture-of-Experts causal LMs on the shared decoder (Mixtral, Qwen-MoE).

Counterpart of ``onnx_quantize_tpu/models/moe.py``. The two public MoE
families are ``Gemma3Config`` switches (``num_experts`` and the fields beside
it) on the Llama conventions, so the quantizer, the kernels and the engine
serve them with no new execution code: an MoE model is a model with E times
more Linear sites (``Gemma3MoEMLP`` in ``models/gemma3.py``).

Two engine layouts, applied after quantization, ``fuse_gemma3_projections``
and ``engine.prepare_kernel_scales``:

* :func:`stack_moe_experts`: the per-expert subtrees become site dicts with a
  leading expert axis (``_stacked_experts``); the MLP loops over per-expert
  views of them.
* :func:`fuse_moe_experts`: every expert's fused gate/up concatenated along
  N and every down_proj along K (``_fused_experts``), so a layer's experts
  are two matmuls. A layer it cannot take keeps its per-expert subtrees.

:func:`load_qwen_moe_hf` and :func:`load_mixtral_hf` import local HF
safetensors checkpoints (float32, through the Llama-shaped loader of
``models/import_hf.py``).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.models.import_hf import glu_site, load_llama_shaped_hf
from onnx_quantize_tpu_torch.models.llama import llama_config
from onnx_quantize_tpu_torch.nn.fuse import can_fuse, fuse_sites
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.utils import copy_tree

logger = logging.getLogger(__name__)

__all__ = ["moe_config", "MoE", "tiny_moe_config", "stack_moe_experts", "fuse_moe_experts",
           "QWEN15_MOE_A27B", "MIXTRAL_8X7B", "load_qwen_moe_hf", "load_mixtral_hf"]

# The decoder class is shared; the config carries the MoE structure.
MoE = Gemma3


def moe_config(*, num_experts: int, num_experts_per_tok: int, moe_intermediate_size: int,
               shared_expert_size: int = 0, norm_topk_prob: bool = True,
               **llama_kwargs) -> Gemma3Config:
    """A Llama-convention decoder config with an MoE MLP."""
    return dataclasses.replace(
        llama_config(**llama_kwargs), num_experts=num_experts,
        num_experts_per_tok=num_experts_per_tok, moe_intermediate_size=moe_intermediate_size,
        shared_expert_size=shared_expert_size, norm_topk_prob=norm_topk_prob)


# Qwen1.5-MoE-A2.7B (HF config.json): 60 experts, top-4, no top-k renorm,
# sigmoid-gated shared expert, no GQA, q/k/v biases.
QWEN15_MOE_A27B = moe_config(
    num_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
    shared_expert_size=5632, norm_topk_prob=False,
    vocab_size=151_936, hidden_size=2048, intermediate_size=5632,
    num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
    rope_theta=1_000_000.0, rms_norm_eps=1e-6, attn_bias=True,
    tie_lm_head=False,
)

# Mixtral-8x7B (HF config.json): 8 experts, top-2 with renormalization.
MIXTRAL_8X7B = moe_config(
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
    shared_expert_size=0, norm_topk_prob=True,
    vocab_size=32_000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=1_000_000.0, rms_norm_eps=1e-5, tie_lm_head=False,
)


def tiny_moe_config(**kw) -> Gemma3Config:
    """Scaled-down MoE config for tests (the JAX package's)."""
    base = dict(
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
        shared_expert_size=0, norm_topk_prob=True,
        vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
    )
    base.update(kw)
    return moe_config(**base)


def _expert_subtrees(mlp: dict) -> list[str]:
    return sorted((k for k in mlp if k.startswith("experts.")),
                  key=lambda s: int(s.split(".", 1)[1]))


def _moe_layers(params: dict):
    """(layer name, mlp dict, its expert keys) of each layer with experts."""
    for name, layer in params.items():
        if not (isinstance(layer, dict) and "attn" in layer):
            continue
        mlp = layer.get("mlp")
        if isinstance(mlp, dict) and _expert_subtrees(mlp):
            yield name, mlp, _expert_subtrees(mlp)


# -- engine layout: expert stacking ------------------------------------------

def _stack_leaves(leaves: list):
    """Stack one leaf position across experts (None stays None)."""
    if all(v is None for v in leaves):
        return None
    if any(v is None for v in leaves):
        raise ValueError("experts disagree on which qparams are present")
    return torch.stack(leaves)


def _stack_sites(sites: list[dict]) -> dict:
    """Per-expert Linear-site dicts stacked along a new leading axis."""
    keys = set(sites[0])
    for s in sites[1:]:
        if set(s) != keys:
            raise ValueError(f"experts disagree on site keys: {set(s)} vs {keys}")
    if "b" in keys:
        raise ValueError("stacked MoE experts do not support biased projections")
    out: dict = {}
    for key in keys:
        leaves = [s[key] for s in sites]
        if isinstance(leaves[0], QTensor):
            meta = leaves[0].meta
            if any(not isinstance(qt, QTensor) or qt.meta != meta for qt in leaves[1:]):
                raise ValueError(f"experts must be quantized identically to stack (site "
                                 f"{key!r} differs)")
            out[key] = QTensor(meta=meta, **{
                f.name: _stack_leaves([getattr(qt, f.name) for qt in leaves])
                for f in dataclasses.fields(QTensor) if f.name != "meta"})
        elif any(isinstance(v, QTensor) for v in leaves):
            raise ValueError(f"experts mix quantized and fp weights at {key!r}")
        else:
            out[key] = _stack_leaves(leaves)
    return out


def stack_moe_experts(params: dict) -> dict:
    """Engine-load transform: per-expert subtrees -> stacked site dicts.

    Apply after quantization, ``fuse_gemma3_projections`` and
    ``engine.prepare_kernel_scales`` (which skips leaves whose data carries
    the expert axis; per-expert views of a baked stack keep the kernel
    layout). Returns a new tree; the input is left untouched."""
    params = copy_tree(params)
    site_map = {"gate_up": "_fused_gate_up", "gate": "gate_proj", "up": "up_proj",
                "down": "down_proj"}
    for _, mlp, expert_keys in list(_moe_layers(params)):
        subs = [mlp[k] for k in expert_keys]
        stacked = {out_key: _stack_sites([s[in_key] for s in subs])
                   for out_key, in_key in site_map.items() if in_key in subs[0]}
        for k in expert_keys:
            del mlp[k]
        mlp["_stacked_experts"] = stacked
    return params


# -- engine layout: expert concatenation --------------------------------------

def _concat_k_sites(sites: list[dict]) -> dict:
    """Per-expert down_projs concatenated along K (rows).

    Valid because the routing weight folds into each expert's activation
    before the matmul, so one deep-K matmul sums the weighted experts in its
    accumulator. Group-quantized weights only: their scales concatenate along
    the group axis, and each expert's K must hold an even number of groups so
    that the pair packing stays aligned."""
    if any(set(s) - {"w"} for s in sites):
        raise ValueError("K-concat sites must be bare weights (no bias/prescale)")
    leaves = [s["w"] for s in sites]
    if not isinstance(leaves[0], QTensor):
        if any(isinstance(w, QTensor) for w in leaves):
            raise ValueError("experts mix quantized and fp weights")
        return {"w": torch.cat(leaves, dim=0)}
    first = leaves[0]
    if any(not isinstance(qt, QTensor) or qt.meta != first.meta for qt in leaves[1:]):
        raise ValueError("experts must be quantized identically to concat")
    if first.meta.strategy != "group":
        raise ValueError("expert K-concat requires GROUP strategy (channel/tensor scales "
                         "cannot concatenate along K)")
    # Output quantization would apply to the summed accumulator, not to each
    # expert's output; dynamic input quantization would take one range over
    # the concatenated row instead of one per expert.
    if first.meta.output_quant.mode != "none":
        raise ValueError("expert K-concat cannot apply per-expert output quantization to "
                         "the combined accumulator")
    if first.meta.input_quant.mode == "dynamic":
        raise ValueError("expert K-concat would merge per-expert dynamic input "
                         "quantization grids")
    if first.meta.packed:
        gs = first.meta.pack_group
        K_e = first.meta.shape[0]
        if K_e % gs != 0 or (K_e // gs) % 2 != 0:
            raise ValueError(f"expert K={K_e} must be an even multiple of group_size={gs} "
                             "for pair-aligned K-concat")
    for attr in ("input_scale", "input_zero_point"):
        vals = [getattr(w, attr) for w in leaves]
        if any(v is not None for v in vals) and any(
                not torch.allclose(vals[0], v) for v in vals[1:]):
            raise ValueError("per-expert static input scales differ; K-concat would merge "
                             "their quantization grids")

    def cat0(vals):
        return None if vals[0] is None else torch.cat(vals, dim=0)

    K_total = sum(w.meta.shape[0] for w in leaves)
    return {"w": QTensor(
        data=cat0([w.data for w in leaves]), scale=cat0([w.scale for w in leaves]),
        zero_point=cat0([w.zero_point for w in leaves]),
        meta=dataclasses.replace(first.meta, shape=(K_total, first.meta.shape[1])),
        input_scale=first.input_scale, input_zero_point=first.input_zero_point)}


def fuse_moe_experts(params: dict) -> dict:
    """Engine-load transform: each layer's experts as two matmul sites.

    ``gate_up``: the experts' fused [gate|up] blocks concatenated along N
    (they share the input); ``down``: the experts' down_projs concatenated
    along K, the routing weight folded into each expert's activation segment.
    Needs ``fuse_gemma3_projections`` first. A layer whose experts are not in
    that form or do not qualify (a prescale, a bias, quantized unlike each
    other, not group-wise, an odd group count, output or dynamic input
    quantization, differing static input scales) keeps its per-expert
    subtrees, the loop layout. Returns a new tree."""
    params = copy_tree(params)
    for name, mlp, expert_keys in list(_moe_layers(params)):
        subs = [mlp[k] for k in expert_keys]
        if any(set(s) != {"_fused_gate_up", "down_proj"} for s in subs):
            logger.debug("%s: experts not in fused gate_up+down form; keeping the "
                         "per-expert loop layout", name)
            continue
        try:
            gu_sites = [s["_fused_gate_up"] for s in subs]
            if not can_fuse(gu_sites):
                raise ValueError("per-expert gate_up sites not fuse-compatible")
            gu_w = gu_sites[0]["w"]
            if isinstance(gu_w, QTensor) and gu_w.meta.output_quant.mode == "dynamic":
                # One amax per tensor over the concatenation would merge the
                # experts' grids.
                raise ValueError("per-expert dynamic output quantization cannot concat")
            gate_up, _ = fuse_sites(gu_sites)
            down = _concat_k_sites([s["down_proj"] for s in subs])
        except ValueError as exc:
            logger.debug("%s: expert concat not applicable (%s)", name, exc)
            continue
        for k in expert_keys:
            del mlp[k]
        mlp["_fused_experts"] = {"gate_up": {"w": gate_up}, "down": down}
    return params


# ── HF checkpoint import ─────────────────────────────────────────────────────


def load_qwen_moe_hf(model, directory: str, device: torch.device | str = "cuda") -> dict:
    """Param tree from a local HF Qwen-MoE checkpoint directory (Qwen1.5/2-MoE
    names: the ``mlp.gate`` router, ``mlp.experts.{e}.*_proj``, the
    ``mlp.shared_expert`` behind the sigmoid ``mlp.shared_expert_gate``)."""
    cfg = model.cfg

    def mlp_fn(prefix: str, proj) -> dict:
        mlp = {"router": {"w": proj(f"{prefix}.mlp.gate.weight")}}
        for e in range(cfg.num_experts):
            ep = f"{prefix}.mlp.experts.{e}"
            mlp[f"experts.{e}"] = glu_site(proj, f"{ep}.gate_proj.weight",
                                           f"{ep}.up_proj.weight", f"{ep}.down_proj.weight")
        if cfg.shared_expert_size:
            sp = f"{prefix}.mlp.shared_expert"
            mlp["shared"] = glu_site(proj, f"{sp}.gate_proj.weight", f"{sp}.up_proj.weight",
                                     f"{sp}.down_proj.weight")
            mlp["shared_gate"] = {"w": proj(f"{prefix}.mlp.shared_expert_gate.weight")}
        return mlp

    return load_llama_shaped_hf(model, directory, mlp_fn, torch.float32, device)


def load_mixtral_hf(model, directory: str, device: torch.device | str = "cuda") -> dict:
    """Param tree from a local HF Mixtral checkpoint directory (the
    ``block_sparse_moe.gate`` router; experts ``w1`` = gate, ``w3`` = up,
    ``w2`` = down)."""
    cfg = model.cfg

    def mlp_fn(prefix: str, proj) -> dict:
        mlp = {"router": {"w": proj(f"{prefix}.block_sparse_moe.gate.weight")}}
        for e in range(cfg.num_experts):
            ep = f"{prefix}.block_sparse_moe.experts.{e}"
            mlp[f"experts.{e}"] = glu_site(proj, f"{ep}.w1.weight", f"{ep}.w3.weight",
                                           f"{ep}.w2.weight")
        return mlp

    return load_llama_shaped_hf(model, directory, mlp_fn, torch.float32, device)
