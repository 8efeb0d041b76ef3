"""Hugging Face -> framework weight import for Gemma-3, and the safetensors reader.

Counterpart of ``onnx_quantize_tpu/models/import_hf.py``: maps
``Gemma3ForCausalLM`` safetensors names onto the framework param tree
(projection weights transpose from HF's ``(out, in)`` to the ``(in, out)``
MatMul layout; RMSNorm gains keep the ``(1 + w)`` convention). Reads a local
directory; no network access.

:func:`read_safetensors` is the port's own reader of the format (an 8-byte
little-endian header length, a JSON header of ``dtype``, ``shape`` and
``data_offsets`` relative to the end of the header, then the raw bytes), with
no dependency on the ``safetensors`` package. Each file is read once into a
writable buffer and every tensor is a view of it, in its stored dtype: BF16,
the dtype of the published Gemma-3 and Llama checkpoints, loads as
``torch.bfloat16`` (numpy has no bfloat16, so a numpy-based reader cannot hold
such a file). A tensor whose offset is not a multiple of its element size is
copied out of the buffer, since a view needs the alignment.

The missing-site warning looks each site up by its param path; the
reference's check tested the path's first component (``layers``), which is
never a key of the tree, so it warned for every decoder site.
"""

from __future__ import annotations

import json
import logging
import os
import struct

import torch

logger = logging.getLogger(__name__)

__all__ = ["read_safetensors", "load_gemma3_hf", "hf_getter", "glu_site", "load_llama_shaped_hf"]

_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "BOOL": torch.bool,
}


def _read_file(path: str) -> dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    (header_len,) = struct.unpack("<Q", bytes(buf[:8]))
    header = json.loads(bytes(buf[8:8 + header_len]))
    base = 8 + header_len
    raw = torch.frombuffer(buf, dtype=torch.uint8)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        chunk = raw[base + start:base + end]
        if (base + start) % dtype.itemsize:
            chunk = chunk.clone()
        out[name] = chunk.view(dtype).reshape(info["shape"])
    return out


def read_safetensors(directory: str) -> dict[str, torch.Tensor]:
    """Every ``*.safetensors`` shard of a directory, in sorted order, merged
    into one dict of CPU tensors."""
    tensors: dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".safetensors"):
            tensors.update(_read_file(os.path.join(directory, fname)))
    if not tensors:
        raise FileNotFoundError(f"No .safetensors files found in {directory}")
    return tensors


def hf_getter(hf: dict[str, torch.Tensor], dtype: torch.dtype, device):
    """``(get, proj)`` over a checkpoint dict: ``get(name)`` finds a tensor
    under its name, with or without the ``model.`` prefix, as ``dtype`` on
    ``device``; ``proj(name)`` is a projection transposed to ``(in, out)``."""

    def get(name: str) -> torch.Tensor:
        for candidate in (name, f"model.{name}", name.replace("model.", "")):
            if candidate in hf:
                return hf[candidate].to(device=device, dtype=dtype)
        raise KeyError(f"HF tensor {name!r} not found; have e.g. {list(hf)[:5]}")

    def proj(name: str) -> torch.Tensor:
        return get(name).t().contiguous()  # (out, in) -> (in, out)

    return get, proj


def _attach_lm_head(params: dict, proj, carried: bool) -> None:
    """The checkpoint's own lm_head when it ``carried`` one, else a transposed
    view of the embedding (tied)."""
    if carried:
        params["lm_head"] = {"w": proj("lm_head.weight")}
    else:
        params["lm_head"] = {"w": params["embed"]["w"].T}
        logger.info("lm_head tied to embedding (no separate HF tensor)")


def glu_site(proj, gate: str, up: str, down: str) -> dict:
    """A gated MLP's three projections from their HF names."""
    return {"gate_proj": {"w": proj(gate)}, "up_proj": {"w": proj(up)},
            "down_proj": {"w": proj(down)}}


def load_llama_shaped_hf(model, directory: str, mlp_fn, dtype: torch.dtype,
                         device: torch.device | str) -> dict:
    """The param tree of a Llama-shaped HF checkpoint (Llama, Qwen-2 and the
    MoE families): embeddings, q/k/v (with Qwen-2's biases when the config
    has ``attn_bias``) and o, the two pre-norms, the final norm and the
    head, as ``dtype`` on ``device``; ``mlp_fn(prefix, proj)`` builds one
    layer's MLP tree from its ``model.layers.{i}`` prefix."""
    hf = read_safetensors(directory)
    get, proj = hf_getter(hf, dtype, device)
    cfg = model.cfg

    def site(name: str, bias: bool) -> dict:
        entry = {"w": proj(f"{name}.weight")}
        if bias:
            entry["b"] = get(f"{name}.bias")
        return entry

    params: dict = {
        "embed": {"w": get("model.embed_tokens.weight")},
        "final_norm": {"w": get("model.norm.weight")},
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        params[f"layers.{i}"] = {
            "attn": {
                "q_proj": site(f"{p}.self_attn.q_proj", cfg.attn_bias),
                "k_proj": site(f"{p}.self_attn.k_proj", cfg.attn_bias),
                "v_proj": site(f"{p}.self_attn.v_proj", cfg.attn_bias),
                "o_proj": {"w": proj(f"{p}.self_attn.o_proj.weight")},
            },
            "mlp": mlp_fn(p, proj),
            "input_norm": {"w": get(f"{p}.input_layernorm.weight")},
            "pre_ffn_norm": {"w": get(f"{p}.post_attention_layernorm.weight")},
        }
    _attach_lm_head(params, proj, any(k.startswith("lm_head") for k in hf))
    return params


def _has_path(params: dict, path: tuple[str, ...]) -> bool:
    for key in path:
        if not isinstance(params, dict) or key not in params:
            return False
        params = params[key]
    return True


def load_gemma3_hf(model, directory: str, dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> dict:
    """The framework param tree from a local HF Gemma-3 checkpoint directory,
    as ``dtype`` on ``device``. The lm_head is tied to the embedding (a
    transposed view of it) unless the checkpoint carries its own."""
    hf = read_safetensors(directory)
    get, proj = hf_getter(hf, dtype, device)

    def norm(name: str) -> dict:
        return {"w": get(name)}

    params: dict = {
        "embed": {"w": get("model.embed_tokens.weight")},
        "final_norm": norm("model.norm.weight"),
    }
    for i in range(model.cfg.num_layers):
        p = f"model.layers.{i}"
        params[f"layers.{i}"] = {
            "attn": {
                "q_proj": {"w": proj(f"{p}.self_attn.q_proj.weight")},
                "k_proj": {"w": proj(f"{p}.self_attn.k_proj.weight")},
                "v_proj": {"w": proj(f"{p}.self_attn.v_proj.weight")},
                "o_proj": {"w": proj(f"{p}.self_attn.o_proj.weight")},
                "q_norm": norm(f"{p}.self_attn.q_norm.weight"),
                "k_norm": norm(f"{p}.self_attn.k_norm.weight"),
            },
            "mlp": {
                "gate_proj": {"w": proj(f"{p}.mlp.gate_proj.weight")},
                "up_proj": {"w": proj(f"{p}.mlp.up_proj.weight")},
                "down_proj": {"w": proj(f"{p}.mlp.down_proj.weight")},
            },
            "input_norm": norm(f"{p}.input_layernorm.weight"),
            "post_attn_norm": norm(f"{p}.post_attention_layernorm.weight"),
            "pre_ffn_norm": norm(f"{p}.pre_feedforward_layernorm.weight"),
            "post_ffn_norm": norm(f"{p}.post_feedforward_layernorm.weight"),
        }

    _attach_lm_head(params, proj, any("lm_head" in k for k in hf))

    missing = [s.name for s in model.linear_sites() if not _has_path(params, s.param_path)]
    if missing:
        logger.warning("Sites without imported weights: %s", missing)
    return params
