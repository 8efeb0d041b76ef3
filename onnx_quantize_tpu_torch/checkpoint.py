"""Quantized checkpoint save/load.

Counterpart of ``onnx_quantize_tpu/checkpoint.py``, in its format: a
directory with

  * ``params.npz``: every array leaf (packed nibbles, int8 data, scales, zero
    points, float params) under its flattened tree key (``::`` between keys);
  * ``meta.json``: per-leaf structure (QTensor/QBias specs), the model's
    identity and config, and a summary of the quantization plan.

So the JAX package and the port read each other's checkpoints. Two additions,
which the JAX reader ignores:

  * numpy has no bfloat16 (and the card's machine has no ml_dtypes), so a
    bfloat16 array is stored as its uint16 bits and its key is listed under
    ``bfloat16`` in ``meta.json``. (The JAX writer saves such a leaf as raw
    ``|V2`` bytes that its own reader refuses.)
  * a QTensor leaf records ``float_zero_point`` (HQQ's float zero points) and
    ``scale_layout``: "logical" ((n_groups, N) rows) or "baked" (the
    engine's padded (G_pad/2, 2, N) group pairs). Both layouts load and run.

QuaRot's residual-stream rotation (R1) and the weight-space halves of R2/R4
are folded into the params and saved with them. The online transforms (R3 on
q/k, R4 on the down_proj input) are model state, as in the reference: after
:func:`load_checkpoint` the caller stamps them again with
``prepasses.rotate.stamp_online_rotations(model, qk=..., down=..., block=...,
seed=...)``; ``meta.json`` records which ones the saved model carried.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
from typing import Any

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, QTensor, QTensorMeta

logger = logging.getLogger(__name__)

__all__ = ["save_checkpoint", "load_checkpoint", "save_params", "load_params"]

_SEP = "::"
_QT_OPTIONAL = ("input_scale", "input_zero_point", "output_scale", "output_zero_point")


def _store(arrays: dict, bf16: list, key: str, t) -> None:
    t = t.detach().to("cpu").contiguous() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    if t.dtype == torch.bfloat16:
        arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
        bf16.append(key)
    else:
        arrays[key] = t.numpy()


def _flatten(tree: Any, prefix: str, arrays: dict, meta: dict, bf16: list) -> None:
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}{_SEP}", arrays, meta, bf16)
        return
    name = prefix[: -len(_SEP)]
    if isinstance(tree, QTensor):
        m = dataclasses.asdict(tree.meta)
        float_zp = m.pop("float_zero_point")  # the port's own field, kept beside
        meta[name] = {
            "kind": "qtensor", "meta": m,
            "has": {f: getattr(tree, f) is not None for f in _QT_OPTIONAL},
            "float_zero_point": float_zp,
            # Baked scales carry one axis more than the data (stacked too).
            "scale_layout": "baked" if tree.scale.ndim > tree.data.ndim else "logical",
        }
        for f in ("data", "scale", "zero_point", *_QT_OPTIONAL):
            if getattr(tree, f) is not None:
                _store(arrays, bf16, f"{name}{_SEP}{f}", getattr(tree, f))
        return
    if isinstance(tree, QBias):
        meta[name] = {"kind": "qbias", "quant_type": tree.quant_type}
        for f in ("data", "scale", "zero_point"):
            _store(arrays, bf16, f"{name}{_SEP}{f}", getattr(tree, f))
        return
    meta[name] = {"kind": "array"}
    _store(arrays, bf16, name, tree)


def _set_path(tree: dict, path: list[str], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def save_params(path: str, params: dict, extra_meta: dict | None = None) -> None:
    """Write ``params`` (on any device) to ``path/params.npz`` and
    ``path/meta.json``."""
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {}
    bf16: list[str] = []
    _flatten(params, "", arrays, meta, bf16)
    np.savez(os.path.join(path, "params.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"leaves": meta, "extra": extra_meta or {}, "bfloat16": bf16}, f)
    logger.info("Saved checkpoint with %d arrays to %s", len(arrays), path)


def load_params(path: str, device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """Returns (params on ``device``, extra_meta)."""
    with open(os.path.join(path, "meta.json")) as f:
        payload = json.load(f)
    bf16 = set(payload.get("bfloat16", ()))
    npz = np.load(os.path.join(path, "params.npz"))

    def load(key: str) -> torch.Tensor:
        arr = np.array(npz[key])
        if key in bf16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)

    params: dict = {}
    for name, info in payload["leaves"].items():
        keys = name.split(_SEP)
        if info["kind"] == "array":
            _set_path(params, keys, load(name))
        elif info["kind"] == "qbias":
            _set_path(params, keys, QBias(
                data=load(f"{name}{_SEP}data"), scale=load(f"{name}{_SEP}scale"),
                zero_point=load(f"{name}{_SEP}zero_point"), quant_type=info["quant_type"]))
        else:
            m = dict(info["meta"])
            m["input_quant"] = ActQuantSpec(**m["input_quant"])
            m["output_quant"] = ActQuantSpec(**m["output_quant"])
            m["shape"] = tuple(m["shape"])
            zp = load(f"{name}{_SEP}zero_point")
            # A reference checkpoint has no flag: float zero points are HQQ's.
            m["float_zero_point"] = info.get("float_zero_point", zp.is_floating_point())
            _set_path(params, keys, QTensor(
                data=load(f"{name}{_SEP}data"), scale=load(f"{name}{_SEP}scale"),
                zero_point=zp, meta=QTensorMeta(**m),
                **{f: load(f"{name}{_SEP}{f}") if info["has"][f] else None
                   for f in _QT_OPTIONAL}))
    return params, payload.get("extra", {})


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, enum.Enum):
        return obj.value
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)  # torch dtypes and devices


def save_checkpoint(path: str, model, params: dict, plan=None) -> None:
    """Save params, the model's identity and config (and a plan summary)."""
    extra: dict[str, Any] = {"model": type(model).__name__}
    cfg = getattr(model, "cfg", None)
    if cfg is not None and dataclasses.is_dataclass(cfg):
        extra["config"] = dataclasses.asdict(cfg)
    layers = getattr(model, "layers", ())
    extra["online_rotations"] = {
        "qk": any(getattr(layer.attn, "qk_rot", None) is not None for layer in layers),
        "down": any(getattr(layer.mlp, "down_rot", None) is not None for layer in layers)}
    if plan is not None:
        extra["plan"] = {
            entry.name: {"op_type": entry.site.op_type, "group_size": entry.group_size,
                         "qconfig": _jsonable(dataclasses.asdict(entry.qconfig))}
            for entry in plan
        }
    save_params(path, params, extra)


def _config_kwargs(config: dict) -> dict:
    kwargs = dict(config)
    if kwargs.get("rope_scaling") is not None:
        kwargs["rope_scaling"] = tuple(kwargs["rope_scaling"])
    return kwargs


def load_checkpoint(path: str, device: torch.device | str = "cuda"):
    """Reload (model, params on ``device``); the model is rebuilt from the
    saved config (Gemma-3, the Llama conventions or an MoE). Online rotations
    the saved model carried must be stamped again by the caller."""
    params, extra = load_params(path, device)
    if extra.get("model") != "Gemma3":
        raise ValueError(f"Cannot reconstruct model {extra.get('model')!r}; load params via "
                         "load_params() and build the model yourself.")
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

    model = Gemma3(Gemma3Config(**_config_kwargs(extra["config"])))
    online = [k for k, v in extra.get("online_rotations", {}).items() if v]
    if online:
        logger.warning("The saved model carried online rotations (%s): stamp them again with "
                       "stamp_online_rotations before running it.", ", ".join(online))
    return model, params
