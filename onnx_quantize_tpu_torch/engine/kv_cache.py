"""KV cache, float or int8, updated in place.

Counterpart of ``onnx_quantize_tpu/engine/kv_cache.py`` (int8 and float
caches; the int4 cache is not ported yet, ROADMAP.md Queue A item 7). Buffers
are ``(L, B, S_max, H_kv, D)``; the int8 cache quantizes per (token, head)
with a symmetric abs-max scale on write (``k_scale`` ``(L, B, S_max, H_kv)``)
and attention reads the raw codes with the scales folded in.

Where the JAX package returns a new cache from every write (and donates the
old one under jit), the port writes the buffers in place. A write takes a
``(B, T)`` mask: masked rows keep their old contents. This stands in for the
JAX scatter's ``mode="drop"``, which torch lacks; an out-of-range index on
CUDA would be a device-side assert, so positions are clamped into range and
the masked rows write back what they read.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["KVCacheConfig", "QuantizedKV", "init_cache", "write_kv", "read_kv",
           "read_kv_quantized"]


@dataclasses.dataclass
class QuantizedKV:
    """A layer's int8 K/V cache view, consumed without dequantization."""

    k: torch.Tensor  # (B, S, H_kv, D) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (B, S, H_kv) float32
    v_scale: torch.Tensor


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    batch: int
    max_seq: int
    num_kv_heads: int
    head_dim: int
    quantized: bool = False  # int8 cache
    dtype: torch.dtype = torch.float32  # float cache dtype


def init_cache(cfg: KVCacheConfig, device: torch.device | str) -> dict:
    shape = (cfg.num_layers, cfg.batch, cfg.max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.quantized:
        cache = {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    else:
        cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    cache["lengths"] = torch.zeros((cfg.batch,), dtype=torch.int32, device=device)
    return cache


def _quantize_sym(x: torch.Tensor):
    """Per (token, head) symmetric int8: scale = absmax / 127.

    Runs in float32 whatever the activation dtype: a bf16 division and round
    would add quantization error."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _masked_write(buf: torch.Tensor, layer: int, rows: torch.Tensor,
                  positions: torch.Tensor, mask: torch.Tensor) -> None:
    """``buf[layer, b, positions[b, t]] = rows[b, t]`` where ``mask[b, t]``.

    Masked-out entries write back their own old value at the clamped
    position. Positions within a row must be distinct where the mask is set
    (a prefill's arange, or one decode position per row)."""
    B, T = positions.shape
    pos = positions.clamp(0, buf.shape[2] - 1).long()
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    view = buf[layer]
    old = view[bidx, pos]
    keep = mask.reshape(B, T, *([1] * (rows.ndim - 2)))
    view[bidx, pos] = torch.where(keep, rows.to(buf.dtype), old)


def write_kv(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
             positions: torch.Tensor, mask: torch.Tensor) -> None:
    """Write new K/V rows (B, T, H_kv, D) at ``positions`` (B, T) of ``layer``,
    in place, for the (b, t) entries where ``mask`` (B, T) is set."""
    if "k_scale" in cache:
        kq, ks = _quantize_sym(k)
        vq, vs = _quantize_sym(v)
        for key, rows in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _masked_write(cache[key], layer, rows, positions, mask)
    else:
        _masked_write(cache["k"], layer, k, positions, mask)
        _masked_write(cache["v"], layer, v, positions, mask)


def read_kv_quantized(cache: dict, layer: int) -> QuantizedKV:
    """The layer's raw int8 K/V and scales (views, no copy)."""
    return QuantizedKV(k=cache["k"][layer], v=cache["v"][layer],
                       k_scale=cache["k_scale"][layer], v_scale=cache["v_scale"][layer])


def read_kv(cache: dict, layer: int, dtype: torch.dtype = torch.float32):
    """The layer's float (B, S_max, H, D) K/V."""
    return cache["k"][layer].to(dtype), cache["v"][layer].to(dtype)
