"""KV cache, float, int8 or int4, updated in place.

Counterpart of ``onnx_quantize_tpu/engine/kv_cache.py``. Buffers are
``(L, B, S_max, H_kv, D)``; a quantized cache quantizes per (token, head)
with a symmetric abs-max scale on write (``k_scale`` ``(L, B, S_max, H_kv)``)
and attention reads the raw codes with the scales folded in. The int8 cache
holds int8 codes in [-127, 127]. The int4 cache (``bits=4``) holds +-7
codes packed two per byte along head_dim in the HALVES layout: byte ``j``
holds ``d=j`` in its low nibble and ``d=j+D/2`` in its high one, each offset
by 8 (not the weights' group-pair layout). Its buffers are uint8
``(..., D/2)``, and the uint8 dtype is how a reader tells it from int8.

Where the JAX package returns a new cache from every write (and donates the
old one under jit), the port writes the buffers in place. A write takes a
``(B, T)`` mask: masked rows keep their old contents. This stands in for the
JAX scatter's ``mode="drop"``, which torch lacks; an out-of-range index on
CUDA would be a device-side assert, so positions are clamped into range and
the masked rows write back what they read. The narrow admission's
``write_kv_rows`` takes its rows' slots from the host instead, and drops the
padding rows there, before any index is built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["KVCacheConfig", "QuantizedKV", "init_cache", "write_kv", "write_kv_window",
           "write_kv_rows", "admitted_rows", "read_kv", "read_kv_quantized", "pack_nibbles", "unpack_nibbles"]


@dataclasses.dataclass
class QuantizedKV:
    """A layer's int8/int4 K/V cache view, consumed without dequantization.

    ``use_kernel=True`` routes a one-token step to the flash-decode kernel
    (``ops/kernels/flash_decode.py``, int8 only); otherwise the model runs
    the scale-folded attend. Int4 views hold packed uint8 (last dim D/2);
    ``k_ints()``/``v_ints()`` give the int8-valued codes."""

    k: torch.Tensor  # (B, S, H_kv, D) int8, or (B, S, H_kv, D/2) uint8 packed int4
    v: torch.Tensor
    k_scale: torch.Tensor  # (B, S, H_kv) float32
    v_scale: torch.Tensor
    use_kernel: bool = False

    def k_ints(self) -> torch.Tensor:
        return unpack_nibbles(self.k) if self.k.dtype == torch.uint8 else self.k

    def v_ints(self) -> torch.Tensor:
        return unpack_nibbles(self.v) if self.v.dtype == torch.uint8 else self.v


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    batch: int
    max_seq: int
    num_kv_heads: int
    head_dim: int
    quantized: bool = False  # int8/int4 cache
    bits: int = 8  # 8 or 4 (only read when quantized)
    dtype: torch.dtype = torch.float32  # float cache dtype


def init_cache(cfg: KVCacheConfig, device: torch.device | str) -> dict:
    shape = (cfg.num_layers, cfg.batch, cfg.max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.quantized:
        if cfg.bits not in (4, 8):
            raise ValueError(f"KV cache bits must be 4 or 8, got {cfg.bits}")
        if cfg.bits == 4:
            if cfg.head_dim % 2:
                raise ValueError("int4 KV cache needs an even head_dim")
            shape = shape[:-1] + (cfg.head_dim // 2,)
        dt = torch.uint8 if cfg.bits == 4 else torch.int8
        cache = {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
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


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Signed codes in [-8, 7], even last dim D -> uint8 (..., D/2), halves
    layout: byte j = (d=j | d=j+D/2 << 4), offset-8 unsigned nibbles."""
    d = q.shape[-1]
    lo = (q[..., : d // 2].to(torch.int32) + 8).to(torch.uint8)
    hi = (q[..., d // 2:].to(torch.int32) + 8).to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """uint8 (..., D/2) -> int8 codes (..., D) (inverse of pack_nibbles)."""
    lo = (b & 0xF).to(torch.int8) - 8
    hi = (b >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def _quantize_sym4(x: torch.Tensor):
    """Per (token, head) symmetric int4 (+-7 levels), packed along head_dim."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -7, 7)
    return pack_nibbles(q), scale


def _quantize_like(cache: dict, x: torch.Tensor):
    """Quantize fresh rows in the cache's own format (int8 or packed int4)."""
    return _quantize_sym4(x) if cache["k"].dtype == torch.uint8 else _quantize_sym(x)


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
        kq, ks = _quantize_like(cache, k)
        vq, vs = _quantize_like(cache, v)
        for key, rows in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _masked_write(cache[key], layer, rows, positions, mask)
    else:
        _masked_write(cache["k"], layer, k, positions, mask)
        _masked_write(cache["v"], layer, v, positions, mask)


def write_kv_window(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
                    start: torch.Tensor, ok: torch.Tensor) -> None:
    """Write K/V rows (B, T, H_kv, D) of ``layer`` into per-row contiguous
    windows at offsets ``start`` (B,), in place (the speculative verify's
    write).

    Rows with ``ok`` (B,) False, and rows whose window would run past S,
    keep their old window: the window's start is clamped to S - T and the
    row writes back what it read there, as the reference blends the old
    window back at the clamped start. Float, int8 and int4 caches quantize
    and pack as :func:`write_kv` does. The (B, T) indices are built on the
    device, so nothing waits on the host."""
    B, T = k.shape[:2]
    S = cache["k"].shape[2]
    if T > S:
        raise ValueError(f"a window of {T} rows does not fit a cache of {S}")
    ok = ok & (start + T <= S)
    positions = (start.clamp(0, S - T)[:, None]
                 + torch.arange(T, dtype=start.dtype, device=start.device)[None, :])
    write_kv(cache, layer, k, v, positions, ok[:, None].expand(B, T))


def admitted_rows(slots, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, slots) int64 index tensors on ``device`` for a narrow
    admission: ``slots`` (A,) is a host array of batch slots, in which the
    bucket's padding rows carry ``batch``. The padding rows are dropped here,
    on the host: the JAX scatter drops them as out of range (mode="drop"),
    which a torch index would raise on, or assert on a card."""
    slots = np.asarray(slots)
    rows = np.flatnonzero((slots >= 0) & (slots < batch))

    def as_index(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    return as_index(rows), as_index(slots[rows])


def write_kv_rows(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor):
    """Write rows ``rows`` (n,) of A new rows' K/V (A, T, H_kv, D), at their
    ``positions`` (A, T), into batch slots ``slots`` (n,) of ``layer``, in
    place (see :func:`admitted_rows`). Returns the fresh rows, all A of them:
    a :class:`QuantizedKV` of the just-quantized codes and scales, or the
    float (k, v). The admission's attention reads these and nothing of the
    wide cache, over the same int8/int4 values the cache now holds."""
    pos = positions[rows].long()
    dst = slots[:, None].expand_as(pos)
    if "k_scale" in cache:
        kq, ks = _quantize_like(cache, k)
        vq, vs = _quantize_like(cache, v)
        for key, fresh in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            cache[key][layer].index_put_((dst, pos), fresh[rows].to(cache[key].dtype))
        return QuantizedKV(k=kq, v=vq, k_scale=ks, v_scale=vs)
    for key, fresh in (("k", k), ("v", v)):
        cache[key][layer].index_put_((dst, pos), fresh[rows].to(cache[key].dtype))
    return k, v


def read_kv_quantized(cache: dict, layer: int, use_kernel: bool = False) -> QuantizedKV:
    """The layer's raw int8/int4 K/V and scales (views, no copy)."""
    return QuantizedKV(k=cache["k"][layer], v=cache["v"][layer],
                       k_scale=cache["k_scale"][layer], v_scale=cache["v_scale"][layer],
                       use_kernel=use_kernel)


def read_kv(cache: dict, layer: int, dtype: torch.dtype = torch.float32):
    """The layer's float (B, S_max, H, D) K/V."""
    return cache["k"][layer].to(dtype), cache["v"][layer].to(dtype)
