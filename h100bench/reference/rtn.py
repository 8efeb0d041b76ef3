"""Round-to-nearest weight quantization, dequantized, in plain torch.

A frozen copy of the arithmetic of the port's ``core/numerics.py``
(``compute_min_max``, ``compute_qparams``, ``quantize_from_qparams``) for
the two recipes the configurations state: asymmetric unsigned 4-bit codes
per group of ``group_size`` input rows, and symmetric int8 per output
channel. Weights are (in, out); the result is the dequantized float32
weight (q - zp) * scale in the same layout.
"""

from __future__ import annotations

import torch

__all__ = ["dequant_uint4_group", "dequant_int8_channel"]

_TINY = torch.finfo(torch.float32).tiny


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # One IEEE division by a device scalar (not a multiply by a reciprocal).
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def dequant_uint4_group(w: torch.Tensor, group_size: int) -> torch.Tensor:
    k, n = w.shape
    rows = w.to(torch.float32).T.reshape(-1, group_size)  # group g of column j: row j*G + g
    rmin = torch.clamp(rows.amin(dim=1, keepdim=True), max=0.0)
    rmax = torch.clamp(rows.amax(dim=1, keepdim=True), min=0.0)
    scale = _div(rmax - rmin, 15.0)
    scale = torch.where(scale < _TINY, torch.ones_like(scale), scale)
    zp = torch.round(torch.clamp(0.0 - rmin / scale, 0, 15))
    q = torch.clamp(torch.round(rows / scale) + zp, 0, 15)
    return ((q - zp) * scale).reshape(n, k).T.contiguous()


def dequant_int8_channel(w: torch.Tensor) -> torch.Tensor:
    w32 = w.to(torch.float32)
    rabs = torch.maximum(w32.amin(dim=0).clamp(max=0.0).abs(), w32.amax(dim=0).clamp(min=0.0))
    scale = _div(rabs, 127.0)
    scale = torch.where(scale < _TINY, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q * scale
