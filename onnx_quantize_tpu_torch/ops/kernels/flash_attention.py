"""Blockwise causal attention: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/flash_attention.py``
(``_fa_call`` -> ``_fa_kernel``) with ``csrc/flash_attention.cu``: the
full-sequence attention of a prefill or a perplexity window, with online
softmax, the causal mask and Gemma-3's sliding window from index arithmetic,
and GQA by index, never materializing the (T, S) scores.

What bounds it on the card: operations (~90 GFLOP of attention per
2048-token window of Gemma-3-270M). One block per (64-row T tile, query
head, sequence) loops only over the S tiles that hold live keys; the source
holds the rest of the design. The reference's ``causal=False`` still applies
the causal mask inside every block, so the port's attention is always
causal and takes no such flag.
"""

from __future__ import annotations

import ctypes

import torch

from onnx_quantize_tpu_torch.ops.kernels import check_launch, kernel_library, ptr, stream_ptr

__all__ = ["flash_attention", "flash_attention_reference"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations


def flash_attention_reference(q, k, v, *, sliding_window: int | None = None):
    """The kernel's function in plain PyTorch (einsum and softmax).

    Scores in float32 from q's and k's values; p rounded to v's dtype before
    the PV product while the row sum uses the unrounded p; the output is
    ``acc / max(l, 1e-30)`` in q's dtype. Shapes as :func:`flash_attention`.
    """
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, T, Hkv, Hq // Hkv, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= rows
    if sliding_window is not None:
        mask &= cols > rows - sliding_window
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m <= _NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = acc / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def _check_operands(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q must be (B, T, Hq, D) and k/v (B, S, Hkv, D)")
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read its strides (unit last stride,
    32-bit aligned rows), else a contiguous copy."""
    elems = 4 // t.element_size()
    if (t.stride(3) == 1 and all(s % elems == 0 for s in t.stride()[:3])
            and t.data_ptr() % 4 == 0):
        return t
    return t.contiguous()


def flash_attention(q, k, v, *, sliding_window: int | None = None):
    """Blockwise causal attention. q: (B, T, Hq, D); k/v: (B, S, Hkv, D).

    Positions run from 0 in both (the prefill layout): row t sees keys
    ``s <= t`` and, with ``sliding_window``, ``s > t - sliding_window``.
    q is pre-scaled. Returns (B, T, Hq, D) in q's dtype. Launches the kernel
    on CUDA tensors; CPU tensors get the plain version.
    """
    _check_operands(q, k, v)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention: sliding_window must be None or >= 1, "
                         f"got {sliding_window}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} is not one of {_HEAD_DIMS}")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    if B * T == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = kernel_library().oqt_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(out), int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv, D,
        0 if sliding_window is None else int(sliding_window), strides, stream_ptr(q.device),
    )
    check_launch(err, "oqt_flash_attention")
    global launches
    launches += 1
    return out
