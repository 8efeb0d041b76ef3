"""Qparam math core on torch tensors (CPU or CUDA alike).

Counterpart of ``onnx_quantize_tpu/core/numerics.py`` with the same numeric
rules, so codes, scales and zero points come out bit-equal:

  * layout preprocessing: CHANNEL -> transpose, GROUP -> ``(in, out)`` ->
    ``(out * n_groups, group_size)`` reshape,
  * min/max with clip_ratio applied *before* the force-zero-in-range clamp,
  * quantize = ``clip(round(x / s) + zp, qmin, qmax)`` with round-half-even,
  * asymmetric scale/zp: ``s = (rmax - rmin) / (qmax - qmin)``, degenerate
    s -> 1, ``zp = round(clip(qmin - rmin / s, qmin, qmax))`` (clip before
    round),
  * symmetric: mid-range zero point and ``min(pos, neg)`` usable levels, so
    unsigned symmetric works (zp = 128 for uint8),
  * MSE range search: shrink grid ``p = 1 - i/grid`` for ``maxshrink*grid``
    steps, Lp-norm error (norm 2.4), early stop once ``patience``
    non-improving steps have been counted (cumulatively, as the reference).

Everything runs in float32 on the array's device, with no host sync. Two
rules keep a CUDA result equal to the CPU one: a division by a constant
divides by a device tensor (CUDA turns ``tensor / python_number`` into a
multiply by the reciprocal, a last-bit change), and a reduction whose
order the device picks sums in float64 (``sum_f64``).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy

__all__ = [
    "preprocess_array",
    "postprocess_array",
    "compute_min_max",
    "compute_qparams",
    "quantize_from_qparams",
    "dequantize",
    "fake_quantize",
    "compute_min_max_mse",
    "compute_qparams_from_array",
    "true_div",
    "sum_f64",
    "pow_f32",
]

_F32_TINY = torch.finfo(torch.float32).tiny
_F32_MAX = torch.finfo(torch.float32).max


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as one IEEE division on every device (``b`` as a
    device scalar, not a Python number)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def pow_f32(a: torch.Tensor, exponent: float) -> torch.Tensor:
    """``a ** exponent`` for a float32 tensor: the exponent rounded to float32
    (as numpy and JAX read a Python float in a float32 expression), the power
    taken in float64 and rounded to float32, so every device's math library
    gives the same float32 result."""
    e = float(torch.tensor(exponent, dtype=torch.float32))
    return a.to(torch.float64).pow(e).to(torch.float32)


def sum_f64(a: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Sum in float64, so the float32 terms' order on the device moves the
    result only below float64's last bits."""
    a = a.to(torch.float64)
    return a.sum() if dim is None else a.sum(dim=dim, keepdim=keepdim)


def _resolved_group_size(in_channels: int, group_size: int | None) -> int:
    if group_size == -1 or group_size is None:
        return in_channels
    return min(group_size, in_channels)


def preprocess_array(array: torch.Tensor, strategy: QuantizationStrategy,
                     group_size: int = -1) -> torch.Tensor:
    """Reshape a weight ``(in, out)`` into rows sharing one scale/zp.

    TENSOR: unchanged. CHANNEL: ``(out, in)``. GROUP: ``(out * n_groups,
    group_size)``, row-major over the transposed weight, so group ``g`` of
    out-channel ``j`` is row ``j * n_groups + g``.
    """
    if strategy == QuantizationStrategy.TENSOR:
        return array
    if strategy == QuantizationStrategy.CHANNEL:
        return array.T
    if strategy == QuantizationStrategy.GROUP:
        gs = _resolved_group_size(array.shape[0], group_size)
        return array.T.reshape(-1, gs)
    raise ValueError(f"Unknown strategy {strategy}")


def postprocess_array(preprocessed: torch.Tensor, original_shape, strategy,
                      group_size: int = -1) -> torch.Tensor:
    """Inverse of :func:`preprocess_array` back to ``original_shape``."""
    if strategy == QuantizationStrategy.TENSOR:
        return preprocessed
    if strategy == QuantizationStrategy.CHANNEL:
        return preprocessed.T
    if strategy == QuantizationStrategy.GROUP:
        in_ch, out_ch = original_shape
        return preprocessed.reshape(out_ch, in_ch).T
    raise ValueError(f"Unknown strategy {strategy}")


def compute_min_max(array: torch.Tensor, strategy, group_size: int = -1,
                    clip_ratio: float = 1.0):
    """Per-row (or global) min/max with clip ratio and zero-in-range clamp."""
    if strategy == QuantizationStrategy.TENSOR:
        min_val, max_val = array.min(), array.max()
    else:
        min_val = array.amin(dim=1, keepdim=True)
        max_val = array.amax(dim=1, keepdim=True)
    min_val = min_val * clip_ratio
    max_val = max_val * clip_ratio
    # Include zero in the range so the zero point is exactly representable.
    return torch.clamp(min_val, max=0.0), torch.clamp(max_val, min=0.0)


def quantize_from_qparams(array: torch.Tensor, scale, zero_point,
                          quant_type: QuantType, is_symmetric: bool,
                          reduce_range: bool) -> torch.Tensor:
    """``clip(round(x / s) + zp, qmin, qmax)`` in the quantized container dtype."""
    array = array.to(torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=array.device)
    zero_point = torch.as_tensor(zero_point, device=array.device)
    shifted = torch.round(array / scale).to(torch.int64) + zero_point.to(torch.int64)
    qmin, qmax = quant_type.qrange(is_symmetric, reduce_range)
    return torch.clamp(shifted, qmin, qmax).to(quant_type.container_dtype)


def dequantize(q_array: torch.Tensor, scale, zero_point, *, preprocess: bool = False,
               strategy: QuantizationStrategy | None = None,
               group_size: int = -1) -> torch.Tensor:
    """``(q - zp) * s`` with optional layout preprocessing."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q_array.device)
    zero_point = torch.as_tensor(zero_point, device=q_array.device)
    pre = q_array
    if preprocess:
        if strategy is None:
            raise ValueError("strategy must be provided if preprocess is True")
        pre = preprocess_array(q_array, strategy, group_size)
        if strategy == QuantizationStrategy.CHANNEL:
            scale = scale.unsqueeze(1)
            zero_point = zero_point.unsqueeze(1)
    dq = (pre.to(torch.float32) - zero_point.to(torch.float32)) * scale
    if preprocess:
        dq = postprocess_array(dq, q_array.shape, strategy, group_size)
    return dq


def compute_qparams(rmin, rmax, quant_type: QuantType, is_symmetric: bool,
                    reduce_range: bool, zp_dtype: torch.dtype | None = None):
    """Scale (float32) and zero point from a range, by the reference's rules."""
    rmin = torch.as_tensor(rmin, dtype=torch.float32)
    rmax = torch.as_tensor(rmax, dtype=torch.float32, device=rmin.device)
    if zp_dtype is None:
        zp_dtype = quant_type.container_dtype

    if is_symmetric:
        rabs = torch.maximum(rmin.abs(), rmax.abs())
        qmin, qmax = quant_type.qrange(is_symmetric=True, reduce_range=reduce_range)
        zero = round((qmax + qmin) / 2.0)
        # The two sides of the fixed zero point may have different level counts
        # (uint8 symmetric: zp=128, 127 positive vs 128 negative levels); use the
        # smaller side so quantization cannot overflow.
        max_levels = min(qmax - zero, zero - qmin)
        scale = true_div(rabs, max_levels)
        scale = torch.where(scale < _F32_TINY, torch.ones_like(scale), scale)
        zp = torch.full(rabs.shape, zero, dtype=zp_dtype, device=rabs.device)
        return scale, zp

    qmin, qmax = quant_type.qrange(is_symmetric=False, reduce_range=reduce_range)
    scale = true_div(rmax - rmin, qmax - qmin)
    scale = torch.where(scale < _F32_TINY, torch.ones_like(scale), scale)
    zp = qmin - rmin / scale
    zp = torch.round(torch.clamp(zp, qmin, qmax))
    return scale, zp.to(zp_dtype)


def fake_quantize(array: torch.Tensor, scale, zero_point, quant_type: QuantType,
                  is_symmetric: bool, reduce_range: bool) -> torch.Tensor:
    """Quantize then dequantize (float32)."""
    q = quantize_from_qparams(array, scale, zero_point, quant_type, is_symmetric, reduce_range)
    return dequantize(q, scale, zero_point)


def compute_min_max_mse(array: torch.Tensor, quant_type: QuantType, strategy,
                        group_size: int, is_symmetric: bool, reduce_range: bool,
                        maxshrink: float = 0.20, patience: int = 5, grid: float = 100.0,
                        norm: float = 2.4):
    """MSE-optimal range per row (or for the tensor) over a shrink grid.

    Candidate ``i`` scales the min/max range by ``float32(1 - i/grid)`` and
    scores the fake-quantized rows by ``sum |q - x|^norm``; a row keeps the
    first strictly better candidate. The reference stops the search once
    ``patience`` candidates improved no row, counting them cumulatively;
    here every candidate runs and a counter on the device masks the updates
    after that point, which gives the same result with no host sync. The
    error sums in float64, so its order on the device does not decide ties.
    """
    array = array.to(torch.float32)
    rmin, rmax = compute_min_max(array, strategy, group_size, clip_ratio=1.0)
    dim = None if strategy == QuantizationStrategy.TENSOR else 1
    best_err = torch.full(rmin.shape, _F32_MAX, dtype=torch.float64, device=array.device)
    best_min, best_max = rmin.clone(), rmax.clone()
    no_improve = torch.zeros((), dtype=torch.int32, device=array.device)
    for i in range(int(maxshrink * grid)):
        p = torch.tensor(1.0 - i / grid, dtype=torch.float32, device=array.device)
        shrunk_min, shrunk_max = p * rmin, p * rmax
        scale, zp = compute_qparams(shrunk_min, shrunk_max, quant_type, is_symmetric,
                                    reduce_range, zp_dtype=torch.float32)
        q = fake_quantize(array, scale, zp, quant_type, is_symmetric, reduce_range)
        norm32 = float(torch.tensor(norm, dtype=torch.float32))
        err = sum_f64((q - array).abs().to(torch.float64).pow(norm32), dim=dim,
                      keepdim=dim is not None)
        improved = err < best_err
        active = no_improve < patience
        take = improved & active
        best_err = torch.where(take, err, best_err)
        best_min = torch.where(take, shrunk_min, best_min)
        best_max = torch.where(take, shrunk_max, best_max)
        no_improve = no_improve + (active & ~improved.any()).to(torch.int32)
    return best_min, best_max


def compute_qparams_from_array(array: torch.Tensor, quant_type: QuantType, strategy,
                               group_size: int, is_symmetric: bool, reduce_range: bool,
                               clip_ratio: float = 1.0, mse: bool = False,
                               zp_dtype: torch.dtype | None = None):
    """Qparams straight from a (layout-preprocessed) tensor; ``mse`` replaces
    the clipped min/max by the shrink-grid search (and ignores clip_ratio)."""
    if mse:
        rmin, rmax = compute_min_max_mse(array, quant_type, strategy, group_size,
                                         is_symmetric, reduce_range)
    else:
        rmin, rmax = compute_min_max(array, strategy, group_size, clip_ratio)
    return compute_qparams(rmin, rmax, quant_type, is_symmetric, reduce_range, zp_dtype)
