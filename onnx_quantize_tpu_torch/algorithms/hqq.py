"""HQQ: half-quadratic zero-point optimisation (weight-only uint4 groups).

Counterpart of ``onnx_quantize_tpu/algorithms/hqq.py`` on torch tensors on
the weight's device: RTN group qparams, then alternating proximal updates of
the zero point (shrink operator ``sign(x)·relu(|x| − β⁻¹·(|x|+1e-8)^(p−1))``,
zero-point update ``mean(Wq − (W − We)·s⁻¹)``, ``β ← β·κ`` each iteration)
keeping the zero point of least mean |W − Wr|, and an early stop once the
error stops improving. The zero point stays in float32 and the codes are
``clip(round(x / s + zp))``, rounded before the clip.

Every iteration runs (a fixed count, as the JAX package's ``fori_loop``):
once the error stops improving, a ``stopped`` flag on the device freezes the
state, which gives the result of the reference's ``break`` with no host
sync. The β·κ^i schedule is computed in float64 on the host, as in the JAX
package. The power in the shrink operator and the means are taken in
float64 and rounded to float32, so the card's result equals the CPU's.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import (
    compute_qparams_from_array,
    postprocess_array,
    pow_f32,
    preprocess_array,
    sum_f64,
    true_div,
)

__all__ = ["hqq_quantize", "quantize_weights"]


def quantize_weights(config, weight: torch.Tensor, qconfig, entry=None):
    """HQQ of one site's weight (``HqqConfig``'s entry)."""
    w = qconfig.weights
    group_size = entry.group_size if entry is not None else w.group_size
    return hqq_quantize(
        weight, quant_type=w.dtype, group_size=group_size if group_size is not None else -1,
        reduce_range=w.reduce_range, clip_ratio=w.clip_ratio, mse=w.mse,
        lp_norm=config.lp_norm, beta=config.beta, kappa=config.kappa, iters=config.iters,
        early_stop=config.early_stop)


def _shrink_op(x: torch.Tensor, inv_beta: torch.Tensor, lp_norm: float) -> torch.Tensor:
    """``sign(x)·relu(|x| − β⁻¹·(|x|+1e-8)^(p−1))`` (HQQ paper eq. 5)."""
    ax = x.abs()
    return torch.sign(x) * torch.clamp(ax - inv_beta * pow_f32(ax + 1e-8, lp_norm - 1), min=0.0)


def _optimize_zero_point(w_f, scale, zero_point, quant_type: QuantType, reduce_range: bool,
                         lp_norm: float, beta: float, kappa: float, iters: int,
                         early_stop: bool) -> torch.Tensor:
    """The best zero point (rows, 1) of the alternating prox loop."""
    qmin, qmax = quant_type.qrange(is_symmetric=False, reduce_range=reduce_range)
    inv_betas = torch.tensor([1.0 / (beta * kappa**i) for i in range(max(iters, 1))],
                             dtype=torch.float32, device=w_f.device)
    inv_scale = torch.ones_like(scale) / scale  # HQQ works with the inverted scale
    zp = best_zp = zero_point
    best_err = torch.tensor(float("inf"), dtype=torch.float64, device=w_f.device)
    stopped = torch.zeros((), dtype=torch.bool, device=w_f.device)
    for i in range(iters):
        w_q = torch.clamp(torch.round(w_f * inv_scale + zp), qmin, qmax)
        w_r = (w_q - zp) / inv_scale
        w_e = _shrink_op(w_f - w_r, inv_betas[i], lp_norm)
        err = true_div(sum_f64((w_f - w_r).abs()), w_f.numel())
        improved = err < best_err
        take = improved & ~stopped
        best_err = torch.where(take, err, best_err)
        best_zp = torch.where(take, zp, best_zp)
        if early_stop:
            stopped = stopped | ~improved
        zp_next = true_div(sum_f64(w_q - (w_f - w_e) * inv_scale, dim=1, keepdim=True),
                           w_f.shape[1]).to(torch.float32)
        zp = torch.where(stopped, zp, zp_next)
    return best_zp


def hqq_quantize(
    w_f: torch.Tensor,
    quant_type: QuantType,
    group_size: int,
    reduce_range: bool = False,
    clip_ratio: float = 1.0,
    mse: bool = False,
    lp_norm: float = 0.7,
    beta: float = 1e1,
    kappa: float = 1.01,
    iters: int = 20,
    early_stop: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HQQ-quantize a ``(in_features, out_features)`` weight; the zero point
    is float32, in the group layout ``(out * n_groups, 1)`` as the scale."""
    w_f = w_f.to(torch.float32)
    pre = preprocess_array(w_f, QuantizationStrategy.GROUP, group_size)
    scale, zero_point = compute_qparams_from_array(
        pre, quant_type, QuantizationStrategy.GROUP, group_size, is_symmetric=False,
        reduce_range=reduce_range, clip_ratio=clip_ratio, mse=mse, zp_dtype=torch.float32)
    zero_point = _optimize_zero_point(pre, scale, zero_point, quant_type, reduce_range,
                                      lp_norm, beta, kappa, iters, early_stop)
    qmin, qmax = quant_type.qrange(is_symmetric=False, reduce_range=reduce_range)
    w_q = torch.clamp(torch.round(pre / scale + zero_point), qmin, qmax)
    w_q = postprocess_array(w_q.to(quant_type.container_dtype), w_f.shape,
                            QuantizationStrategy.GROUP, group_size)
    return w_q.contiguous(), scale, zero_point
