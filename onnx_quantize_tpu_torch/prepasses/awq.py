"""AWQ: activation-aware weight scale search, and an optional clip search.

Counterpart of ``onnx_quantize_tpu/prepasses/awq.py``, on the weight's
device: the activation salience is the per-channel mean |x| over the
captured inputs, the weight salience the per-input-channel mean of |W|
normalised by its row (or group, or tensor) maximum; a 20-point grid over
the ratio r tries ``s = clip(act^r / w^(1-r), 1e-4)`` normalised by
``sqrt(max(s)·min(s))``, each scored by the mean squared error of
``X @ (dequant(rtn(W·s)) / s)`` against ``X @ W``; the first candidate of
least error wins. Its scale is fused into the weight (kept float32) and its
reciprocal into the input ``prescale``, and the captured inputs are divided
by it. The clip search then scores clip ratios ``1 - i/100`` (i < 10) of
the rescaled weight and writes the winner into the site's own stamped
qconfig.

The candidates' losses stay on the device and the winner is their
``argmin`` (the first of equal minima, as the reference's strict ``<``);
only the clip search reads its winner back, once per site. Powers and means
are taken in float64 and rounded to float32, so the card's candidate scales
equal the CPU's; the losses' matmuls follow the device's summation order.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from onnx_quantize_tpu_torch.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import dequantize, pow_f32, sum_f64, true_div
from onnx_quantize_tpu_torch.plan import PlanEntry, QuantPlan
from onnx_quantize_tpu_torch.prepasses.smooth_quant import fold_prescale
from onnx_quantize_tpu_torch.utils import tree_get

logger = logging.getLogger(__name__)

__all__ = ["AwqPass"]

N_GRID = 20
N_CLIP = 10


def _mean_f32(a: torch.Tensor, dim: int) -> torch.Tensor:
    return true_div(sum_f64(a, dim=dim), a.shape[dim]).to(torch.float32)


def _fake_quant_weight(weights: torch.Tensor, qweight_args, clip_ratio: float) -> torch.Tensor:
    """RTN round trip of a weight in the site's weight config (the config's
    own group size, as the reference)."""
    gs = qweight_args.group_size if qweight_args.group_size else -1
    q, s, zp = rtn_quantize(weights, qweight_args.dtype, qweight_args.strategy, gs,
                            qweight_args.symmetric, qweight_args.reduce_range,
                            clip_ratio=clip_ratio, zp_dtype=qweight_args.zp_dtype)
    return dequantize(q, s, zp, preprocess=True, strategy=qweight_args.strategy, group_size=gs)


def _mse(original: torch.Tensor, inputs: torch.Tensor, qweights: torch.Tensor) -> torch.Tensor:
    """Mean squared error of ``inputs @ qweights`` against ``original`` (float64)."""
    diff = original - inputs @ qweights
    return true_div(sum_f64(diff * diff), diff.numel())


class AwqPass:
    def __init__(self, clip_search: bool):
        self.clip_search = clip_search

    @staticmethod
    def _compute_activation_scale(inputs: torch.Tensor) -> torch.Tensor:
        return _mean_f32(inputs.reshape(-1, inputs.shape[-1]).abs(), dim=0)

    @staticmethod
    def _compute_weight_scale(weights_t: torch.Tensor, strategy, group_size) -> torch.Tensor:
        """Per-in-channel weight salience from the (N, K) transposed weight."""
        w = weights_t.abs()
        if strategy == QuantizationStrategy.TENSOR:
            scale = w / w.max()
        else:
            if strategy == QuantizationStrategy.GROUP:
                w = w.reshape(-1, group_size)
            scale = (w / w.amax(dim=1, keepdim=True)).reshape(weights_t.shape)
        return _mean_f32(scale, dim=0)

    def scale_grid(self, weights: torch.Tensor, inputs: torch.Tensor, w_args):
        """The grid's candidate scales (N_GRID, K) and their losses (N_GRID,)
        for a float32 weight and its captured inputs."""
        flat = inputs.reshape(-1, inputs.shape[-1])
        act_scale = self._compute_activation_scale(inputs)
        weights_scale = self._compute_weight_scale(weights.T, w_args.strategy,
                                                   w_args.group_size)
        original = flat @ weights
        scales, losses = [], []
        for i in range(N_GRID):
            ratio = i / N_GRID
            scale = torch.clamp(pow_f32(act_scale, ratio) / pow_f32(weights_scale, 1 - ratio),
                                min=1e-4)
            scale = scale / torch.sqrt(scale.max() * scale.min())
            col = scale.reshape(-1, 1)
            qweights = _fake_quant_weight(weights * col, w_args, clip_ratio=1.0) / col
            scales.append(scale)
            losses.append(_mse(original, flat, qweights))
        return torch.stack(scales), torch.stack(losses)

    def _apply_awq(self, entry: PlanEntry, params: dict) -> None:
        site_params = tree_get(params, entry.site.param_path)
        weights = site_params["w"].to(torch.float32)
        inputs = entry.captured_input.to(weights.device)
        scales, losses = self.scale_grid(weights, inputs, entry.qconfig.weights)
        best = scales[torch.argmin(losses)]
        fold_prescale(site_params, best)
        entry.captured_input = inputs / best.reshape(1, -1)

    def _apply_awq_clip(self, entry: PlanEntry, params: dict) -> None:
        w_args = entry.qconfig.weights
        weights = tree_get(params, entry.site.param_path)["w"]
        flat = entry.captured_input.reshape(-1, entry.captured_input.shape[-1])
        original = flat @ weights
        ratios = [1 - i / 100 for i in range(N_CLIP)]
        losses = torch.stack([_mse(original, flat, _fake_quant_weight(weights, w_args, r))
                              for r in ratios])
        best_ratio = ratios[int(torch.argmin(losses))]  # one host sync per site
        entry.qconfig = dataclasses.replace(
            entry.qconfig, weights=dataclasses.replace(w_args, clip_ratio=best_ratio))

    def __call__(self, model, params: dict, plan: QuantPlan, qconfig) -> bool:
        modified = False
        for entry in plan:
            if entry.captured_input is None:
                raise ValueError(f"AWQ requires captured inputs for site {entry.name}")
            self._apply_awq(entry, params)
            if self.clip_search:
                self._apply_awq_clip(entry, params)
            modified = True
        if modified:
            logger.info("AWQ pass modified the model")
        return modified
