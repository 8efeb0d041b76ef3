"""SmoothQuant: migrate activation-quantization difficulty into the weights.

Counterpart of ``onnx_quantize_tpu/prepasses/smooth_quant.py``: per input
channel ``s = act_max^alpha / (w_max + 1e-9)^(1-alpha)``, the activation
scale being the channel's largest |x| over the captured inputs (at least
1e-5); ``s`` is fused into the weight (kept float32, not rounded back to the
stream dtype) and ``1/s`` becomes the site's input ``prescale``; the
captured inputs are divided by ``s`` so later stages see the smoothed
activations. Runs on the weight's device; the powers are
``core.numerics.pow_f32``'s, so the card's scales equal the CPU's.
"""

from __future__ import annotations

import logging

import torch

from onnx_quantize_tpu_torch.core.numerics import pow_f32
from onnx_quantize_tpu_torch.plan import PlanEntry, QuantPlan
from onnx_quantize_tpu_torch.utils import tree_get

logger = logging.getLogger(__name__)

__all__ = ["SmoothQuantPass"]


def fold_prescale(site_params: dict, scale: torch.Tensor) -> None:
    """Fold a per-input-channel ``scale`` into the site: the weight's rows
    times ``scale`` (float32) and ``1/scale`` into its input prescale."""
    site_params["w"] = scale.reshape(-1, 1) * site_params["w"].to(torch.float32)
    prescale = torch.ones_like(scale) / scale
    prev = site_params.get("prescale")
    site_params["prescale"] = prescale if prev is None else prev * prescale


class SmoothQuantPass:
    """In-place param/plan pass applying SmoothQuant per site."""

    def __init__(self, alpha: float):
        self.alpha = alpha

    @staticmethod
    def _compute_activation_scale(inputs: torch.Tensor) -> torch.Tensor:
        act_scale = inputs.reshape(-1, inputs.shape[-1]).abs().amax(dim=0)
        # Zero-activation channels need no smoothing.
        return torch.clamp(act_scale, min=1e-5)

    def _smooth_site(self, entry: PlanEntry, params: dict) -> bool:
        if not entry.qconfig.preprocessors:
            return False
        if entry.captured_input is None:
            raise ValueError(f"SmoothQuant requires captured inputs for site {entry.name}")
        site_params = tree_get(params, entry.site.param_path)
        weights = site_params["w"].to(torch.float32)
        inputs = entry.captured_input.to(weights.device)
        act_scale = self._compute_activation_scale(inputs)
        weights_scale = weights.abs().amax(dim=1)
        scale = pow_f32(act_scale, self.alpha) / pow_f32(weights_scale + 1e-9, 1 - self.alpha)
        fold_prescale(site_params, scale)
        entry.captured_input = inputs / scale.reshape(1, -1)
        return True

    def __call__(self, model, params: dict, plan: QuantPlan, qconfig) -> bool:
        modified = False
        for entry in plan:
            modified |= self._smooth_site(entry, params)
        if modified:
            logger.info("SmoothQuant pass modified the model")
        return modified
