"""Pre-pass driver: calibrate -> stamp -> pre-passes -> re-calibrate.

Counterpart of ``onnx_quantize_tpu/prepasses/__init__.py``: calibrate when a
static activation, the weight algorithm (GPTQ) or a pre-pass needs it, stamp
the per-site qconfigs, run each pre-pass (QuaRot, SmoothQuant, AWQ) in order,
and calibrate again when one asks for it (the static ranges and captured
inputs then see the rotated or rescaled sites). QuaRot must come before
SmoothQuant: its fold raises on a prescaled reading site.
"""

from __future__ import annotations

import logging

from onnx_quantize_tpu_torch.calibration import calibrate_model
from onnx_quantize_tpu_torch.core.qconfig import (
    AwqConfig,
    QConfig,
    RotateConfig,
    SmoothQuantConfig,
)
from onnx_quantize_tpu_torch.plan import QuantPlan, stamp_qconfig
from onnx_quantize_tpu_torch.prepasses.awq import AwqPass
from onnx_quantize_tpu_torch.prepasses.rotate import RotatePass
from onnx_quantize_tpu_torch.prepasses.smooth_quant import SmoothQuantPass

logger = logging.getLogger(__name__)

__all__ = ["apply_pre_passes", "AwqConfig", "AwqPass", "RotateConfig", "RotatePass",
           "SmoothQuantConfig", "SmoothQuantPass"]


def _needs_calibration(qconfig: QConfig) -> bool:
    """Whether any consumer needs a calibration run."""
    static = any(a is not None and a.is_static
                 for a in (qconfig.input_activations, qconfig.output_activations))
    algo = qconfig.weights is not None and qconfig.weights.algorithm.requires_calibration
    preproc = any(p.requires_calibration for p in qconfig.preprocessors)
    return static or algo or preproc


def apply_pre_passes(model, params, plan: QuantPlan, qconfig: QConfig) -> None:
    """Calibrate, stamp the per-site qconfigs, run the pre-passes, re-calibrate.
    Mutates ``params`` (nested dicts) and ``plan`` in place."""
    if _needs_calibration(qconfig):
        logger.info("Running calibration")
        calibrate_model(model, params, plan, qconfig)
    stamp_qconfig(plan, qconfig)
    if qconfig.preprocessors:
        for pre_cfg in qconfig.preprocessors:
            pre_pass = pre_cfg.build_pass(qconfig)
            logger.info("Applying pre-pass %s", type(pre_pass).__name__)
            pre_pass(model, params, plan, qconfig)
        if any(p.requires_post_calibration for p in qconfig.preprocessors):
            logger.info("Re-calibrating after pre-processing passes")
            calibrate_model(model, params, plan, qconfig)
