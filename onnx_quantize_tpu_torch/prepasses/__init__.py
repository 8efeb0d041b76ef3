"""Pre-passes: calibrate, then stamp the per-site qconfig.

Counterpart of ``onnx_quantize_tpu/prepasses/__init__.py`` without the
preprocessors: SmoothQuant, AWQ and QuaRot are not ported yet (``QConfig``
refuses them; ROADMAP.md, Queue A item 10), so there is no pre-pass to run
and no re-calibration after one.
"""

from __future__ import annotations

import logging

from onnx_quantize_tpu_torch.calibration import calibrate_model
from onnx_quantize_tpu_torch.core.qconfig import QConfig
from onnx_quantize_tpu_torch.plan import QuantPlan, stamp_qconfig

logger = logging.getLogger(__name__)

__all__ = ["apply_pre_passes"]


def _needs_calibration(qconfig: QConfig) -> bool:
    """Whether a static activation quantization needs a calibration run."""
    return any(a is not None and a.is_static
               for a in (qconfig.input_activations, qconfig.output_activations))


def apply_pre_passes(model, params, plan: QuantPlan, qconfig: QConfig) -> None:
    """Calibrate (where needed), then stamp the per-site qconfigs. Mutates
    ``plan`` in place."""
    if _needs_calibration(qconfig):
        logger.info("Running calibration")
        calibrate_model(model, params, plan, qconfig)
    stamp_qconfig(plan, qconfig)
