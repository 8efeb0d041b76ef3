"""Calibrator method registry.

Counterpart of ``onnx_quantize_tpu/calibration/factory.py``. MinMax is
ported; the percentile and entropy calibrators raise until they are
(ROADMAP.md, Queue A item 10).
"""

from __future__ import annotations

from onnx_quantize_tpu_torch.calibration.base import Calibrator
from onnx_quantize_tpu_torch.calibration.minmax import MinMaxCalibrator
from onnx_quantize_tpu_torch.core.qconfig import CalibrationMethod

__all__ = ["get_calibrator"]

_CALIBRATORS: dict[CalibrationMethod, type[Calibrator]] = {
    CalibrationMethod.MINMAX: MinMaxCalibrator,
}


def get_calibrator(method: CalibrationMethod | str, **kwargs) -> Calibrator:
    if isinstance(method, str):
        method = CalibrationMethod(method)
    if method not in _CALIBRATORS:
        raise NotImplementedError(
            f"The {method.value} calibrator is not ported to PyTorch yet; see ROADMAP.md, "
            "Queue A item 10."
        )
    return _CALIBRATORS[method](**kwargs)
