"""Calibrator method registry.

Counterpart of ``onnx_quantize_tpu/calibration/factory.py``.
"""

from __future__ import annotations

from onnx_quantize_tpu_torch.calibration.base import Calibrator
from onnx_quantize_tpu_torch.calibration.entropy import EntropyCalibrator
from onnx_quantize_tpu_torch.calibration.minmax import MinMaxCalibrator
from onnx_quantize_tpu_torch.calibration.percentile import PercentileCalibrator
from onnx_quantize_tpu_torch.core.qconfig import CalibrationMethod

__all__ = ["get_calibrator", "register_calibrator"]

_CALIBRATORS: dict[CalibrationMethod, type[Calibrator]] = {
    CalibrationMethod.MINMAX: MinMaxCalibrator,
    CalibrationMethod.PERCENTILE: PercentileCalibrator,
    CalibrationMethod.ENTROPY: EntropyCalibrator,
}


def register_calibrator(method: CalibrationMethod, cls: type[Calibrator]) -> None:
    _CALIBRATORS[method] = cls


def get_calibrator(method: CalibrationMethod | str, **kwargs) -> Calibrator:
    if isinstance(method, str):
        method = CalibrationMethod(method)
    if method not in _CALIBRATORS:
        raise ValueError(
            f"Unknown calibration method {method}. Registered: {sorted(_CALIBRATORS)}"
        )
    return _CALIBRATORS[method](**kwargs)
