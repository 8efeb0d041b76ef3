from onnx_quantize_tpu_torch.calibration.base import CalibrationData, Calibrator
from onnx_quantize_tpu_torch.calibration.calibrate import calibrate_model, collect_activations
from onnx_quantize_tpu_torch.calibration.factory import get_calibrator
from onnx_quantize_tpu_torch.calibration.minmax import MinMaxCalibrator

__all__ = [
    "CalibrationData",
    "Calibrator",
    "MinMaxCalibrator",
    "calibrate_model",
    "collect_activations",
    "get_calibrator",
]
