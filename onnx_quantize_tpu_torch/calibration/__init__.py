from onnx_quantize_tpu_torch.calibration.base import CalibrationData, Calibrator
from onnx_quantize_tpu_torch.calibration.calibrate import calibrate_model, collect_activations
from onnx_quantize_tpu_torch.calibration.entropy import EntropyCalibrator
from onnx_quantize_tpu_torch.calibration.factory import get_calibrator, register_calibrator
from onnx_quantize_tpu_torch.calibration.minmax import MinMaxCalibrator
from onnx_quantize_tpu_torch.calibration.percentile import PercentileCalibrator

__all__ = [
    "CalibrationData",
    "Calibrator",
    "EntropyCalibrator",
    "MinMaxCalibrator",
    "PercentileCalibrator",
    "calibrate_model",
    "collect_activations",
    "get_calibrator",
    "register_calibrator",
]
