"""MinMax calibrator with optional EMA momentum.

Counterpart of ``onnx_quantize_tpu/calibration/minmax.py``: strict min/max
tracking by default; momentum > 0 switches to exponential moving average
smoothing across batches; the final range is clamped to include zero. The
statistics stay on the activations' device as float32 scalars (min and max
of a bf16 tensor are exact in float32).
"""

from __future__ import annotations

import logging

import torch

from onnx_quantize_tpu_torch.calibration.base import CalibrationData, Calibrator

logger = logging.getLogger(__name__)

__all__ = ["MinMaxCalibrator"]


class MinMaxCalibrator(Calibrator):
    def __init__(self, momentum: float = 0.0):
        super().__init__()
        assert 0 <= momentum < 1, "Momentum must be in the range [0, 1)."
        self.momentum = momentum
        logger.debug("Initialized MinMaxCalibrator with momentum=%s", momentum)

    def collect(self, name: str, array) -> None:
        array = torch.as_tensor(array)
        current_min = array.min().to(torch.float32)
        current_max = array.max().to(torch.float32)

        if name not in self.data:
            self.data[name] = CalibrationData(min_val=current_min, max_val=current_max)
            return

        entry = self.data[name]
        if self.momentum > 0:
            entry.min_val = self.momentum * entry.min_val + (1 - self.momentum) * current_min
            entry.max_val = self.momentum * entry.max_val + (1 - self.momentum) * current_max
        else:
            entry.min_val = torch.minimum(entry.min_val, current_min)
            entry.max_val = torch.maximum(entry.max_val, current_max)

    def compute_range(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        if name not in self.data:
            raise KeyError(f"No calibration data collected for '{name}'")
        entry = self.data[name]
        # Include zero in the range so the zero point is exactly representable.
        return torch.clamp(entry.min_val, max=0.0), torch.clamp(entry.max_val, min=0.0)
