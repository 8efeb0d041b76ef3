"""Calibrator framework: the abstract calibrator and its running statistics.

Counterpart of ``onnx_quantize_tpu/calibration/base.py`` over torch tensors.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

__all__ = ["CalibrationData", "Calibrator"]


@dataclasses.dataclass
class CalibrationData:
    """Running statistics for one tapped activation (float32 scalars)."""

    min_val: torch.Tensor
    max_val: torch.Tensor


class Calibrator(abc.ABC):
    """Collects per-name activation statistics and produces quantization ranges."""

    def __init__(self):
        self.data: dict[str, CalibrationData] = {}

    @abc.abstractmethod
    def collect(self, name: str, array) -> None:
        """Fold one activation batch into the running statistics for ``name``."""

    @abc.abstractmethod
    def compute_range(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Final (min, max) quantization range for ``name``."""
