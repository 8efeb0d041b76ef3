"""Declarative quantization configuration: RTN, activations, calibration.

Counterpart of ``onnx_quantize_tpu/core/qconfig.py`` as plain dataclasses: the
machine the port runs on has no pydantic. The weight rules are the same
(strategy inferred from ``group_size``: None -> tensor, -1 -> channel,
> 0 -> group), and so are the activation rules, the calibration knobs and
the config-level checks that tie weights, activations and the QLINEAR format
together. ``CalibrationParams.backend`` names a torch device where the
reference names a JAX platform. Anything beyond RTN with minmax calibration
raises ``NotImplementedError`` naming the ROADMAP.md entry that will port it.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Sequence
from typing import Any

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

__all__ = ["QConfig", "QWeightArgs", "QActivationArgs", "CalibrationParams",
           "CalibrationMethod"]

_REST_OF_QUANTIZER = "ROADMAP.md, Queue A item 10 (rest of the quantizer)"


def _not_ported(what: str, entry: str = _REST_OF_QUANTIZER) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet; see {entry}.")


def _parse_dtype(dtype: QuantType | str) -> QuantType:
    return QuantType.from_string(dtype) if isinstance(dtype, str) else dtype


def _parse_strategy(strategy):
    return QuantizationStrategy(strategy.lower()) if isinstance(strategy, str) else strategy


def _resolve_strategy(group_size: int | None, strategy) -> QuantizationStrategy:
    """The reference's shared rules: check ``group_size`` and infer the
    strategy from it when none is given."""
    if group_size is not None and group_size < -1:
        raise ValueError(
            f"Invalid group size {group_size}. Use group_size > 0 for "
            "strategy='group' and group_size = -1 for 'channel'"
        )
    if strategy is None:
        if group_size is None:
            strategy = QuantizationStrategy.TENSOR
        elif group_size > 0:
            strategy = QuantizationStrategy.GROUP
        elif group_size == -1:
            strategy = QuantizationStrategy.CHANNEL
        else:
            raise ValueError(
                f"Invalid group size {group_size}. Use group_size > 0 for "
                "strategy='group' and group_size = -1 for 'channel'"
            )
    if strategy == QuantizationStrategy.GROUP and (group_size is None or group_size <= 0):
        raise ValueError(
            f"strategy {strategy} requires group_size to be set to a positive value."
        )
    if group_size is not None and group_size > 0 and strategy != QuantizationStrategy.GROUP:
        raise ValueError("group_size requires strategy to be set to 'group'.")
    return strategy


class CalibrationMethod(enum.Enum):
    MINMAX = "minmax"
    PERCENTILE = "percentile"
    ENTROPY = "entropy"


def _parse_backend(value) -> torch.device | None:
    """None (the params' device), a torch device, or its name; "gpu" and
    "default" name the CUDA device."""
    if value is None or isinstance(value, torch.device):
        return value
    key = str(value).lower()
    try:
        return torch.device("cuda" if key in ("gpu", "default") else key)
    except RuntimeError:
        raise ValueError(  # noqa: B904
            f"Invalid backend '{value}'. Valid values are: 'cpu', 'cuda', 'cuda:<n>', "
            "'gpu', 'default'"
        )


@dataclasses.dataclass(frozen=True)
class CalibrationParams:
    """Calibration knobs, with the reference's validators.

    num_samples / batch_size control the calibration mini-batching; momentum
    enables EMA smoothing in the MinMax calibrator; backend is the device the
    calibration forwards run on (None: the params' device). A device that is
    absent raises at calibration; there is no CPU fallback.
    """

    method: CalibrationMethod | str = CalibrationMethod.MINMAX
    num_samples: int = 100
    batch_size: int = 10
    momentum: float = 0.0
    percentile: float = 0.999  # used by method="percentile"
    backend: torch.device | str | None = None

    def __post_init__(self):
        method = self.method
        if isinstance(method, str):
            try:
                method = CalibrationMethod(method)
            except ValueError:
                valid = [m.value for m in CalibrationMethod]
                raise ValueError(  # noqa: B904
                    f"Invalid calibration method '{method}'. Valid methods are: {valid}"
                )
        if not 0 <= self.momentum < 1:
            raise ValueError(f"Momentum must be in [0, 1), got {self.momentum}")
        if not 0 < self.percentile <= 1:
            raise ValueError(f"percentile must be in (0, 1], got {self.percentile}")
        for name in ("num_samples", "batch_size"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")
        object.__setattr__(self, "method", method)
        object.__setattr__(self, "backend", _parse_backend(self.backend))


@dataclasses.dataclass(frozen=True)
class QWeightArgs:
    """Weight quantization parameters.

    ``algorithm`` accepts only "rtn" and ``mse`` only False for now.
    """

    dtype: QuantType | str = QuantType.QInt8
    symmetric: bool = False
    group_size: int | None = None
    strategy: QuantizationStrategy | str | None = None
    reduce_range: bool = False
    algorithm: str = "rtn"
    mse: bool = False

    def __post_init__(self):
        dtype = _parse_dtype(self.dtype)
        strategy = _resolve_strategy(self.group_size, _parse_strategy(self.strategy))
        if self.algorithm.lower() != "rtn":
            raise _not_ported(f"Weight algorithm {self.algorithm!r}")
        if self.mse:
            raise _not_ported("The MSE range search", "ROADMAP.md, Queue A item 1")
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "strategy", strategy)


@dataclasses.dataclass(frozen=True)
class QActivationArgs:
    """Activation quantization parameters, with the reference's validators:
    per-tensor only, no 4-bit types, dynamic only as uint8.

    As in the reference, only an explicit ``strategy`` is held to "tensor";
    a strategy inferred from ``group_size`` is kept (ROADMAP.md, Queue C).
    """

    dtype: QuantType | str = QuantType.QInt8
    symmetric: bool = False
    group_size: int | None = None
    strategy: QuantizationStrategy | str | None = None
    reduce_range: bool = False
    is_static: bool = True

    def __post_init__(self):
        dtype = _parse_dtype(self.dtype)
        strategy = _parse_strategy(self.strategy)
        if strategy is not None and strategy != QuantizationStrategy.TENSOR:
            raise NotImplementedError("Activation quantization only supports 'tensor' strategy.")
        if dtype in (QuantType.QInt4, QuantType.QUInt4):
            raise NotImplementedError("4-bit quantization is not supported for activations.")
        if not self.is_static and dtype != QuantType.QUInt8:
            raise NotImplementedError(
                "Dynamic activation quantization only supports uint8 dtype."
            )
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "strategy", _resolve_strategy(self.group_size, strategy))


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Top-level quantization spec.

    Args:
        weights: the weight quantization, or None for no quantization.
        ignore: regex patterns matched against site names with ``re.search``;
            matching sites are skipped.
        input_activations / output_activations: activation quantization of
            each site's input / output, dynamic or static (static qparams are
            calibrated).
        format: QDQ, or QLINEAR (full integer compute; needs static int8 or
            uint8 inputs and outputs and 8-bit channel or tensor weights).
        calibration_params / calibration_data: the calibration knobs (a
            ``CalibrationParams`` or its keyword dict) and the model inputs
            (an array for the model's one input, or a dict of input name to
            array); with no data, random data from the model's input specs.
        preprocessors: accepted so that a config written for the JAX package
            fails loudly; any pre-pass raises ``NotImplementedError``.
    """

    weights: QWeightArgs | None = None
    ignore: Sequence[str] = ()
    input_activations: QActivationArgs | None = None
    output_activations: QActivationArgs | None = None
    calibration_params: CalibrationParams | dict | None = dataclasses.field(
        default_factory=CalibrationParams)
    calibration_data: Any = None
    preprocessors: Sequence[Any] = ()
    format: QFormat | str = QFormat.QDQ

    def __post_init__(self):
        ignore = self.ignore
        if ignore is None:
            ignore = ()
        elif isinstance(ignore, str):
            ignore = (ignore,)
        object.__setattr__(self, "ignore", tuple(ignore))
        fmt = self.format
        if isinstance(fmt, str):
            try:
                fmt = QFormat(fmt.lower())
            except ValueError:
                valid = [f.value for f in QFormat]
                raise ValueError(  # noqa: B904
                    f"Invalid quantization format '{fmt}'. Valid formats are: {valid}"
                )
        object.__setattr__(self, "format", fmt)
        if isinstance(self.calibration_params, dict):
            object.__setattr__(self, "calibration_params",
                               CalibrationParams(**self.calibration_params))
        if self.preprocessors:
            raise _not_ported("Pre-passes (SmoothQuant, AWQ, QuaRot)")
        cp = self.calibration_params
        if cp is not None and cp.method != CalibrationMethod.MINMAX:
            raise _not_ported(f"The {cp.method.value} calibrator")
        self._check_activations()

    def _check_activations(self) -> None:
        """The reference's checks of weights against activations and of the
        QLINEAR format (none apply to a config without weights or
        activations)."""
        acts = [a for a in (self.input_activations, self.output_activations) if a is not None]
        for a in acts:
            if not isinstance(a, QActivationArgs):
                raise TypeError(f"activation args must be QActivationArgs, got {type(a)}")
        if self.weights is None and not acts:
            return
        if self.weights is None:
            raise ValueError("Activation only quantization is not supported.")
        if acts and self.weights.dtype in (QuantType.QInt4, QuantType.QUInt4):
            raise NotImplementedError(
                "4-bit quantization is only supported for weights_only quantization."
            )
        if acts and self.weights.strategy == QuantizationStrategy.GROUP:
            raise NotImplementedError(
                "Group quantization is only supported for weights_only quantization."
            )
        if len(acts) == 2 and acts[0].is_static != acts[1].is_static:
            raise NotImplementedError(
                "Both input and output activations must be either both static or dynamic."
            )
        if self.format == QFormat.QLINEAR:
            self._check_qlinear_format_constraints()

    def _check_qlinear_format_constraints(self) -> None:
        if self.input_activations is None or self.output_activations is None:
            raise ValueError(
                "QLinear format requires both input and output activation quantization."
            )
        if not (self.input_activations.is_static and self.output_activations.is_static):
            raise ValueError(
                "QLinear format requires both input and output activations "
                "quantization to be static."
            )
        if self.weights.strategy == QuantizationStrategy.GROUP:
            raise NotImplementedError(
                "QLinear format does not support grouped weight quantization."
            )
        valid = (QuantType.QInt8, QuantType.QUInt8)
        for what, dtype in (("weights", self.weights.dtype),
                            ("input activations", self.input_activations.dtype),
                            ("output activations", self.output_activations.dtype)):
            if dtype not in valid:
                raise ValueError(
                    f"QLinear format supports only int8/uint8 for {what}, got {dtype}."
                )
