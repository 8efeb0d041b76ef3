"""Declarative quantization configuration: weights and their algorithm,
activations, calibration, pre-passes.

Counterpart of ``onnx_quantize_tpu/core/qconfig.py`` as plain dataclasses: the
machine the port runs on has no pydantic. The weight rules are the same
(strategy inferred from ``group_size``: None -> tensor, -1 -> channel,
> 0 -> group), and so are the activation rules, the calibration knobs and
the config-level checks that tie weights, activations and the QLINEAR format
together. ``CalibrationParams.backend`` names a torch device where the
reference names a JAX platform.

The weight algorithms (RTN, GPTQ, HQQ) and the pre-passes (SmoothQuant, AWQ,
QuaRot) are config dataclasses here, as in the reference; each dispatches to
its module (``algorithms/``, ``prepasses/``) when it runs. A config given as a
dict picks its class by its ``algorithm_type`` or ``preprocessing_type`` tag.
"""

from __future__ import annotations

import dataclasses
import enum
from collections.abc import Sequence
from typing import TYPE_CHECKING, Any, ClassVar

import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

if TYPE_CHECKING:
    from onnx_quantize_tpu_torch.plan import PlanEntry

__all__ = ["QConfig", "QWeightArgs", "QActivationArgs", "CalibrationParams",
           "CalibrationMethod", "AlgorithmConfig", "RTNConfig", "GPTQConfig", "HqqConfig",
           "PreProcessingConfig", "SmoothQuantConfig", "AwqConfig", "RotateConfig"]

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


class AlgorithmConfig:
    """Base of the weight algorithms: ``quantize_weights`` returns
    ``(q_weight, scale, zero_point)`` for a float32 ``(in_features,
    out_features)`` weight, on the weight's device."""

    # Whether the algorithm needs the sites' input activations captured.
    requires_calibration: ClassVar[bool] = False
    algorithm_type: ClassVar[str]

    def validate_weight_args(self, weight_args: "QWeightArgs") -> None:
        """Hook for algorithm-specific constraints on the enclosing QWeightArgs."""

    def quantize_weights(self, weight: torch.Tensor, qconfig: "QConfig",
                         entry: "PlanEntry | None" = None):
        raise NotImplementedError(f"{type(self).__name__} must implement quantize_weights().")


@dataclasses.dataclass(frozen=True)
class RTNConfig(AlgorithmConfig):
    """Round-to-nearest: no parameters beyond QWeightArgs."""

    algorithm_type: ClassVar[str] = "rtn"

    def quantize_weights(self, weight, qconfig, entry=None):
        from onnx_quantize_tpu_torch.algorithms.rtn import quantize_weights

        return quantize_weights(self, weight, qconfig, entry)


@dataclasses.dataclass(frozen=True)
class GPTQConfig(AlgorithmConfig):
    """GPTQ: block_size is the lazy-batch block width of the error-corrected
    sweep, percdamp the Hessian dampening as a fraction of mean(diag(H)),
    actorder quantizes columns in decreasing diag(H) order."""

    requires_calibration: ClassVar[bool] = True
    algorithm_type: ClassVar[str] = "gptq"
    block_size: int = 128
    percdamp: float = 0.01
    actorder: bool = False

    def quantize_weights(self, weight, qconfig, entry=None):
        from onnx_quantize_tpu_torch.algorithms.gptq import quantize_weights

        return quantize_weights(self, weight, qconfig, entry)


@dataclasses.dataclass(frozen=True)
class HqqConfig(AlgorithmConfig):
    """HQQ: half-quadratic zero-point optimisation (lp-norm ``lp_norm``,
    beta, kappa, ``iters`` iterations, optional early stop). Only uint4,
    asymmetric, group strategy, group size a power of two >= 16; the zero
    point stays in float32."""

    algorithm_type: ClassVar[str] = "hqq"
    lp_norm: float = 0.7
    beta: float = 1e1
    kappa: float = 1.01
    iters: int = 20
    early_stop: bool = True

    def validate_weight_args(self, weight_args: "QWeightArgs") -> None:
        if weight_args.dtype != QuantType.QUInt4:
            raise ValueError(f"HQQ only supports uint4 weight type. Found: {weight_args.dtype}")
        if weight_args.symmetric:
            raise ValueError("HQQ only supports asymmetric quantization.")
        if weight_args.strategy != QuantizationStrategy.GROUP:
            raise ValueError(
                f"HQQ only supports 'group' quantization strategy. Found: {weight_args.strategy}"
            )
        gs = weight_args.group_size
        if gs != -1 and (gs < 16 or (gs & (gs - 1)) != 0):
            raise ValueError(
                "HQQ requires group_size to be greater than 16 and a power of 2. "
                f"Found: {gs}"
            )
        # HQQ keeps the zero point in float, in the scale's dtype.
        object.__setattr__(weight_args, "zp_dtype", torch.float32)

    def quantize_weights(self, weight, qconfig, entry=None):
        from onnx_quantize_tpu_torch.algorithms.hqq import quantize_weights

        return quantize_weights(self, weight, qconfig, entry)


_ALGORITHMS: dict[str, type[AlgorithmConfig]] = {
    cls.algorithm_type: cls for cls in (RTNConfig, GPTQConfig, HqqConfig)}


def _resolve_algorithm(value) -> AlgorithmConfig:
    """None (RTN), a config, its tag, or a dict with its ``algorithm_type``."""
    if value is None:
        return RTNConfig()
    if isinstance(value, AlgorithmConfig):
        return value
    if isinstance(value, str):
        value = {"algorithm_type": value.lower()}
    if isinstance(value, dict):
        kwargs = dict(value)
        tag = kwargs.pop("algorithm_type", None)
        if tag not in _ALGORITHMS:
            raise ValueError(f"Unknown algorithm_type {tag!r}. Registered: {sorted(_ALGORITHMS)}")
        return _ALGORITHMS[tag](**kwargs)
    raise TypeError(f"algorithm must be an AlgorithmConfig, a tag or a dict, got {type(value)}")


@dataclasses.dataclass(frozen=True)
class QWeightArgs:
    """Weight quantization parameters.

    ``algorithm`` is an :class:`AlgorithmConfig` (RTN by default), its tag or
    a dict; ``clip_ratio`` in (0, 1] scales the min/max range; ``mse`` runs
    the shrink-grid range search (``core.numerics.compute_min_max_mse``).
    ``zp_dtype`` is derived: the container dtype, float32 under HQQ. As in
    the reference, the algorithm's constraints are checked before the
    strategy is inferred from ``group_size`` (HQQ needs ``strategy="group"``
    spelled out).
    """

    dtype: QuantType | str = QuantType.QInt8
    symmetric: bool = False
    group_size: int | None = None
    strategy: QuantizationStrategy | str | None = None
    reduce_range: bool = False
    clip_ratio: float = 1.0
    mse: bool = False
    algorithm: AlgorithmConfig | str | dict | None = None
    zp_dtype: torch.dtype | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        if not 0.0 < self.clip_ratio <= 1.0:
            raise ValueError(f"clip_ratio must be in (0.0, 1.0], got {self.clip_ratio}")
        if self.group_size is not None and self.group_size < -1:
            raise ValueError(
                f"Invalid group size {self.group_size}. Use group_size > 0 for "
                "strategy='group' and group_size = -1 for 'channel'"
            )
        object.__setattr__(self, "dtype", _parse_dtype(self.dtype))
        object.__setattr__(self, "strategy", _parse_strategy(self.strategy))
        object.__setattr__(self, "algorithm", _resolve_algorithm(self.algorithm))
        self.algorithm.validate_weight_args(self)
        object.__setattr__(self, "strategy", _resolve_strategy(self.group_size, self.strategy))
        if self.zp_dtype is None:
            object.__setattr__(self, "zp_dtype", self.dtype.container_dtype)


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


class PreProcessingConfig:
    """Base of the pre-passes (SmoothQuant, AWQ): ``build_pass`` returns a
    callable ``pass_(model, params, plan, qconfig)`` that rewrites the site
    weights, adds their input ``prescale`` and updates the plan in place."""

    requires_calibration: ClassVar[bool] = True
    requires_post_calibration: ClassVar[bool] = True
    preprocessing_type: ClassVar[str]

    def build_pass(self, qconfig: "QConfig"):
        raise NotImplementedError(f"{type(self).__name__} must implement build_pass().")


@dataclasses.dataclass(frozen=True)
class SmoothQuantConfig(PreProcessingConfig):
    """SmoothQuant: alpha sets how much activation range moves into the weights."""

    preprocessing_type: ClassVar[str] = "smooth_quant"
    alpha: float = 0.5

    def build_pass(self, qconfig: "QConfig"):
        from onnx_quantize_tpu_torch.prepasses.smooth_quant import SmoothQuantPass

        return SmoothQuantPass(alpha=self.alpha)


@dataclasses.dataclass(frozen=True)
class AwqConfig(PreProcessingConfig):
    """AWQ: the activation-aware scale search; ``clip_search`` adds the
    per-site clip-ratio sweep."""

    preprocessing_type: ClassVar[str] = "awq"
    clip_search: bool = False

    def build_pass(self, qconfig: "QConfig"):
        from onnx_quantize_tpu_torch.prepasses.awq import AwqPass

        return AwqPass(clip_search=self.clip_search)


@dataclasses.dataclass(frozen=True)
class RotateConfig(PreProcessingConfig):
    """QuaRot: the residual-stream rotation (``mode`` "hadamard" or "random",
    drawn from ``seed``) and the online rotations: ``rotate_qk`` rotates q and
    k per head after RoPE (the K cache rotated), ``rotate_v`` folds the V
    head-space rotation (the V cache rotated), ``rotate_down`` mixes the
    down_proj input in Hadamard blocks of ``online_block``. The rotation
    needs no calibration; the driver calibrates again after it."""

    preprocessing_type: ClassVar[str] = "rotate"
    requires_calibration: ClassVar[bool] = False
    mode: str = "hadamard"
    seed: int = 0
    rotate_qk: bool = False
    rotate_v: bool = False
    rotate_down: bool = False
    online_block: int = 128

    def __post_init__(self):
        if self.mode not in ("hadamard", "random"):
            raise ValueError(f"RotateConfig.mode must be 'hadamard' or 'random', got "
                             f"{self.mode!r}")

    def build_pass(self, qconfig: "QConfig"):
        from onnx_quantize_tpu_torch.prepasses.rotate import RotatePass

        return RotatePass(mode=self.mode, seed=self.seed, rotate_qk=self.rotate_qk,
                          rotate_v=self.rotate_v, rotate_down=self.rotate_down,
                          online_block=self.online_block)


_PREPASSES: dict[str, type[PreProcessingConfig]] = {
    cls.preprocessing_type: cls for cls in (SmoothQuantConfig, AwqConfig, RotateConfig)}


def _resolve_prepass(value) -> PreProcessingConfig:
    if isinstance(value, PreProcessingConfig):
        return value
    if isinstance(value, dict):
        kwargs = dict(value)
        tag = kwargs.pop("preprocessing_type", None)
        if tag not in _PREPASSES:
            raise ValueError(f"Unknown preprocessing_type {tag!r}. Registered: "
                             f"{sorted(_PREPASSES)}")
        return _PREPASSES[tag](**kwargs)
    raise TypeError(f"preprocessors take PreProcessingConfig or dict items, got {type(value)}")


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
        preprocessors: pre-passes run in order before the weights are
            quantized (``RotateConfig``, ``SmoothQuantConfig``, ``AwqConfig``, or
            their dicts).
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
        object.__setattr__(self, "preprocessors",
                           tuple(_resolve_prepass(p) for p in self.preprocessors or ()))
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
