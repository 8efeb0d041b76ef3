"""Declarative quantization configuration, cut to RTN QDQ.

Counterpart of ``onnx_quantize_tpu/core/qconfig.py`` as plain dataclasses: the
machine the port runs on has no pydantic. The weight rules are the same
(strategy inferred from ``group_size``: None -> tensor, -1 -> channel,
> 0 -> group), and so are the activation rules and the config-level checks
that tie weights and activations together. Dynamic activations are ported;
static ones need calibration, and they and anything else beyond RTN QDQ
raise ``NotImplementedError`` naming the ROADMAP.md entry that will port it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

__all__ = ["QConfig", "QWeightArgs", "QActivationArgs"]

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
        input_activations / output_activations: dynamic activation
            quantization of each site's input / output (static activations
            need calibration, which is not ported yet).
        calibration_data / preprocessors / format: accepted so that a config
            written for the JAX package fails loudly; anything but the
            defaults raises ``NotImplementedError``.
    """

    weights: QWeightArgs | None = None
    ignore: Sequence[str] = ()
    input_activations: QActivationArgs | None = None
    output_activations: QActivationArgs | None = None
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
        self._check_activations()
        if self.calibration_data is not None:
            raise _not_ported("Calibration")
        if self.preprocessors:
            raise _not_ported("Pre-passes (SmoothQuant, AWQ, QuaRot)")
        fmt = QFormat(self.format.lower()) if isinstance(self.format, str) else self.format
        if fmt != QFormat.QDQ:
            raise _not_ported("The QLINEAR format", "ROADMAP.md, Queue B #7")
        object.__setattr__(self, "format", fmt)

    def _check_activations(self) -> None:
        """The reference's checks of weights against activations, then the
        port's: static activations wait for calibration."""
        acts = [a for a in (self.input_activations, self.output_activations) if a is not None]
        for a in acts:
            if not isinstance(a, QActivationArgs):
                raise TypeError(f"activation args must be QActivationArgs, got {type(a)}")
        if not acts:
            return
        if self.weights is None:
            raise ValueError("Activation only quantization is not supported.")
        if self.weights.dtype in (QuantType.QInt4, QuantType.QUInt4):
            raise NotImplementedError(
                "4-bit quantization is only supported for weights_only quantization."
            )
        if self.weights.strategy == QuantizationStrategy.GROUP:
            raise NotImplementedError(
                "Group quantization is only supported for weights_only quantization."
            )
        if len(acts) == 2 and acts[0].is_static != acts[1].is_static:
            raise NotImplementedError(
                "Both input and output activations must be either both static or dynamic."
            )
        if any(a.is_static for a in acts):
            raise _not_ported("Static activation quantization (calibration)")
