"""Declarative quantization configuration, cut to weight-only RTN QDQ.

Counterpart of ``onnx_quantize_tpu/core/qconfig.py`` as plain dataclasses: the
machine the port runs on has no pydantic. The weight rules are the same
(strategy inferred from ``group_size``: None -> tensor, -1 -> channel,
> 0 -> group). Anything beyond weight-only RTN QDQ raises
``NotImplementedError`` naming the ROADMAP.md entry that will port it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QFormat, QuantizationStrategy

__all__ = ["QConfig", "QWeightArgs"]

_REST_OF_QUANTIZER = "ROADMAP.md, Queue A item 10 (rest of the quantizer)"


def _not_ported(what: str, entry: str = _REST_OF_QUANTIZER) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet; see {entry}.")


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
        dtype = self.dtype
        if isinstance(dtype, str):
            dtype = QuantType.from_string(dtype)
        group_size = self.group_size
        if group_size is not None and group_size < -1:
            raise ValueError(
                f"Invalid group size {group_size}. Use group_size > 0 for "
                "strategy='group' and group_size = -1 for 'channel'"
            )
        strategy = self.strategy
        if isinstance(strategy, str):
            strategy = QuantizationStrategy(strategy.lower())
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
        if self.algorithm.lower() != "rtn":
            raise _not_ported(f"Weight algorithm {self.algorithm!r}")
        if self.mse:
            raise _not_ported("The MSE range search", "ROADMAP.md, Queue A item 1")
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "strategy", strategy)


@dataclasses.dataclass(frozen=True)
class QConfig:
    """Top-level quantization spec.

    Args:
        weights: the weight quantization, or None for no quantization.
        ignore: regex patterns matched against site names with ``re.search``;
            matching sites are skipped.
        input_activations / output_activations / calibration_data /
        preprocessors / format: accepted so that a config written for the JAX
        package fails loudly; anything but the defaults raises
        ``NotImplementedError``.
    """

    weights: QWeightArgs | None = None
    ignore: Sequence[str] = ()
    input_activations: Any = None
    output_activations: Any = None
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
        if self.input_activations is not None or self.output_activations is not None:
            raise _not_ported("Activation quantization")
        if self.calibration_data is not None:
            raise _not_ported("Calibration")
        if self.preprocessors:
            raise _not_ported("Pre-passes (SmoothQuant, AWQ, QuaRot)")
        fmt = QFormat(self.format.lower()) if isinstance(self.format, str) else self.format
        if fmt != QFormat.QDQ:
            raise _not_ported("The QLINEAR format", "ROADMAP.md, Queue B #7")
        object.__setattr__(self, "format", fmt)
