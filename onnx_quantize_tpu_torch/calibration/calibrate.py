"""Calibration: tapped forwards under ``torch.no_grad()``.

Counterpart of ``onnx_quantize_tpu/calibration/calibrate.py``. The model's own
forward runs with a tap :class:`~onnx_quantize_tpu_torch.nn.module.Context`
that records each target site's input and output, on the device named by
``CalibrationParams.backend`` or, by default, the one the params live on:

  * random calibration data when none is given (numpy ``default_rng(0)``;
    integer inputs drawn in [0, 100) as conservative token ids),
  * mini-batching with the excess samples dropped,
  * multi-input models require dict data,
  * static input/output qparams per plan entry from the calibrator.

Unlike the reference, a requested device that is absent raises: there is no
CPU fallback. Capturing raw site inputs (for GPTQ, AWQ and SmoothQuant)
waits with those algorithms (ROADMAP.md, Queue A item 10).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from onnx_quantize_tpu_torch.calibration.base import Calibrator
from onnx_quantize_tpu_torch.calibration.factory import get_calibrator
from onnx_quantize_tpu_torch.core.numerics import compute_qparams
from onnx_quantize_tpu_torch.core.qconfig import QActivationArgs, QConfig
from onnx_quantize_tpu_torch.nn.module import Context, InputSpec, Module
from onnx_quantize_tpu_torch.plan import QuantPlan
from onnx_quantize_tpu_torch.utils import tree_map

logger = logging.getLogger(__name__)

__all__ = ["calibrate_model", "collect_activations"]


def _generate_random_calibration_data(
    num_samples: int, input_specs: list[InputSpec]
) -> np.ndarray | dict[str, np.ndarray]:
    logger.info("Generating random calibration data as None was provided.")
    rng = np.random.default_rng(0)

    def _random_array(spec: InputSpec) -> np.ndarray:
        shape = (num_samples, *spec.shape)
        dtype = np.dtype(spec.dtype)
        if np.issubdtype(dtype, np.integer):
            return rng.integers(0, 100, size=shape, dtype=dtype)
        return rng.standard_normal(size=shape).astype(dtype)

    if len(input_specs) == 1:
        return _random_array(input_specs[0])
    return {spec.name: _random_array(spec) for spec in input_specs}


def _prepare_calibration_data(
    calibration_data: np.ndarray, batch_size: int, num_samples: int
) -> np.ndarray:
    """Split into full batches, dropping excess samples."""
    total = calibration_data.shape[0]
    num_samples = min(num_samples, total)
    calibration_data = calibration_data[:num_samples]
    if batch_size >= num_samples:
        return calibration_data.reshape((1, num_samples, *calibration_data.shape[1:]))
    num_batches = num_samples // batch_size
    calibration_data = calibration_data[: num_batches * batch_size]
    return calibration_data.reshape((num_batches, batch_size, *calibration_data.shape[1:]))


def _params_device(params) -> torch.device:
    leaves = []
    tree_map(leaves.append, params)
    for leaf in leaves:
        for t in (leaf, getattr(leaf, "data", None)):
            if isinstance(t, torch.Tensor):
                return t.device
    raise ValueError("calibration needs params with at least one tensor")


def _resolve_device(backend: torch.device | None, params) -> torch.device:
    device = backend if backend is not None else _params_device(params)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Calibration device '{device}' is not available (no CUDA device found); "
            "pass calibration_params=CalibrationParams(backend='cpu') to calibrate on the CPU."
        )
    return device


def _feed(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch as a tensor: integer inputs (token ids) as int64 indices."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if not t.is_floating_point():
        t = t.to(torch.int64)
    return t.to(device)


@torch.no_grad()
def collect_activations(
    model: Module,
    params,
    plan: QuantPlan,
    calibration_data,
    num_samples: int,
    batch_size: int,
    backend: torch.device | None,
    tap_inputs: bool,
    tap_outputs: bool,
) -> list[dict[str, dict[str, torch.Tensor]]]:
    """Run batched calibration forwards; return per-batch tap dictionaries
    (tensors on the calibration device)."""
    model.finalize()
    input_specs = model.input_specs
    if calibration_data is None:
        if input_specs is None:
            raise ValueError(
                "Model declares no input_specs; pass calibration_data explicitly "
                "or set Module.input_specs for random-data calibration."
            )
        calibration_data = _generate_random_calibration_data(num_samples, input_specs)

    if input_specs is not None and len(input_specs) > 1:
        if not isinstance(calibration_data, dict):
            raise ValueError(
                "Calibration data must be a dict mapping input names to arrays "
                "for multi-input models."
            )

    if not isinstance(calibration_data, dict):
        first = input_specs[0].name if input_specs else "input"
        calibration_data = {first: calibration_data}

    input_order = [s.name for s in input_specs] if input_specs else list(calibration_data)
    batched = {
        name: _prepare_calibration_data(np.asarray(data), batch_size, num_samples)
        for name, data in calibration_data.items()
    }
    num_batches = len(next(iter(batched.values())))

    device = _resolve_device(backend, params)
    params = tree_map(lambda t: t if t is None else t.to(device), params)
    tap_names = {entry.name for entry in plan}
    activations = []
    for i in range(num_batches):
        ctx = Context(taps={}, tap_inputs=tap_inputs, tap_outputs=tap_outputs,
                      tap_names=tap_names)
        model(params, *(_feed(batched[name][i], device) for name in input_order), ctx=ctx)
        activations.append(ctx.taps)
    return activations


def _set_entry_qparams(
    plan: QuantPlan,
    activations: list[dict[str, dict[str, torch.Tensor]]],
    calibrator: Calibrator,
    qargs: QActivationArgs,
    kind: str,  # "input" | "output"
) -> None:
    for batch in activations:
        for site_name, taps in batch.items():
            if kind in taps:
                calibrator.collect(f"{site_name}::{kind}", taps[kind])

    for entry in plan:
        key = f"{entry.name}::{kind}"
        if key not in calibrator.data:
            continue
        rmin, rmax = calibrator.compute_range(key)
        scale, zp = compute_qparams(rmin, rmax, qargs.dtype, qargs.symmetric,
                                    qargs.reduce_range)
        setattr(entry, f"{kind}_scale", scale)
        setattr(entry, f"{kind}_zero_point", zp)


def calibrate_model(model: Module, params, plan: QuantPlan, qconfig: QConfig) -> None:
    """Calibrate: fill the plan entries' static activation qparams."""
    calibrate_inputs = (
        qconfig.input_activations is not None and qconfig.input_activations.is_static
    )
    calibrate_outputs = (
        qconfig.output_activations is not None and qconfig.output_activations.is_static
    )
    if not (calibrate_inputs or calibrate_outputs):
        return

    cp = qconfig.calibration_params
    activations = collect_activations(
        model, params, plan, qconfig.calibration_data,
        num_samples=cp.num_samples, batch_size=cp.batch_size, backend=cp.backend,
        tap_inputs=calibrate_inputs, tap_outputs=calibrate_outputs,
    )
    calibrator = get_calibrator(cp.method, momentum=cp.momentum)
    if calibrate_inputs:
        _set_entry_qparams(plan, activations, calibrator, qconfig.input_activations, "input")
    if calibrate_outputs:
        _set_entry_qparams(plan, activations, calibrator, qconfig.output_activations, "output")
