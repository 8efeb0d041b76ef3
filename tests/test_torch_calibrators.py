"""The histogram calibrators (percentile, entropy) and the captured inputs of
``calibrate_model`` in the port, against the JAX package on the same numpy
activations.

Tolerances: histogram counts exact, and so the ranges (the same float64
edges read from equal counts) and the calibrated integer zero points. The
captured inputs: exact for a site fed by the model input, within 1e-5
relative past a float32 matmul (the two frameworks sum in other orders).
"""

import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.calibration import calibrate_model as jax_calibrate
from onnx_quantize_tpu.calibration.entropy import EntropyCalibrator as JEntropy
from onnx_quantize_tpu.calibration.percentile import PercentileCalibrator as JPercentile
from onnx_quantize_tpu.plan import build_plan as jax_build_plan
from onnx_quantize_tpu_torch.calibration import (
    EntropyCalibrator,
    PercentileCalibrator,
    calibrate_model,
    get_calibrator,
)
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.plan import build_plan

from .helpers import TwoMatMul as JTwoMatMul
from .torch_helpers import TwoMatMul

torch.set_num_threads(1)


def _batches(kind):
    """Activation batches: the first sets the histogram's range, later ones
    fall outside it (a rebuild on each side), or stay inside."""
    rng = np.random.default_rng(4)
    if kind == "grow":
        scales, shifts = (1.0, 3.0, 0.5, 8.0), (0.0, 1.0, -2.0, 0.0)
    elif kind == "inside":
        scales, shifts = (4.0, 1.0, 1.0), (0.0, 0.0, 0.5)
    else:  # "positive": post-ReLU-like, no negative values
        return [np.abs(rng.standard_normal((64, 32))).astype(np.float32) * s
                for s in (1.0, 2.5, 0.3)]
    out = []
    for s, b in zip(scales, shifts):
        x = (s * rng.standard_normal((64, 32)) + b).astype(np.float32)
        x[0, 0] = 40.0 * s  # an outlier the clip cuts
        out.append(x)
    return out


def _feed(jcal, tcal, batches):
    for b in batches:
        jcal.collect("a", b)
        tcal.collect("a", torch.from_numpy(b))


@pytest.mark.parametrize("kind", ["grow", "inside", "positive"])
@pytest.mark.parametrize("pct", [0.999, 0.99, 1.0])
def test_percentile_counts_and_range_equal_jax(kind, pct):
    jcal, tcal = JPercentile(percentile=pct), PercentileCalibrator(percentile=pct)
    _feed(jcal, tcal, _batches(kind))
    jh = jcal._hists["a"]
    np.testing.assert_array_equal(tcal.counts("a").numpy(), jh.counts)
    assert tcal._hists["a"].lo == jh.lo and tcal._hists["a"].hi == jh.hi
    (jlo, jhi), (tlo, thi) = jcal.compute_range("a"), tcal.compute_range("a")
    assert tlo.dtype == torch.float32
    assert (tlo.item(), thi.item()) == (float(jlo), float(jhi))


@pytest.mark.parametrize("kind", ["grow", "inside", "positive"])
def test_entropy_counts_and_range_equal_jax(kind):
    jcal, tcal = JEntropy(), EntropyCalibrator()
    _feed(jcal, tcal, _batches(kind))
    jh = jcal._hists["a"]
    np.testing.assert_array_equal(tcal.counts("a").numpy(), jh.counts)
    assert tcal._hists["a"].hi == jh.hi and tcal._hists["a"].has_neg == jh.has_neg
    (jlo, jhi), (tlo, thi) = jcal.compute_range("a"), tcal.compute_range("a")
    assert (tlo.item(), thi.item()) == (float(jlo), float(jhi))
    assert thi.item() < float(np.abs(np.concatenate(_batches(kind))).max())  # it clips


def test_calibrators_refuse_like_jax():
    for cal in (JPercentile(), PercentileCalibrator(), JEntropy(), EntropyCalibrator()):
        with pytest.raises(KeyError):
            cal.compute_range("missing")
    for ctor in (JPercentile, PercentileCalibrator):
        with pytest.raises(AssertionError):
            ctor(percentile=0.0)
    for ctor in (JEntropy, EntropyCalibrator):
        with pytest.raises(AssertionError):
            ctor(bins=64, num_quantized_bins=128)
    assert isinstance(get_calibrator("percentile", percentile=0.9), PercentileCalibrator)
    assert get_calibrator("percentile", percentile=0.9).percentile == 0.9
    assert isinstance(get_calibrator("entropy"), EntropyCalibrator)


def _static_calibration(pkg, model, params, build, calibrate, x, method, **cp):
    qc = pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8"),
                     input_activations=pkg.QActivationArgs(dtype="uint8"),
                     output_activations=pkg.QActivationArgs(dtype="uint8"),
                     calibration_data=x,
                     calibration_params=dict(method=method, num_samples=64, batch_size=16, **cp))
    plan = build(model.linear_sites(), qc)
    calibrate(model, params, plan, qc)
    return plan


@pytest.mark.parametrize("method,cp", [("percentile", dict(percentile=0.99)),
                                       ("entropy", dict())])
def test_calibrate_model_histogram_methods_match_jax(method, cp):
    """calibrate_model with the percentile (its ``percentile=`` argument
    reaching the calibrator) and entropy methods: fc1's input is the model
    input, so its qparams are equal; past a matmul the ranges may move a
    value across a bin edge, so those scales agree within 1e-5."""
    rng = np.random.default_rng(8)
    jmodel = JTwoMatMul()
    jp = jmodel.random_params(rng)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    x[3, 4] = 25.0
    jplan = _static_calibration(joqt, jmodel, jp, jax_build_plan, jax_calibrate, x, method, **cp)
    tplan = _static_calibration(toqt, TwoMatMul(), from_jax_params(jp, device="cpu"), build_plan,
                                calibrate_model, x, method, **cp)
    je, te = jplan["fc1"], tplan["fc1"]
    assert te.input_scale.item() == float(np.asarray(je.input_scale))
    assert te.input_zero_point.item() == int(np.asarray(je.input_zero_point))
    for name in ("fc1", "fc2"):
        je, te = jplan[name], tplan[name]
        np.testing.assert_allclose(te.output_scale.item(), float(np.asarray(je.output_scale)),
                                   rtol=1e-5)


# (weight args, pre-passes, static input): which configs capture raw inputs.
CAPTURE_CASES = [
    (dict(dtype="int8", group_size=-1, algorithm="gptq"), False, False, True),
    (dict(dtype="uint4", group_size=8), True, False, True),
    (dict(dtype="int8"), False, True, False),
    (dict(dtype="uint4", group_size=8), False, False, False),
]


@pytest.mark.parametrize("wargs,prepass,static,captures", CAPTURE_CASES)
def test_calibrate_model_captured_input_matches_jax(wargs, prepass, static, captures):
    """The triggers (the algorithm's and the pre-pass's
    ``requires_calibration``) and the captured inputs: float32, (samples,
    in_features), fc1's equal to the calibration data, fc2's to JAX's."""
    rng = np.random.default_rng(9)
    jmodel = JTwoMatMul()
    jp = jmodel.random_params(rng)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    plans = []
    for pkg, model, params, build, calibrate in (
            (joqt, jmodel, jp, jax_build_plan, jax_calibrate),
            (toqt, TwoMatMul(), from_jax_params(jp, device="cpu"), build_plan, calibrate_model)):
        w = dict(wargs)
        if w.get("algorithm") == "gptq":
            w["algorithm"] = pkg.GPTQConfig()
        qc = pkg.QConfig(
            weights=pkg.QWeightArgs(**w), calibration_data=x,
            preprocessors=[pkg.AwqConfig()] if prepass else [],
            input_activations=pkg.QActivationArgs(dtype="uint8") if static else None,
            calibration_params=dict(num_samples=20, batch_size=8))
        plan = build(model.linear_sites(), qc)
        calibrate(model, params, plan, qc)
        plans.append(plan)
    jplan, tplan = plans
    for name in ("fc1", "fc2"):
        te, je = tplan[name], jplan[name]
        if not captures:
            assert te.captured_input is None and je.captured_input is None
            continue
        assert te.captured_input.dtype == torch.float32
        assert te.captured_input.shape == np.asarray(je.captured_input).shape
        np.testing.assert_allclose(te.captured_input.numpy(), np.asarray(je.captured_input),
                                   rtol=1e-5, atol=1e-6)
    if captures:
        np.testing.assert_array_equal(tplan["fc1"].captured_input.numpy(), x[:16])
