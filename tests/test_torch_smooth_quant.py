"""SmoothQuant in the port against the JAX package, on the same numpy params
and calibration inputs (the JAX helpers' two-site models, bridged).

Tolerances: the prescale, the scaled weight and the smoothed captured inputs
within 1e-6 relative (numpy's float32 power against the port's float64
power rounded to float32: a last-bit difference at most). The pass leaves
the float output within 5e-5; after quantize(), the codes are equal and the
outputs within 1e-5 of the largest.
"""

import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.calibration import calibrate_model as jax_calibrate
from onnx_quantize_tpu.plan import build_plan as jax_build_plan
from onnx_quantize_tpu.plan import stamp_qconfig as jax_stamp
from onnx_quantize_tpu_torch.calibration import calibrate_model
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.plan import build_plan, stamp_qconfig

from .helpers import GemmModel as JGemmModel
from .helpers import TwoMatMul as JTwoMatMul
from .torch_helpers import TwoMatMul

torch.set_num_threads(1)

RTOL = 1e-6


def _config(pkg, x, alpha, qlinear=False):
    act = pkg.QActivationArgs(dtype="uint8")
    if qlinear:
        return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                           input_activations=act, output_activations=act, format="qlinear",
                           preprocessors=[pkg.SmoothQuantConfig(alpha=alpha)],
                           calibration_data=x)
    return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8"), input_activations=act,
                       preprocessors=[pkg.SmoothQuantConfig(alpha=alpha)], calibration_data=x)


def _models(bias):
    return (JGemmModel() if bias else JTwoMatMul()), TwoMatMul(bias=bias)


def _inputs(rng):
    x = rng.standard_normal((16, 16)).astype(np.float32)
    x[:, 2] *= 20.0  # an outlier channel for SmoothQuant to migrate
    x[:, 5] = 0.0  # a dead channel: its activation scale clamps to 1e-5
    return x


@pytest.mark.parametrize("alpha", [0.5, 0.8])
@pytest.mark.parametrize("bias", [False, True])
def test_smooth_quant_matches_jax(bias, alpha):
    rng = np.random.default_rng(11)
    jmodel, tmodel = _models(bias)
    jp = jmodel.random_params(rng)
    tp = from_jax_params(jp, device="cpu")
    x = _inputs(rng)
    y0 = tmodel(tp, torch.from_numpy(x))
    plans = []
    for pkg, model, params, (build, calibrate, stamp) in (
            (joqt, jmodel, jp, (jax_build_plan, jax_calibrate, jax_stamp)),
            (toqt, tmodel, tp, (build_plan, calibrate_model, stamp_qconfig))):
        qc = _config(pkg, x, alpha)
        plan = build(model.linear_sites(), qc)
        calibrate(model, params, plan, qc)
        stamp(plan, qc)
        assert qc.preprocessors[0].build_pass(qc)(model, params, plan, qc)
        plans.append(plan)
    jplan, tplan = plans
    for name in ("fc1", "fc2"):
        assert tp[name]["w"].dtype == torch.float32 and tp[name]["prescale"].dtype == torch.float32
        np.testing.assert_allclose(tp[name]["prescale"].numpy(), np.asarray(jp[name]["prescale"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(tp[name]["w"].numpy(), np.asarray(jp[name]["w"]), rtol=RTOL)
        np.testing.assert_allclose(tplan[name].captured_input.numpy(),
                                   np.asarray(jplan[name].captured_input), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tmodel(tp, torch.from_numpy(x)).numpy(), y0.numpy(), atol=5e-5)


@pytest.mark.parametrize("qlinear", [False, True])
def test_smooth_quant_quantize_end_to_end_matches_jax(qlinear):
    """quantize() with SmoothQuant (calibrate, stamp, the pass, re-calibrate
    the static ranges in the smoothed basis, RTN) in both packages."""
    rng = np.random.default_rng(12)
    jmodel, tmodel = _models(bias=True)
    jp = jmodel.random_params(rng)
    x = _inputs(rng)
    jq, jplan = joqt.quantize(jmodel, jp, _config(joqt, x, 0.5, qlinear))
    tq, tplan = toqt.quantize(tmodel, from_jax_params(jp, device="cpu"),
                              _config(toqt, x, 0.5, qlinear))
    for name in ("fc1", "fc2"):
        np.testing.assert_array_equal(tq[name]["w"].data.numpy(), np.asarray(jq[name]["w"].data))
        np.testing.assert_allclose(tplan[name].input_scale.numpy(),
                                   np.asarray(jplan[name].input_scale), rtol=1e-5)
        assert "prescale" in tq[name]
    want = np.asarray(jmodel(jq, x))
    got = tmodel(tq, torch.from_numpy(x)).numpy()
    # Static uint8 codes of fc2's input may move by one step at a .5 tie.
    step = np.abs(want).max() / 255 * 4
    assert np.abs(got - want).max() <= step
    assert np.median(np.abs(got - want)) <= 1e-5 * np.abs(want).max()
