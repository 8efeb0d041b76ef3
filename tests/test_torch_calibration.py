"""Calibration in the port against the JAX package, on the same numpy inputs:
the cases of ``tests/calibration/test_calibrate.py`` (batching, strict and
EMA minmax, zero in the range, the factory, the random-data fallback,
multi-input and ignored sites) run through both packages, the calibration
knobs' validators, and ``calibrate_model`` on a float32 tiny Gemma-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.calibration import MinMaxCalibrator as JMinMax
from onnx_quantize_tpu.calibration import calibrate_model as jax_calibrate
from onnx_quantize_tpu.calibration import get_calibrator as jax_get_calibrator
from onnx_quantize_tpu.calibration.calibrate import (
    _prepare_calibration_data as jax_prepare,
)
from onnx_quantize_tpu.core.qconfig import CalibrationParams as JCalibrationParams
from onnx_quantize_tpu import nn as jnn
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.nn.module import InputSpec as JInputSpec
from onnx_quantize_tpu.plan import build_plan as jax_build_plan
from onnx_quantize_tpu_torch import nn as tnn
from onnx_quantize_tpu_torch.calibration import MinMaxCalibrator, calibrate_model, get_calibrator
from onnx_quantize_tpu_torch.calibration.calibrate import _prepare_calibration_data
from onnx_quantize_tpu_torch.core.qconfig import CalibrationMethod, CalibrationParams
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.nn.module import InputSpec
from onnx_quantize_tpu_torch.plan import build_plan

from .helpers import GemmModel as JGemmModel
from .helpers import TwoMatMul as JTwoMatMul

torch.set_num_threads(1)

# Float32 forwards in the two frameworks sum in other orders: the calibrated
# ranges, and so the scales, agree to a few float32 ulps (1e-5 relative); a
# zero point, rounded from -rmin / scale, can then move by one code at most.
SCALE_RTOL = 1e-5


class TwoMatMul(tnn.Module):
    """x @ W1 @ W2: two MatMul sites, as the JAX helper."""

    def __init__(self, d_in=16, d_mid=32, d_out=8, bias=False):
        super().__init__()
        self.fc1 = tnn.Linear(d_in, d_mid, use_bias=bias)
        self.fc2 = tnn.Linear(d_mid, d_out, use_bias=bias)
        self.input_specs = [InputSpec("input", (d_in,))]
        self.finalize()

    def forward(self, params, x, ctx=None):
        return self.fc2(params["fc2"], self.fc1(params["fc1"], x, ctx=ctx), ctx=ctx)


class EmbedModel(tnn.Module):
    """An integer-input model: an embedding gather, then one site."""

    def __init__(self):
        super().__init__()
        self.proj = tnn.Linear(8, 4, use_bias=False)
        self.input_specs = [InputSpec("input_ids", (3,), np.int32)]
        self.finalize()

    def forward(self, params, ids, ctx=None):
        return self.proj(params["proj"], params["emb"][ids], ctx=ctx)


class TwoInput(tnn.Module):
    def __init__(self):
        super().__init__()
        self.proj = tnn.Linear(8, 4, use_bias=False)
        self.input_specs = [InputSpec("a", (8,)), InputSpec("b", (8,))]
        self.finalize()

    def forward(self, params, a, b, ctx=None):
        return self.proj(params["proj"], a + b, ctx=ctx)


def _both_params(jmodel, rng):
    """The JAX helper's random params, and the same as torch tensors."""
    jp = jmodel.random_params(rng)
    return jp, from_jax_params(jp, device="cpu")


def _static_config(pkg, **kw):
    return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8"),
                       input_activations=pkg.QActivationArgs(dtype="uint8"), **kw)


def _assert_entries_match(jplan, tplan, kinds=("input",)):
    assert {e.name for e in tplan} == {e.name for e in jplan}
    for je in jplan:
        te = tplan[je.name]
        for kind in kinds:
            js, jz = np.asarray(getattr(je, f"{kind}_scale")), getattr(je, f"{kind}_zero_point")
            ts, tz = getattr(te, f"{kind}_scale"), getattr(te, f"{kind}_zero_point")
            np.testing.assert_allclose(ts.numpy(), js, rtol=SCALE_RTOL, atol=0)
            assert abs(int(tz) - int(np.asarray(jz))) <= 1
            assert tz.dtype == torch.uint8 and np.asarray(jz).dtype == np.uint8


# (data shape, batch_size, num_samples, expected batched shape): JAX's cases.
BATCH_CASES = [((20, 2), 5, 20, (4, 5, 2)), ((23, 2), 5, 23, (4, 5, 2)),
               ((7, 2), 10, 100, (1, 7, 2)), ((8, 2), 16, 8, (1, 8, 2))]


@pytest.mark.parametrize("shape,batch_size,num_samples,want", BATCH_CASES)
def test_batching_matches_jax(shape, batch_size, num_samples, want):
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = _prepare_calibration_data(data, batch_size=batch_size, num_samples=num_samples)
    ref = jax_prepare(data, batch_size=batch_size, num_samples=num_samples)
    assert got.shape == want
    np.testing.assert_array_equal(got, ref)


# (batches fed to "a", momentum): strict minmax, zero forced into the range,
# and EMA smoothing, each on both packages.
MINMAX_CASES = [([[1.0, 5.0], [-2.0, 3.0]], 0.0), ([[2.0, 5.0]], 0.0),
                ([[0.0, 4.0], [0.0, 8.0]], 0.5), ([[-3.0, -1.0], [-0.5, 2.5], [1.0, 9.0]], 0.3)]


@pytest.mark.parametrize("batches,momentum", MINMAX_CASES)
def test_minmax_matches_jax(batches, momentum):
    jc, tc = JMinMax(momentum=momentum), MinMaxCalibrator(momentum=momentum)
    for b in batches:
        arr = np.asarray(b, np.float32)
        jc.collect("a", arr)
        tc.collect("a", torch.from_numpy(arr))
    (jmin, jmax), (tmin, tmax) = jc.compute_range("a"), tc.compute_range("a")
    assert tmin.dtype == torch.float32 and tmin.item() <= 0.0 <= tmax.item()
    np.testing.assert_allclose([tmin.item(), tmax.item()], [jmin, jmax], rtol=1e-7)


def test_minmax_errors_match_jax():
    for cal in (JMinMax(), MinMaxCalibrator()):
        with pytest.raises(KeyError):
            cal.compute_range("missing")
    for cls in (JMinMax, MinMaxCalibrator):
        with pytest.raises(AssertionError):
            cls(momentum=1.5)


def test_factory_matches_jax():
    assert isinstance(get_calibrator(CalibrationMethod.MINMAX), MinMaxCalibrator)
    assert get_calibrator("minmax", momentum=0.5).momentum == 0.5
    assert jax_get_calibrator("minmax", momentum=0.5).momentum == 0.5
    for fn in (get_calibrator, jax_get_calibrator):
        with pytest.raises(ValueError):
            fn("kl-nope")
    # Percentile and entropy exist in the reference and are not ported yet.
    for method in ("percentile", "entropy"):
        assert jax_get_calibrator(method) is not None
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_calibrator(method)


# CalibrationParams keyword sets: the reference's validators decide each.
PARAM_CASES = [dict(), dict(method="minmax", num_samples=8, batch_size=4, momentum=0.25),
               dict(method="percentile", percentile=0.99), dict(method="nope"),
               dict(momentum=1.0), dict(momentum=-0.1), dict(percentile=0.0),
               dict(percentile=1.5), dict(num_samples=0), dict(batch_size=-1),
               dict(backend="cpu"), dict(backend="not-a-device")]


def _param_outcome(cls, kwargs):
    try:
        p = cls(**kwargs)
    except ValueError:  # pydantic's ValidationError is a ValueError
        return "ValueError"
    method = p.method if isinstance(p.method, str) else p.method.value
    return (method, p.num_samples, p.batch_size, p.momentum, p.percentile)


@pytest.mark.parametrize("kwargs", PARAM_CASES,
                         ids=lambda k: "-".join(map(str, k.values())) or "default")
def test_calibration_params_validate_like_jax(kwargs):
    assert _param_outcome(CalibrationParams, kwargs) == _param_outcome(JCalibrationParams, kwargs)


def test_backend_is_a_torch_device():
    """The reference's backend is a JAX platform (default CPU); the port's is
    a torch device, by default the params' device."""
    assert CalibrationParams().backend is None
    assert CalibrationParams(backend="cpu").backend == torch.device("cpu")
    assert CalibrationParams(backend="gpu").backend == torch.device("cuda")
    assert CalibrationParams(backend="default").backend == torch.device("cuda")
    assert CalibrationParams(backend=torch.device("cuda", 1)).backend.index == 1


def test_absent_device_raises_without_fallback(rng, monkeypatch):
    """The reference warns and falls back to the CPU; the port raises."""
    model = TwoMatMul()
    _, tp = _both_params(JTwoMatMul(), rng)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    qc = _static_config(toqt, calibration_data=x,
                        calibration_params=CalibrationParams(backend="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        calibrate_model(model, tp, build_plan(model.linear_sites(), qc), qc)


def test_static_input_qparams_match_jax(rng):
    jmodel, model = JTwoMatMul(), TwoMatMul()
    jp, tp = _both_params(jmodel, rng)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    jqc, tqc = _static_config(joqt, calibration_data=x), _static_config(toqt, calibration_data=x)
    jplan, tplan = jax_build_plan(jmodel.linear_sites(), jqc), build_plan(model.linear_sites(),
                                                                          tqc)
    jax_calibrate(jmodel, jp, jplan, jqc)
    calibrate_model(model, tp, tplan, tqc)
    for entry in tplan:
        assert entry.input_scale is not None and entry.output_scale is None
    _assert_entries_match(jplan, tplan)


def test_static_outputs_and_minibatches_match_jax(rng):
    """Inputs and outputs, over four batches of three (two samples dropped),
    with EMA momentum."""
    jmodel, model = JGemmModel(), TwoMatMul(bias=True)
    jp, tp = _both_params(jmodel, rng)
    x = rng.standard_normal((14, 16)).astype(np.float32)

    def config(pkg, params_cls):
        act = pkg.QActivationArgs(dtype="uint8")
        return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8"), input_activations=act,
                           output_activations=act, calibration_data=x,
                           calibration_params=params_cls(num_samples=14, batch_size=3,
                                                         momentum=0.5))

    jqc, tqc = config(joqt, JCalibrationParams), config(toqt, CalibrationParams)
    jplan, tplan = jax_build_plan(jmodel.linear_sites(), jqc), build_plan(model.linear_sites(),
                                                                          tqc)
    jax_calibrate(jmodel, jp, jplan, jqc)
    calibrate_model(model, tp, tplan, tqc)
    _assert_entries_match(jplan, tplan, kinds=("input", "output"))


def test_random_fallback_matches_jax(rng):
    """No data: both draw the same numpy default_rng(0) samples from the
    model's input specs."""
    jmodel, model = JTwoMatMul(), TwoMatMul()
    jp, tp = _both_params(jmodel, rng)
    jqc = _static_config(joqt, calibration_params=JCalibrationParams(num_samples=8,
                                                                    batch_size=4))
    tqc = _static_config(toqt, calibration_params=CalibrationParams(num_samples=8, batch_size=4))
    jplan, tplan = jax_build_plan(jmodel.linear_sites(), jqc), build_plan(model.linear_sites(),
                                                                          tqc)
    jax_calibrate(jmodel, jp, jplan, jqc)
    calibrate_model(model, tp, tplan, tqc)
    _assert_entries_match(jplan, tplan)


def test_random_fallback_without_specs_raises(rng):
    model = TwoMatMul()
    model.input_specs = None
    _, tp = _both_params(JTwoMatMul(), rng)
    qc = _static_config(toqt)
    with pytest.raises(ValueError, match="input_specs"):
        calibrate_model(model, tp, build_plan(model.linear_sites(), qc), qc)


class JEmbedModel(jnn.Module):
    """The JAX test's integer-input model."""

    def __init__(self):
        super().__init__()
        self.proj = jnn.Linear(8, 4, use_bias=False)
        self.input_specs = [JInputSpec("input_ids", (3,), np.int32)]
        self.finalize()

    def __call__(self, params, ids, ctx=None):
        return self.proj(params["proj"], params["emb"][ids], ctx=ctx)


def test_int_input_random_data_matches_jax(rng):
    """Integer inputs get token-id-range random data (the same numpy draws
    in both packages), fed as indices."""
    jmodel, model = JEmbedModel(), EmbedModel()
    jp = {"emb": jnp.asarray(rng.standard_normal((100, 8)).astype(np.float32)),
          "proj": {"w": jnp.asarray(rng.standard_normal((8, 4)).astype(np.float32))}}
    jqc = _static_config(joqt, calibration_params=JCalibrationParams(num_samples=6,
                                                                    batch_size=3))
    tqc = _static_config(toqt, calibration_params=CalibrationParams(num_samples=6, batch_size=3))
    jplan, tplan = jax_build_plan(jmodel.linear_sites(), jqc), build_plan(model.linear_sites(),
                                                                          tqc)
    jax_calibrate(jmodel, jp, jplan, jqc)
    calibrate_model(model, from_jax_params(jp, device="cpu"), tplan, tqc)
    assert tplan["proj"].input_scale is not None
    _assert_entries_match(jplan, tplan)


def test_multi_input_requires_dict(rng):
    model = TwoInput()
    params = {"proj": {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))}}
    qc = _static_config(toqt, calibration_data=np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="dict"):
        calibrate_model(model, params, build_plan(model.linear_sites(), qc), qc)
    qc2 = _static_config(toqt, calibration_data={
        "a": rng.standard_normal((4, 8)).astype(np.float32),
        "b": rng.standard_normal((4, 8)).astype(np.float32)})
    plan2 = build_plan(model.linear_sites(), qc2)
    calibrate_model(model, params, plan2, qc2)
    assert plan2["proj"].input_scale is not None


def test_ignored_sites_not_calibrated_like_jax(rng):
    jmodel, model = JTwoMatMul(), TwoMatMul()
    jp, tp = _both_params(jmodel, rng)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    jqc = _static_config(joqt, ignore=["fc2"], calibration_data=x)
    tqc = _static_config(toqt, ignore=["fc2"], calibration_data=x)
    jplan, tplan = jax_build_plan(jmodel.linear_sites(), jqc), build_plan(model.linear_sites(),
                                                                          tqc)
    jax_calibrate(jmodel, jp, jplan, jqc)
    calibrate_model(model, tp, tplan, tqc)
    assert "fc2" not in tplan and tplan["fc1"].input_scale is not None
    _assert_entries_match(jplan, tplan)


TINY = dict(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
            head_dim=64, vocab_size=512)


def test_calibrate_tiny_gemma3_matches_jax():
    """The QLINEAR configuration on a float32 tiny Gemma-3: every site's
    input and output qparams from the port's forward agree with JAX's."""
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    model = Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    ids = np.random.default_rng(7).integers(1, TINY["vocab_size"], (8, 16)).astype(np.int32)

    def config(pkg):
        act = pkg.QActivationArgs(dtype="uint8", is_static=True)
        return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                           input_activations=act, output_activations=act, format="qlinear",
                           calibration_data=ids, ignore=["lm_head"])

    jqc, tqc = config(joqt), config(toqt)
    jplan = jax_build_plan(jmodel.linear_sites(), jqc)
    tplan = build_plan(model.linear_sites(), tqc)
    assert len(tplan) == 7 * TINY["num_layers"]
    jax_calibrate(jmodel, params, jplan, jqc)
    calibrate_model(model, from_jax_params(params, device="cpu"), tplan, tqc)
    _assert_entries_match(jplan, tplan, kinds=("input", "output"))
    # The taps read the unfused sites of the model's own forward.
    assert tplan["layers.1.mlp.down_proj"].input_scale.item() > 0
    assert jnp.asarray(jplan["layers.1.mlp.down_proj"].input_scale) > 0
