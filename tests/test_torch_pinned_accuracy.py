"""The port's versions of the JAX package's tiny-Gemma accuracy pins
(``tests/integration/test_pinned_accuracy.py``): the same fixed-seed model
and token set, each config quantized by both packages.

For each config the port quantizes the bridged float params itself, and its
relative output error must stay under the JAX pin and within 2% of the JAX
package's own error (GPTQ's Cholesky factors and the float32 forwards differ
in their last bits between the two). The trees the JAX package quantized
also cross the bridge (``from_jax_params``: QTensors, float zero points,
``prescale`` leaves, static activation qparams) and run through the port's
model: within 1e-4 of the largest logit of the JAX model's output, or, with
static int8 activations, within the tie-flip bound of ``test_torch_w8a8.py``.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

torch.set_num_threads(1)

ERR_RTOL = 0.02
BRIDGE_TOL = 1e-4
FLIP_TOL = 5e-2


@pytest.fixture(scope="module")
def fixed_model():
    jmodel, tmodel = JGemma3(JGemma3Config.tiny()), Gemma3(Gemma3Config.tiny())
    params = jmodel.init(jax.random.key(1234))
    ids = np.random.default_rng(99).integers(1, 250, size=(4, 16)).astype(np.int32)
    tparams = from_jax_params(params, device="cpu")
    jbase = np.asarray(jmodel(params, ids))
    tbase = tmodel(tparams, torch.from_numpy(ids).long()).numpy()
    return jmodel, params, jbase, tmodel, tparams, tbase, ids


def _rel(out, base):
    return float(np.mean(np.abs(out - base)) / np.mean(np.abs(base)))


CALIB = np.random.default_rng(5).integers(1, 250, size=(16, 16)).astype(np.int32)


def _config(pkg, name, ids):
    """The JAX pins' configs, by name, in package ``pkg``."""
    weight_only = {
        "int8_tensor": dict(dtype="int8"),
        "int8_channel": dict(dtype="int8", group_size=-1),
        "uint8_channel": dict(dtype="uint8", group_size=-1),
        "int8_g32": dict(dtype="int8", group_size=32),
        "uint4_g32": dict(dtype="uint4", group_size=32),
        "int4_g32_sym": dict(dtype="int4", group_size=32, symmetric=True),
        "int8_channel_mse": dict(dtype="int8", group_size=-1, mse=True),
        "int4_g32": dict(dtype="int4", group_size=32),
    }
    if name in weight_only:
        return pkg.QConfig(weights=pkg.QWeightArgs(**weight_only[name]), ignore=["lm_head"])
    if name == "hqq_uint4_g32":
        return pkg.QConfig(weights=pkg.QWeightArgs(dtype="uint4", strategy="group", group_size=32,
                                                   algorithm=pkg.HqqConfig()),
                           ignore=["lm_head"])
    if name == "gptq_int4_g32":
        return pkg.QConfig(
            weights=pkg.QWeightArgs(dtype="int4", group_size=32,
                                    algorithm=pkg.GPTQConfig(block_size=32)),
            ignore=["lm_head"], calibration_data=CALIB,
            calibration_params=pkg.CalibrationParams(num_samples=16, batch_size=8))
    if name == "smoothquant_w8a8":
        return pkg.QConfig(
            weights=pkg.QWeightArgs(dtype="int8"),
            input_activations=pkg.QActivationArgs(dtype="uint8"),
            output_activations=pkg.QActivationArgs(dtype="uint8"),
            preprocessors=[pkg.SmoothQuantConfig(alpha=0.5)], calibration_data=ids,
            calibration_params=pkg.CalibrationParams(num_samples=4, batch_size=4),
            ignore=["lm_head"])
    raise KeyError(name)


# (config, pin): the JAX file's pins, the relations' operands with the pins
# of their RTN counterparts.
PINS = [("int8_tensor", 0.020), ("int8_channel", 0.015), ("uint8_channel", 0.015),
        ("int8_g32", 0.017), ("uint4_g32", 0.22), ("int4_g32_sym", 0.30),
        ("int8_channel_mse", 0.015), ("hqq_uint4_g32", 0.22 * 1.1), ("gptq_int4_g32", 0.30),
        ("smoothquant_w8a8", 0.25)]
STATIC = {"smoothquant_w8a8"}


def _errors(fixed_model, name):
    jmodel, params, jbase, tmodel, tparams, tbase, ids = fixed_model
    jq, _ = joqt.quantize(jmodel, params, _config(joqt, name, ids))
    tq, _ = toqt.quantize(tmodel, tparams, _config(toqt, name, ids))
    jout = np.asarray(jmodel(jq, ids))
    tout = tmodel(tq, torch.from_numpy(ids).long()).numpy()
    return _rel(jout, jbase), _rel(tout, tbase), jq, jout


@pytest.mark.parametrize("name,pin", PINS, ids=[p[0] for p in PINS])
def test_port_error_matches_jax_pin(fixed_model, name, pin):
    jerr, terr, jq, jout = _errors(fixed_model, name)
    assert 0 < terr <= pin, f"{name}: port rel err {terr:.4f} exceeded pin {pin}"
    assert abs(terr - jerr) <= ERR_RTOL * jerr, f"{name}: port {terr:.5f} vs JAX {jerr:.5f}"
    # JAX's own quantized tree, bridged, through the port's model.
    _, _, _, tmodel, _, _, ids = fixed_model
    bridged = from_jax_params(jq, device="cpu")
    got = tmodel(bridged, torch.from_numpy(ids).long()).numpy()
    peak = np.abs(jout).max()
    if name in STATIC:
        assert np.abs(got - jout).max() <= FLIP_TOL * peak
        assert np.median(np.abs(got - jout)) <= BRIDGE_TOL * peak
    else:
        np.testing.assert_allclose(got, jout, rtol=0, atol=BRIDGE_TOL * peak)
    if name == "hqq_uint4_g32":
        assert bridged["layers.0"]["attn"]["q_proj"]["w"].meta.float_zero_point
    if name == "smoothquant_w8a8":
        assert bridged["layers.0"]["attn"]["q_proj"]["prescale"].dtype == torch.float32


def test_port_hqq_beats_rtn_uint4(fixed_model):
    _, rtn, _, _ = _errors(fixed_model, "uint4_g32")
    _, hqq, _, _ = _errors(fixed_model, "hqq_uint4_g32")
    assert hqq <= rtn * 1.1


def test_port_gptq_beats_rtn_int4(fixed_model):
    _, rtn, _, _ = _errors(fixed_model, "int4_g32")
    _, gptq, _, _ = _errors(fixed_model, "gptq_int4_g32")
    assert gptq <= rtn
