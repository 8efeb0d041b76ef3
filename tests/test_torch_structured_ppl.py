"""Absolute perplexity pins on the structured-weight Gemma-3, on the port.

Counterpart of ``tests/integration/test_structured_ppl.py`` on the port
alone: the structured model (``models/structured.py``, the JAX package's
seeded numpy draws) quantized by the port's algorithms and scored by its
``perplexity_from_tokens`` (windows of 1024, stride 512, over 3072 Zipf
tokens), held to the JAX file's frozen float and per-configuration pins at
its ``ATOL`` 0.75 (``tests/integration/test_structured_ppl.py:30-68``), and
the pins' own ordering (``:92-100``).

GPTQ is the one algorithm whose codes depend on the last bits of a float32
Cholesky factorization, which differ between the two frameworks (0.5% of
the codes, ``tests/test_torch_gptq.py``); on this model the port's own GPTQ
scores 1282.5 against JAX's 1286.0. So the GPTQ pin is held twice: JAX's
GPTQ tree, bridged, scored by the port's model within ``ATOL`` of the pin,
and the port's own GPTQ tree no worse than the pin (within ``ATOL``) and
better than the HQQ pin, the ordering the pins encode.
"""

import pytest

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.structured import STRUCTURED_GEMMA3 as JSTRUCTURED_GEMMA3
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.structured import STRUCTURED_GEMMA3, zipf_tokens
from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

ATOL = 0.75  # tests/integration/test_structured_ppl.py:30
FP32_PPL = 1272.083  # :32

# (name, QConfig keyword factory, pin): :36-68; the lm_head is ignored throughout.
PINS = [
    ("rtn_int8_channel", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1)), 1262.499),
    ("rtn_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128)), 1353.948),
    ("hqq_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", strategy="group", group_size=128,
                                algorithm=oqt.HqqConfig())), 1315.895),
    ("gptq_uint4_g128", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128, algorithm=oqt.GPTQConfig()),
        calibration_data=calib), 1285.962),
    ("awq_int8_channel", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8"), preprocessors=[oqt.AwqConfig()],
        calibration_data=calib), 1293.503),
    ("smoothquant_w8a8_static", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", symmetric=True),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        preprocessors=[oqt.SmoothQuantConfig()], calibration_data=calib), 1258.890),
    ("qlinear_w8a8_static", lambda calib: dict(
        weights=oqt.QWeightArgs(dtype="int8", symmetric=True),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        output_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        format="qlinear", calibration_data=calib), 1255.325),
]
PINS_BY_NAME = {name: pin for name, _, pin in PINS}


@pytest.fixture(scope="module")
def structured():
    model, params = STRUCTURED_GEMMA3(device="cpu")
    tokens = zipf_tokens(3072, 2048)
    calib = zipf_tokens(2048, 2048, seed=13).reshape(8, 256)
    return model, params, tokens, calib


def ppl(model, params, tokens) -> float:
    return perplexity_from_tokens(model, params, tokens, max_length=1024, stride=512)


def test_fp32_baseline_ppl(structured):
    model, params, tokens, _ = structured
    assert ppl(model, params, tokens) == pytest.approx(FP32_PPL, abs=ATOL)


@pytest.mark.parametrize("name, cfg, pin", PINS, ids=[p[0] for p in PINS])
def test_pinned_ppl(structured, name, cfg, pin):
    model, params, tokens, calib = structured
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(**cfg(calib), ignore=["lm_head"]))
    got = ppl(model, qparams, tokens)
    if name == "gptq_uint4_g128":
        assert PINS_BY_NAME["hqq_uint4_g128"] > got <= pin + ATOL, f"{name}: ppl {got:.3f}"
        jmodel, jparams = JSTRUCTURED_GEMMA3()
        jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="uint4", group_size=128, algorithm=joqt.GPTQConfig()),
            calibration_data=calib, ignore=["lm_head"]))
        got = ppl(model, from_jax_params(jq, device="cpu"), tokens)
    assert got == pytest.approx(pin, abs=ATOL), f"{name}: ppl {got:.3f}, pin {pin:.3f}"


def test_pin_relationships():
    """The frozen values encode the algorithms' ordering at uint4."""
    assert PINS_BY_NAME["gptq_uint4_g128"] < PINS_BY_NAME["hqq_uint4_g128"]
    assert PINS_BY_NAME["hqq_uint4_g128"] < PINS_BY_NAME["rtn_uint4_g128"]
    assert abs(PINS_BY_NAME["gptq_uint4_g128"] - FP32_PPL) < 15
    assert abs(PINS_BY_NAME["rtn_uint4_g128"] - FP32_PPL) > 50
