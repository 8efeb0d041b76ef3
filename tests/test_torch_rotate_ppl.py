"""QuaRot's perplexity recovery on the structured-weight Llama, in the port.

Counterpart of ``tests/integration/test_rotate_ppl.py``: the llama-convention
decoder with structured weights (input-channel outliers that blow up
per-channel int4 scales), scored over the 2048-token Zipf stream of the JAX
pins (windows of 256, stride 128): fp 1965.2, int4-channel 2017.5, rotate +
int4-channel 1968.0. The port's structured params are built from the same
seeded numpy draws, so its three ppl must match those pins within 0.1 (the
pins' rounding plus the float32 summation order) and JAX's own values within
1e-4 relative; the rotation must recover at least 70% of the int4 gap, as the
JAX pin asks.
"""

import numpy as np
import pytest

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.llama import tiny_llama_config as jtiny_llama_config
from onnx_quantize_tpu.models.structured import structured_params as jstructured_params
from onnx_quantize_tpu.tools.perplexity import perplexity_from_tokens as jppl
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.models.structured import structured_params, zipf_tokens
from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

CFG = dict(vocab_size=2048, hidden_size=256, intermediate_size=1024, num_layers=4, num_heads=4,
           num_kv_heads=1, head_dim=64)
PINS = {"fp": 1965.2, "int4": 2017.5, "rotate": 1968.0}  # tests/integration/test_rotate_ppl.py:7-9
PIN_ATOL = 0.1
JAX_RTOL = 1e-4


@pytest.fixture(scope="module")
def structured_llama():
    model = Gemma3(tiny_llama_config(**CFG))
    params = structured_params(model, device="cpu")
    tokens = zipf_tokens(2048, 2048)
    qc = dict(weights=oqt.QWeightArgs(dtype="int4", group_size=-1), ignore=["lm_head"])
    trees = {"fp": params,
             "int4": oqt.quantize(model, params, oqt.QConfig(**qc))[0],
             "rotate": oqt.quantize(model, params, oqt.QConfig(
                 preprocessors=[oqt.RotateConfig(seed=3)], **qc))[0]}
    ppl = {k: perplexity_from_tokens(model, p, tokens, max_length=256, stride=128)
           for k, p in trees.items()}
    return model, params, tokens, ppl


def test_structured_params_equal_jax(structured_llama):
    model, params, _, _ = structured_llama
    jparams = jstructured_params(JGemma3(jtiny_llama_config(**CFG)))
    for path in (("embed",), ("lm_head",), ("final_norm",), ("layers.2", "attn", "k_proj"),
                 ("layers.3", "mlp", "down_proj"), ("layers.0", "input_norm")):
        ours, theirs = params, jparams
        for key in path:
            ours, theirs = ours[key], theirs[key]
        np.testing.assert_array_equal(ours["w"].numpy(), np.asarray(theirs["w"]))


def test_rotation_recovers_int4_channel_ppl(structured_llama):
    """Per-channel int4 is where outlier rows hurt most; the rotation must
    recover at least 70% of the gap."""
    _, _, _, ppl = structured_llama
    for key, pin in PINS.items():
        assert abs(ppl[key] - pin) < PIN_ATOL, (key, ppl[key], pin)
    gap_plain = ppl["int4"] - ppl["fp"]
    gap_rot = ppl["rotate"] - ppl["fp"]
    assert gap_plain > 10.0
    assert abs(gap_rot) < 0.3 * gap_plain, (gap_rot, gap_plain)


def test_ppl_equal_jax(structured_llama):
    """The JAX package on the same stream: each ppl within 1e-4 relative."""
    _, _, tokens, ppl = structured_llama
    jmodel = JGemma3(jtiny_llama_config(**CFG))
    jparams = jstructured_params(jmodel)
    qc = dict(weights=joqt.QWeightArgs(dtype="int4", group_size=-1), ignore=["lm_head"])
    jtrees = {"fp": jparams,
              "int4": joqt.quantize(jmodel, jparams, joqt.QConfig(**qc))[0],
              "rotate": joqt.quantize(jmodel, jparams, joqt.QConfig(
                  preprocessors=[joqt.RotateConfig(seed=3)], **qc))[0]}
    for key, tree in jtrees.items():
        want = jppl(jmodel, tree, tokens, max_length=256, stride=128)
        assert ppl[key] == pytest.approx(want, rel=JAX_RTOL), key
