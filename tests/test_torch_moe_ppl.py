"""The MoE family's absolute perplexity pins, on the port.

Counterpart of ``tests/integration/test_moe_ppl.py``: the structured-weight
MoE decoder of its config (``tests/integration/test_moe_ppl.py:26-40``),
built by the port's ``structured_params`` (the same seeded numpy draws as
the JAX package's), scored on the CPU by the port's
``perplexity_from_tokens`` and held to JAX's frozen pins at JAX's ATOL
(0.75 ppl). Every expert quantizes against only its routed tokens, so drift
in the routing, the masked experts or the engine layouts moves these numbers.
Both engine layouts keep the quantized tree's perplexity within 0.25 (JAX's
bar: layout is execution strategy, not numerics).
"""

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.moe import fuse_moe_experts, moe_config, stack_moe_experts
from onnx_quantize_tpu_torch.models.structured import structured_params, zipf_tokens
from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

torch.set_num_threads(2)

ATOL = 0.75

CFG = moe_config(
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=256,
    shared_expert_size=0, norm_topk_prob=True,
    vocab_size=2048, hidden_size=256, intermediate_size=256, num_layers=4,
    num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10_000.0,
)

FP32_PPL = 2026.619
PINS = [
    ("rtn_uint4_g64", dict(weights=oqt.QWeightArgs(dtype="uint4", group_size=64)), 2101.383),
    ("rtn_int8_channel", dict(weights=oqt.QWeightArgs(dtype="int8", group_size=-1)), 2025.312),
]


@pytest.fixture(scope="module")
def setup():
    model = Gemma3(CFG)
    params = structured_params(model, seed=7, device="cpu")
    tokens = zipf_tokens(768, CFG.vocab_size, seed=11)
    return model, params, tokens


def _ppl(model, params, tokens):
    return perplexity_from_tokens(model, params, tokens, max_length=256, stride=128)


def test_fp32_pin(setup):
    model, params, tokens = setup
    assert abs(_ppl(model, params, tokens) - FP32_PPL) < ATOL


@pytest.mark.parametrize("name,kw,pin", PINS, ids=[p[0] for p in PINS])
def test_quantized_pins(setup, name, kw, pin):
    model, params, tokens = setup
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(ignore=["lm_head", r"\.router$"],
                                                         **kw))
    got = _ppl(model, qparams, tokens)
    assert abs(got - pin) < ATOL, f"{name}: ppl {got} vs pin {pin}"


@pytest.mark.parametrize("layout", [stack_moe_experts, fuse_moe_experts],
                         ids=["stacked", "fused"])
def test_engine_layouts_preserve_ppl(setup, layout):
    model, params, tokens = setup
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head", r"\.router$"]))
    base = _ppl(model, qparams, tokens)
    tree = layout(fuse_gemma3_projections(qparams))
    assert any(k in tree["layers.0"]["mlp"] for k in ("_stacked_experts", "_fused_experts"))
    got = _ppl(model, tree, tokens)
    assert abs(got - base) < 0.25, f"{layout.__name__}: {got} vs {base}"
    assert abs(got - PINS[0][2]) < ATOL
