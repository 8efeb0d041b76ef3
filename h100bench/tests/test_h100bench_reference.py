"""The plain reference agrees with the port's plain path at a tiny MoE
configuration on the CPU: the same RTN codes, the same logits through the
int8 KV cache (float32 stream) at Qwen1.5-MoE's and Mixtral's structure,
and served-token gaps that read zero for the reference's own greedy
tokens."""

import copy

import numpy as np
import pytest
import torch

from h100bench.benchlib import program, weights
from h100bench.reference import judge, rtn
from h100bench.reference.model import Reference
from h100bench.tests.tiny import TINY

SEED = 2**31 + 77


# Qwen1.5-MoE's structure, and Mixtral's: GQA, no biases (q/k/v fuse), no
# shared expert, the top-k renormalized.
SHAPES = {"qwen": {}, "mixtral": {"num_attention_heads": 4, "num_key_value_heads": 2,
                                  "shared_expert_intermediate_size": 0, "qkv_bias": False,
                                  "norm_topk_prob": True}}


def _f32(shape: str = "qwen"):
    cfg = copy.deepcopy(TINY)
    cfg.update(SHAPES[shape], torch_dtype="float32")
    return cfg


def test_rtn_codes_equal_the_port_quantizer():
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.ops.reference import dequantize_weight

    cfg = _f32()
    built = program.build_program(cfg, SEED, "cpu")
    leaves = weights.layer_leaves(weights.Shapes(cfg), SEED, 1, "cpu", torch.float32)
    # The shared expert's down_proj is left unfused by the layouts.
    got = dequantize_weight(built.tree["layers.1"]["mlp"]["shared"]["down_proj"]["w"])
    want = rtn.dequant_uint4_group(leaves["w"]["mlp.shared.down_proj"], 32)
    assert torch.equal(got.to(torch.float32), want)
    head = weights.lm_head_weight(weights.Shapes(cfg), SEED, "cpu", torch.float32)
    got = dequantize_weight(built.tree["lm_head"]["w"])
    assert torch.equal(got.to(torch.float32), rtn.dequant_int8_channel(head))
    assert isinstance(oqt.QConfig, type)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_reference_logits_match_the_port_through_the_int8_cache(shape):
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    cfg = _f32(shape)
    built = program.build_program(cfg, SEED, "cpu")
    eng = InferenceEngine(built.model, built.tree, max_batch=1, max_seq=128, kv_quant=True)
    ids = np.random.default_rng(1).integers(0, 256, 33)
    _, logits = eng.prefill(eng.new_cache(), ids[None], np.array([33], np.int32))
    ref = Reference(cfg, SEED, "cpu")
    want = ref.logits(ref.final_hidden([ids.tolist()])[0][-1:], ref.lm_head())[0]
    assert (logits[0].to(torch.float32) - want).abs().max() <= 1e-4 * want.abs().max()


def test_served_gaps_read_zero_for_the_references_own_tokens():
    cfg = copy.deepcopy(TINY)
    ref = Reference(cfg, SEED, "cpu")
    prompt = np.random.default_rng(2).integers(0, 256, 20).tolist()
    served = []
    head = ref.lm_head()
    for _ in range(6):  # the reference's own greedy continuation
        h = ref.final_hidden([prompt + served])[0][-1:]
        served.append(int(ref.logits(h, head).argmax()))
    got = judge.served_gaps(cfg, SEED, "cpu", [(prompt, served)])
    assert got["max_gap"] == 0.0 and got["argmax_share"] == 1.0 and got["tokens"] == 6
    wrong = served[:3] + [(served[3] + 1) % 256] + served[4:]
    assert judge.served_gaps(cfg, SEED, "cpu", [(prompt, wrong)])["max_gap"] > 0.0
