"""The port's Qwen-MoE and Mixtral HF import against transformers and the JAX package.

Counterpart of ``tests/models/test_moe_hf.py``: a tiny random-init
``Qwen2MoeForCausalLM`` (the ``mlp.gate`` router, a sigmoid-gated shared
expert, q/k/v biases, no top-k renormalization) and ``MixtralForCausalLM``
(``block_sparse_moe`` with ``w1``/``w3``/``w2``) saved with
``save_pretrained`` and read back by ``load_qwen_moe_hf`` and
``load_mixtral_hf``: each tree equals the JAX loader's leaf for leaf, bit for
bit, and the port's logits equal HF's within the JAX file's 3e-4
(``tests/models/test_moe_hf.py:65,109``) with the same argmax.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.models.moe import MoE as JMoE
from onnx_quantize_tpu.models.moe import load_mixtral_hf as jload_mixtral_hf
from onnx_quantize_tpu.models.moe import load_qwen_moe_hf as jload_qwen_moe_hf
from onnx_quantize_tpu.models.moe import moe_config as jmoe_config
from onnx_quantize_tpu_torch.models.moe import MoE, load_mixtral_hf, load_qwen_moe_hf, moe_config
from .torch_helpers import assert_trees_equal

tfm = pytest.importorskip("transformers")
pytest.importorskip("safetensors.numpy")


def roundtrip(tmp_path, hf_model, kw, ids, loader, jloader):
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    with torch.no_grad():
        ref = hf_model(ids).logits.float().numpy()
    model = MoE(moe_config(**kw))
    params = loader(model, str(tmp_path / "hf"), device="cpu")
    assert_trees_equal(params, jloader(JMoE(jmoe_config(**kw)), str(tmp_path / "hf")))
    with torch.no_grad():
        ours = model(params, ids).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=3e-4, rtol=3e-4)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    return params


def test_qwen_moe_import_reproduces_hf_logits(tmp_path):
    kw = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
              shared_expert_size=64, norm_topk_prob=False, vocab_size=128, hidden_size=32,
              intermediate_size=48, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
              rope_theta=10_000.0, rms_norm_eps=1e-6, attn_bias=True, tie_lm_head=False)
    hf_cfg = tfm.Qwen2MoeConfig(
        vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
        intermediate_size=kw["intermediate_size"], num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_heads"], num_key_value_heads=kw["num_kv_heads"],
        num_experts=kw["num_experts"], num_experts_per_tok=kw["num_experts_per_tok"],
        moe_intermediate_size=kw["moe_intermediate_size"],
        shared_expert_intermediate_size=kw["shared_expert_size"],
        norm_topk_prob=kw["norm_topk_prob"], decoder_sparse_step=1, rope_theta=kw["rope_theta"],
        rms_norm_eps=kw["rms_norm_eps"], tie_word_embeddings=False, attention_dropout=0.0,
        output_router_logits=False)
    torch.manual_seed(0)
    hf_model = tfm.Qwen2MoeForCausalLM(hf_cfg).eval().to(torch.float32)
    ids = torch.tensor([[3, 17, 91, 4, 4, 55, 18, 2, 77, 30]])
    params = roundtrip(tmp_path, hf_model, kw, ids, load_qwen_moe_hf, jload_qwen_moe_hf)
    mlp = params["layers.1"]["mlp"]
    assert {"router", "shared", "shared_gate", "experts.3"} <= set(mlp)
    assert mlp["shared_gate"]["w"].shape == (32, 1)


def test_mixtral_import_reproduces_hf_logits(tmp_path):
    kw = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64,
              shared_expert_size=0, norm_topk_prob=True, vocab_size=128, hidden_size=32,
              intermediate_size=64, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
              rope_theta=10_000.0, rms_norm_eps=1e-5, attn_bias=False, tie_lm_head=False)
    hf_cfg = tfm.MixtralConfig(
        vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
        intermediate_size=kw["moe_intermediate_size"], num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_heads"], num_key_value_heads=kw["num_kv_heads"],
        num_local_experts=kw["num_experts"], num_experts_per_tok=kw["num_experts_per_tok"],
        rope_theta=kw["rope_theta"], rms_norm_eps=kw["rms_norm_eps"], tie_word_embeddings=False,
        attention_dropout=0.0, output_router_logits=False, sliding_window=None)
    torch.manual_seed(1)
    hf_model = tfm.MixtralForCausalLM(hf_cfg).eval().to(torch.float32)
    ids = torch.tensor([[5, 9, 3, 3, 100, 42, 7, 68]])
    params = roundtrip(tmp_path, hf_model, kw, ids, load_mixtral_hf, jload_mixtral_hf)
    assert "shared" not in params["layers.0"]["mlp"]
