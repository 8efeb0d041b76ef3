"""The port's Llama and Qwen-2 HF import against transformers and the JAX package.

Counterpart of the import tests of ``tests/models/test_llama.py``: a
random-init HF ``LlamaForCausalLM`` (with and without llama3 rope scaling,
tied and untied head) and ``Qwen2ForCausalLM`` (random q/k/v biases) saved
with ``save_pretrained`` and read back by ``load_llama_hf``: the tree equals
the JAX loader's leaf for leaf, bit for bit, and the port's logits equal HF's
within the JAX file's tolerances (2e-4 Llama, 3e-4 Qwen;
``tests/models/test_llama.py:103,169``) with the same argmax.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.llama import llama_config as jllama_config
from onnx_quantize_tpu.models.llama import load_llama_hf as jload_llama_hf
from onnx_quantize_tpu_torch.models.llama import Llama, llama_config, load_llama_hf
from .torch_helpers import assert_trees_equal

tfm = pytest.importorskip("transformers")
pytest.importorskip("safetensors.numpy")

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, head_dim=16, rope_theta=10_000.0)
IDS = torch.tensor([[3, 17, 91, 4, 4, 55, 18, 2, 77, 30]])


def roundtrip(tmp_path, hf_model, kw, atol):
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    with torch.no_grad():
        ref = hf_model(IDS).logits.float().numpy()
    model = Llama(llama_config(**kw))
    params = load_llama_hf(model, str(tmp_path / "hf"), device="cpu")
    assert_trees_equal(params, jload_llama_hf(JGemma3(jllama_config(**kw)), str(tmp_path / "hf")))
    with torch.no_grad():
        ours = model(params, IDS).numpy()
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=atol)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    return params


@pytest.mark.parametrize("rope_scaling, tied", [(None, True), ((8.0, 1.0, 4.0, 64), True),
                                                (None, False)],
                         ids=["plain", "llama3_scaling", "untied"])
def test_llama_import_reproduces_hf_logits(tmp_path, rope_scaling, tied):
    kw = dict(TINY, rope_scaling=rope_scaling, tie_lm_head=tied)
    rs = None
    if rope_scaling is not None:
        factor, low, high, orig = rope_scaling
        rs = {"rope_type": "llama3", "factor": factor, "low_freq_factor": low,
              "high_freq_factor": high, "original_max_position_embeddings": orig}
    hf_cfg = tfm.LlamaConfig(
        vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
        intermediate_size=kw["intermediate_size"], num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_heads"], num_key_value_heads=kw["num_kv_heads"],
        head_dim=kw["head_dim"], rope_theta=kw["rope_theta"], rope_scaling=rs,
        rms_norm_eps=1e-5, tie_word_embeddings=tied, attention_dropout=0.0,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    hf_model = tfm.LlamaForCausalLM(hf_cfg).eval().to(torch.float32)
    params = roundtrip(tmp_path, hf_model, kw, 2e-4)
    head, emb = params["lm_head"]["w"], params["embed"]["w"]
    assert (head.data_ptr() == emb.data_ptr()) == tied
    assert "b" not in params["layers.0"]["attn"]["q_proj"]


def test_qwen_import_reproduces_hf_logits(tmp_path):
    kw = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
              num_kv_heads=1, rope_theta=1_000_000.0, rms_norm_eps=1e-6, attn_bias=True)
    hf_cfg = tfm.Qwen2Config(
        vocab_size=kw["vocab_size"], hidden_size=kw["hidden_size"],
        intermediate_size=kw["intermediate_size"], num_hidden_layers=kw["num_layers"],
        num_attention_heads=kw["num_heads"], num_key_value_heads=kw["num_kv_heads"],
        rope_theta=kw["rope_theta"], rms_norm_eps=kw["rms_norm_eps"], tie_word_embeddings=True,
        attention_dropout=0.0)
    torch.manual_seed(2)
    hf_model = tfm.Qwen2ForCausalLM(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():  # random biases (init is zeros), so the bias path counts
        for layer in hf_model.model.layers:
            for p in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj):
                p.bias.normal_(0.0, 0.5)
    params = roundtrip(tmp_path, hf_model, kw, 3e-4)
    assert params["layers.0"]["attn"]["q_proj"]["b"].abs().max() > 0
