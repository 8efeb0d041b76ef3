"""The Llama family on the port's shared decoder, held to the JAX package.

Counterpart of ``tests/models/test_llama.py`` without its HF-import cases
(``load_llama_hf`` waits with ``models/import_hf.py``, ROADMAP.md Queue A
item 11) and without the continuous-batching scheduler (item 9): the port's
engine runs the quantized family through ``generate`` instead. The same numpy
inputs and JAX's own params (bridged with ``from_jax_params``) go through both
packages. Tolerances: float32 logits within 1e-5 abs (both sum in float32 in
another order), quantized codes equal, greedy tokens equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models import llama as jllama
from onnx_quantize_tpu.nn.layers import RMSNorm as JRMSNorm
from onnx_quantize_tpu.nn.layers import apply_rope as japply_rope
from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models import llama
from onnx_quantize_tpu_torch.nn.layers import RMSNorm, apply_rope
from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor

CFG_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
              num_kv_heads=1, head_dim=16)


def _models(**kw):
    cfg = dict(CFG_KW, **kw)
    return llama.Llama(llama.tiny_llama_config(**cfg)), jllama.Llama(
        jllama.tiny_llama_config(**cfg))


def _logits(model, params, ids):
    return model(params, torch.from_numpy(np.asarray(ids)).long()).numpy()


def test_llama_config_conventions():
    cfg = llama.llama_config(vocab_size=100, hidden_size=64, intermediate_size=128,
                             num_layers=2, num_heads=4, num_kv_heads=2)
    assert not cfg.use_qk_norm and not cfg.sandwich_norms
    assert cfg.mlp_activation == "silu" and not cfg.scale_embeddings
    assert not cfg.rms_one_plus
    assert cfg.head_dim == 16  # derived hidden/num_heads
    assert cfg.query_pre_attn_scalar == 16.0  # 1/sqrt(head_dim)
    assert all(cfg.is_global_layer(i) for i in range(cfg.num_layers))


@pytest.mark.parametrize("name", ["LLAMA32_1B", "LLAMA32_3B", "QWEN25_05B"])
def test_published_configs_equal_jax(name):
    ours = dataclasses.asdict(getattr(llama, name))
    theirs = dataclasses.asdict(getattr(jllama, name))
    # Every field, the MoE switches (at their dense defaults) included.
    assert ours == theirs
    assert ours["num_experts"] == 0 and ours["shared_expert_size"] == 0


def test_param_tree_has_no_gemma_only_modules():
    model, jmodel = _models()
    params = model.init(torch.Generator().manual_seed(0))
    attn = params["layers.0"]["attn"]
    assert "q_norm" not in attn and "k_norm" not in attn
    assert "post_attn_norm" not in params["layers.0"]
    assert "post_ffn_norm" not in params["layers.0"]
    assert torch.all(params["layers.0"]["input_norm"]["w"] == 1.0)
    jparams = jmodel.init(jax.random.key(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(params) == shapes(jparams)


@pytest.mark.parametrize("kw", [{}, dict(rope_scaling=(8.0, 1.0, 4.0, 64)),
                                dict(attn_bias=True, tie_lm_head=False)],
                         ids=["plain", "llama3-rope", "qwen-bias-untied"])
def test_logits_match_jax(kw):
    """Plain-w RMSNorm, pre-norm residuals, SiLU, GQA, llama3 rope scaling, q/k/v
    biases and an untied head at once, on JAX's params."""
    model, jmodel = _models(**kw)
    jparams = jmodel.init(jax.random.key(1))
    if kw.get("attn_bias"):  # non-zero biases, so the bias path counts
        rng = np.random.default_rng(2)
        for i in range(2):
            for proj in ("q_proj", "k_proj", "v_proj"):
                site = jparams[f"layers.{i}"]["attn"][proj]
                site["b"] = (0.5 * rng.standard_normal(site["b"].shape)).astype(np.float32)
    ids = np.array([[3, 17, 91, 4, 4, 55, 18, 2, 77, 30]], np.int32)
    ref = np.asarray(jmodel(jparams, ids))
    ours = _logits(model, from_jax_params(jparams, device="cpu"), ids)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scaling", [None, (32.0, 1.0, 4.0, 8192), (8.0, 1.0, 4.0, 64)])
def test_rope_scaling_matches_jax(scaling):
    """llama3 frequency scaling, in float32 as in JAX: within 2e-6 of JAX's
    rotated values at positions up to 4095 (the angles are float32 products)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 64)).astype(np.int32)
    ref = np.asarray(japply_rope(x, pos, 500_000.0, scaling=scaling))
    ours = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0, scaling=scaling)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-6, rtol=0)


def test_llama_rmsnorm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    ours = RMSNorm(32, 1e-5, one_plus=False)
    assert torch.all(ours.init(torch.Generator())["w"] == 1.0)
    ref = JRMSNorm(32, 1e-5, one_plus=False)({"w": w}, x)
    np.testing.assert_allclose(ours({"w": torch.from_numpy(w)}, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=1e-6, rtol=0)


def test_load_llama_hf_waits_for_import_hf(tmp_path):
    """The loader reads through ``models/import_hf.py`` (ported): a directory
    with no shard raises the JAX loader's error (``tests/test_torch_llama_hf.py``
    holds it to HF's logits)."""
    with pytest.raises(FileNotFoundError, match="No .safetensors"):
        llama.load_llama_hf(llama.Llama(llama.tiny_llama_config()), str(tmp_path), device="cpu")


def test_quantized_llama_serves_through_the_engine():
    """W4 quantization and the int8-KV engine run the family unchanged: codes
    equal to JAX's, greedy tokens equal to JAX's engine."""
    model, jmodel = _models()
    jparams = jmodel.init(jax.random.key(0))
    qc = dict(weights=dict(dtype="uint4", group_size=16))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(**qc["weights"])))
    q, _ = oqt.quantize(model, from_jax_params(jparams, device="cpu"), oqt.QConfig(
        weights=oqt.QWeightArgs(**qc["weights"])))
    assert isinstance(q["layers.0"]["attn"]["q_proj"]["w"], QTensor)
    for path in (("layers.0", "attn", "q_proj"), ("layers.1", "mlp", "down_proj"),
                 ("lm_head",)):
        ours, theirs = q, jq
        for key in path:
            ours, theirs = ours[key], theirs[key]
        np.testing.assert_array_equal(ours["w"].data.numpy(), np.asarray(theirs["w"].data))
    prompts = [[5, 9, 17], [3, 2, 77, 8]]
    want = JEngine(jmodel, jq, max_batch=2, max_seq=48, kv_quant=True).generate(
        prompts, max_new_tokens=8)
    got = InferenceEngine(model, q, max_batch=2, max_seq=48, kv_quant=True).generate(
        prompts, max_new_tokens=8)
    assert [list(map(int, g)) for g in got] == [list(map(int, w)) for w in want]


def test_quantized_output_close_to_fp():
    model, jmodel = _models()
    jparams = jmodel.init(jax.random.key(1))
    params = from_jax_params(jparams, device="cpu")
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1)))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="int8", group_size=-1)))
    ids = np.arange(1, 9, dtype=np.int32).reshape(1, 8)
    fp = _logits(model, params, ids)
    q = _logits(model, qparams, ids)
    rel = np.abs(q - fp).max() / (np.abs(fp).max() + 1e-9)
    assert rel < 0.05, rel
    np.testing.assert_allclose(q, np.asarray(jmodel(jq, ids)), atol=1e-5, rtol=0)


def test_qwen_quantizes_as_gemm_sites():
    """Biased q/k/v are "Gemm" sites: weight and bias quantization apply, with
    the bias codes of the JAX package."""
    cfg_kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                  num_heads=2, num_kv_heads=1, attn_bias=True)
    model = llama.Llama(llama.llama_config(**cfg_kw))
    jmodel = jllama.Llama(jllama.llama_config(**cfg_kw))
    sites = {s.name: s.op_type for s in model.linear_sites()}
    assert sites["layers.0.attn.q_proj"] == "Gemm"
    assert sites["layers.0.attn.o_proj"] == "MatMul"
    jparams = jmodel.init(jax.random.key(0))
    site = jparams["layers.0"]["attn"]["q_proj"]
    site["b"] = (0.1 * np.random.default_rng(5).standard_normal(site["b"].shape)).astype(
        np.float32)
    params = from_jax_params(jparams, device="cpu")
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1)))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="int8", group_size=-1)))
    b = qparams["layers.0"]["attn"]["q_proj"]["b"]
    assert isinstance(b, QBias)
    np.testing.assert_array_equal(
        b.data.numpy(), np.asarray(jq["layers.0"]["attn"]["q_proj"]["b"].data))
    ids = np.arange(1, 7, dtype=np.int32).reshape(1, 6)
    fp = _logits(model, params, ids)
    q = _logits(model, qparams, ids)
    assert np.abs(q - fp).max() / (np.abs(fp).max() + 1e-9) < 0.05


def test_untied_head_is_its_own_leaf():
    model = llama.Llama(llama.tiny_llama_config(tie_lm_head=False))
    params = model.init(torch.Generator().manual_seed(0))
    head, emb = params["lm_head"]["w"], params["embed"]["w"]
    assert head.untyped_storage().data_ptr() != emb.untyped_storage().data_ptr()
    assert head.shape == (64, 256)
