"""The port's safetensors reader and Gemma-3 HF import against the JAX package.

Counterpart of ``tests/models/test_import_hf.py``. The reader
(``models/import_hf.py::read_safetensors``) is the port's own: it must equal
``safetensors.numpy.load_file`` on every dtype numpy holds and
``safetensors.torch.load_file`` on BF16, merge shards, skip the
``__metadata__`` key and raise the JAX loader's errors. ``load_gemma3_hf`` on
float32 files must give JAX's tree leaf for leaf, bit for bit (tied and
untied lm_head, the name-prefix fallback), and a tiny HF ``Gemma3ForCausalLM``
saved with ``save_pretrained`` must reproduce HF's logits within the JAX
file's 2e-4 (``tests/models/test_import_hf.py:220``).
"""

import json
import struct

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.import_hf import load_gemma3_hf as jload_gemma3_hf
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf, read_safetensors
from .torch_helpers import assert_trees_equal

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, head_dim=16, sliding_window=8, sliding_pattern=2)
CFG = Gemma3Config.tiny(**TINY)
JCFG = JGemma3Config.tiny(**TINY)


def synthetic_hf_tensors(cfg, rng, prefix="model.", tied=True) -> dict:
    """HF-convention float32 tensors: projections are (out, in)."""
    d, hd = cfg.hidden_size, cfg.head_dim

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tensors = {f"{prefix}embed_tokens.weight": t(cfg.vocab_size, d), f"{prefix}norm.weight": t(d)}
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}"
        tensors.update({
            f"{p}.self_attn.q_proj.weight": t(cfg.num_heads * hd, d),
            f"{p}.self_attn.k_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.v_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.o_proj.weight": t(d, cfg.num_heads * hd),
            f"{p}.self_attn.q_norm.weight": t(hd),
            f"{p}.self_attn.k_norm.weight": t(hd),
            f"{p}.mlp.gate_proj.weight": t(cfg.intermediate_size, d),
            f"{p}.mlp.up_proj.weight": t(cfg.intermediate_size, d),
            f"{p}.mlp.down_proj.weight": t(d, cfg.intermediate_size),
            f"{p}.input_layernorm.weight": t(d),
            f"{p}.post_attention_layernorm.weight": t(d),
            f"{p}.pre_feedforward_layernorm.weight": t(d),
            f"{p}.post_feedforward_layernorm.weight": t(d),
        })
    if not tied:
        tensors["lm_head.weight"] = t(cfg.vocab_size, d)
    return tensors


def save_shards(tensors: dict, directory, shards=1):
    directory.mkdir(parents=True, exist_ok=True)
    names = sorted(tensors)
    per = -(-len(names) // shards)
    for s in range(shards):
        chunk = {k: tensors[k] for k in names[s * per:(s + 1) * per]}
        if chunk:
            safetensors_numpy.save_file(chunk, str(directory / f"model-{s:05d}.safetensors"))


# -- the reader ------------------------------------------------------------------

NUMPY_DTYPES = [np.float32, np.float16, np.int8, np.uint8, np.int16, np.int32, np.int64,
                np.bool_]


def test_reader_equals_safetensors_numpy(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {}
    for i, dt in enumerate(NUMPY_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1,)][i % 4]
        if dt == np.bool_:
            tensors[f"t{i}"] = rng.random(shape) < 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            tensors[f"t{i}"] = rng.integers(info.min, info.max, shape, dtype=dt)
        else:
            tensors[f"t{i}"] = rng.standard_normal(shape).astype(dt)
    tensors["scalar"] = np.array(2.5, np.float32)
    tensors["empty"] = np.zeros((0, 4), np.float32)
    (tmp_path / "d").mkdir()
    path = tmp_path / "d" / "x.safetensors"
    safetensors_numpy.save_file(tensors, str(path), metadata={"format": "np"})
    want = safetensors_numpy.load_file(str(path))
    got = read_safetensors(str(tmp_path / "d"))
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape and got[name].numpy().dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_reader_equals_safetensors_torch_on_bf16(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn((33, 17), generator=gen).to(torch.bfloat16),
               "b": torch.randn((5,), generator=gen).to(torch.bfloat16),
               "i": torch.arange(3, dtype=torch.int8)}
    (tmp_path / "d").mkdir()
    path = tmp_path / "d" / "x.safetensors"
    safetensors_torch.save_file(tensors, str(path))
    want = safetensors_torch.load_file(str(path))
    got = read_safetensors(str(tmp_path / "d"))
    for name, t in want.items():
        assert got[name].dtype == t.dtype
        assert torch.equal(got[name], t), name


def test_reader_copies_a_misaligned_tensor(tmp_path):
    """A tensor whose offset is not a multiple of its element size (here an
    odd-length uint8 tensor first, then float32) is read right."""
    u8 = np.arange(3, dtype=np.uint8)
    f32 = np.array([1.5, -2.25], np.float32)
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]},
              "__metadata__": {"note": "hand-written"}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned, so "b" sits at 3 mod 4
    (tmp_path / "d").mkdir()
    with open(tmp_path / "d" / "x.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + u8.tobytes() + f32.tobytes())
    got = read_safetensors(str(tmp_path / "d"))
    assert set(got) == {"a", "b"}
    np.testing.assert_array_equal(got["a"].numpy(), u8)
    np.testing.assert_array_equal(got["b"].numpy(), f32)


def test_reader_merges_shards_and_raises(tmp_path):
    rng = np.random.default_rng(3)
    tensors = synthetic_hf_tensors(CFG, rng)
    save_shards(tensors, tmp_path / "ckpt", shards=3)
    got = read_safetensors(str(tmp_path / "ckpt"))
    assert set(got) == set(tensors)
    for name, arr in tensors.items():
        np.testing.assert_array_equal(got[name].numpy(), arr)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No .safetensors"):
        read_safetensors(str(tmp_path / "empty"))


# -- load_gemma3_hf against JAX's -------------------------------------------------

@pytest.mark.parametrize("prefix, tied, shards", [("model.", True, 1), ("model.", False, 3),
                                                  ("", True, 2)],
                         ids=["tied", "untied_sharded", "prefix_fallback"])
def test_tree_equals_jax_loader(tmp_path, prefix, tied, shards):
    tensors = synthetic_hf_tensors(CFG, np.random.default_rng(0), prefix=prefix, tied=tied)
    save_shards(tensors, tmp_path / "ckpt", shards=shards)
    ours = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"), device="cpu")
    theirs = jload_gemma3_hf(JGemma3(JCFG), str(tmp_path / "ckpt"))
    assert_trees_equal(ours, theirs)
    head = ours["lm_head"]["w"]
    if tied:
        # A transposed view of the embedding, as Gemma3.init ties it.
        assert head.data_ptr() == ours["embed"]["w"].data_ptr()
    else:
        np.testing.assert_array_equal(head.numpy(), tensors["lm_head.weight"].T)
    ids = torch.tensor([[1, 2, 3]])
    assert torch.isfinite(Gemma3(CFG)(ours, ids)).all()


def test_bf16_load_is_the_rounded_float32(tmp_path):
    tensors = synthetic_hf_tensors(CFG, np.random.default_rng(5))
    save_shards(tensors, tmp_path / "ckpt")
    f32 = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"), device="cpu")
    bf16 = load_gemma3_hf(Gemma3(CFG), str(tmp_path / "ckpt"), dtype=torch.bfloat16,
                          device="cpu")
    for path in (("embed",), ("layers.1", "mlp", "down_proj"), ("layers.0", "attn", "q_norm")):
        a, b = f32, bf16
        for key in path:
            a, b = a[key], b[key]
        assert b["w"].dtype == torch.bfloat16
        assert torch.equal(b["w"], a["w"].to(torch.bfloat16))


def test_import_errors_match_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No .safetensors"):
        load_gemma3_hf(Gemma3(CFG), str(tmp_path / "empty"), device="cpu")
    tensors = synthetic_hf_tensors(CFG, np.random.default_rng(4))
    del tensors["model.layers.1.mlp.up_proj.weight"]
    save_shards(tensors, tmp_path / "missing")
    with pytest.raises(KeyError, match="up_proj"):
        load_gemma3_hf(Gemma3(CFG), str(tmp_path / "missing"), device="cpu")


def test_tied_head_quantize_leaves_embedding_unchanged(tmp_path):
    """The tied lm_head is a view of the embedding: quantizing the head (RTN
    int8, and GPTQ, which updates its weight copy column by column) must not
    write into the embedding."""
    tensors = synthetic_hf_tensors(CFG, np.random.default_rng(6))
    save_shards(tensors, tmp_path / "ckpt")
    model = Gemma3(CFG)
    params = load_gemma3_hf(model, str(tmp_path / "ckpt"), device="cpu")
    before = params["embed"]["w"].clone()
    ids = np.random.default_rng(7).integers(1, CFG.vocab_size, (4, 8))
    for weights, extra in ((oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True), {}),
                           (oqt.QWeightArgs(dtype="uint4", group_size=16,
                                            algorithm=oqt.GPTQConfig()),
                            {"calibration_data": ids})):
        q, _ = oqt.quantize(model, params, oqt.QConfig(weights=weights, **extra))
        assert isinstance(q["lm_head"]["w"], oqt.QTensor)
        assert torch.equal(params["embed"]["w"], before)
        assert torch.equal(q["embed"]["w"], before)


def test_import_reproduces_hf_logits(tmp_path):
    """A random-init HF Gemma3ForCausalLM saved with save_pretrained and read
    back by the port: HF's logits within 2e-4 and the same argmax."""
    tfm = pytest.importorskip("transformers")
    hf_cfg = tfm.Gemma3TextConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        intermediate_size=CFG.intermediate_size, num_hidden_layers=CFG.num_layers,
        num_attention_heads=CFG.num_heads, num_key_value_heads=CFG.num_kv_heads,
        head_dim=CFG.head_dim, rope_theta=CFG.rope_theta, rope_local_base_freq=CFG.rope_local_base,
        sliding_window=CFG.sliding_window, sliding_window_pattern=CFG.sliding_pattern,
        rms_norm_eps=CFG.rms_norm_eps, query_pre_attn_scalar=int(CFG.query_pre_attn_scalar),
        tie_word_embeddings=True, attention_dropout=0.0,
    )
    assert [t == "full_attention" for t in hf_cfg.layer_types] == [
        CFG.is_global_layer(i) for i in range(CFG.num_layers)]
    torch.manual_seed(0)
    hf_model = tfm.Gemma3ForCausalLM(hf_cfg).eval().to(torch.float32)
    hf_model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    ids = torch.tensor([[3, 17, 91, 4, 4, 55, 18, 2, 77, 30]])
    with torch.no_grad():
        ref = hf_model(ids).logits.float().numpy()
    model = Gemma3(CFG)
    params = load_gemma3_hf(model, str(tmp_path / "hf"), device="cpu")
    with torch.no_grad():
        ours = model(params, ids).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
