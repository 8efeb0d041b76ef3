"""The PyTorch port's Gemma-3 against the JAX package's on bridged weights:
logits of the float and the quantized model, fused and unfused, agree."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jax_fuse
from onnx_quantize_tpu.models.gemma3 import make_attention_mask as jax_mask
from onnx_quantize_tpu.nn.layers import apply_rope as jax_rope
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.gemma3 import make_attention_mask
from onnx_quantize_tpu_torch.nn.layers import apply_rope
from onnx_quantize_tpu_torch.utils import tree_map

torch.set_num_threads(1)

# Every path of the slice at a small width: 5 groups of 64 padded to 6 on the
# K=320 sites, a global third layer, GQA (2 query heads on 1 KV head), and a
# sliding window shorter than the prompts.
TINY = dict(hidden_size=320, intermediate_size=512, num_layers=3, sliding_pattern=3,
            num_heads=2, num_kv_heads=1, head_dim=64, sliding_window=8, vocab_size=512)
BODY = dict(dtype="uint4", group_size=64)
HEAD = dict(dtype="int8", group_size=-1, symmetric=True)
# Float32 everywhere: the two frameworks differ in summation order and in
# float32 transcendentals only; 1e-5 of the largest logit bounds that.
REL_TOL = 1e-5


def _quantize_jax(model, params):
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(**BODY), ignore=["lm_head"]))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(**HEAD), ignore=[r"^layers\."]))
    return params


@pytest.fixture(scope="module")
def models():
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    return jmodel, tmodel, params, _quantize_jax(jmodel, params)


def _ids(B=2, T=12, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, T)).astype(np.int32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())


@pytest.mark.parametrize("quantized,fused", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_logits_match_jax(models, quantized, fused):
    jmodel, tmodel, params, qparams = models
    jp = qparams if quantized else params
    if fused:
        jp = jax_fuse(jp)
    tp = from_jax_params(jp, device="cpu")
    if fused:
        assert "_fused_qkv" in tp["layers.0"]["attn"]
        assert "_fused_gate_up" in tp["layers.0"]["mlp"]
    ids = _ids()
    want = jmodel(jp, ids)
    got = tmodel(tp, torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, TINY["vocab_size"])
    _close(got.numpy(), want)


def test_port_quantizes_and_fuses_like_jax(models):
    """The port's own quantize + fuse on bridged float weights gives the JAX
    package's logits (its codes are bit-equal, see test_torch_numerics)."""
    import onnx_quantize_tpu_torch as pt

    jmodel, tmodel, params, qparams = models
    tp = from_jax_params(params, device="cpu")
    tp, _ = pt.quantize(tmodel, tp, pt.QConfig(weights=pt.QWeightArgs(**BODY),
                                               ignore=["lm_head"]))
    tp, _ = pt.quantize(tmodel, tp, pt.QConfig(weights=pt.QWeightArgs(**HEAD),
                                               ignore=[r"^layers\."]))
    ids = _ids(seed=1)
    want = jmodel(jax_fuse(qparams), ids)
    _close(tmodel(fuse_gemma3_projections(tp), torch.from_numpy(ids).long()).numpy(), want)


def test_bf16_stream_stays_bf16(models):
    """A bf16 model keeps its residual stream and logits in bf16 through the
    quantized sites, within bf16 rounding (2^-8 relative per op, over three
    layers: 5% of the largest logit) of the float32 model."""
    _, tmodel, _, qparams = models
    tp = fuse_gemma3_projections(from_jax_params(qparams, device="cpu"))
    bf_model = Gemma3(dataclasses.replace(tmodel.cfg, dtype="bfloat16"))
    bf_params = tree_map(
        lambda t: t.to(torch.bfloat16) if isinstance(t, torch.Tensor) else t, tp)
    ids = torch.from_numpy(_ids()).long()
    out = bf_model(bf_params, ids)
    ref = tmodel(tp, ids)
    assert out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert (out.float() - ref).abs().max().item() <= 0.05 * ref.abs().max().item()


def test_init_shapes_and_tied_head():
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    tp = tmodel.init(torch.Generator().manual_seed(0))
    jp = jmodel.init(jax.random.key(0))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    assert shapes(tp) == shapes(jp)
    assert tp["lm_head"]["w"].data_ptr() == tp["embed"]["w"].data_ptr()
    assert [s.name for s in tmodel.linear_sites()] == [s.name for s in jmodel.linear_sites()]
    w = tp["layers.0"]["attn"]["q_proj"]["w"]
    assert float(w.abs().max()) <= 0.25 + 1e-6  # truncated at 2.5 sigma, sigma 0.1


def test_rope_and_mask_match():
    cfg_j, cfg_t = JGemma3Config.tiny(**TINY), Gemma3Config.tiny(**TINY)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 2, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
           jax_rope(x, pos, 10_000.0))
    kv = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    for is_global in (False, True):
        np.testing.assert_array_equal(
            make_attention_mask(cfg_t, torch.from_numpy(pos), torch.from_numpy(kv),
                                is_global).numpy(),
            np.asarray(jax_mask(cfg_j, pos, kv, is_global)))
