"""The attention kernels' paths through the port's model and engine, against
the port's own dense paths and the JAX package: ``Gemma3.use_flash`` (the
flash-attention branch of the no-cache forward) and the engine's
``fused_attention`` (flash decode over the int8 cache), plus the int4 KV
cache's packing and codes. On CPU tensors the kernels' plain versions run."""

import jax
import numpy as np
import pytest
import torch

from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.engine.kv_cache import pack_nibbles as jax_pack
from onnx_quantize_tpu.engine.kv_cache import unpack_nibbles as jax_unpack
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.engine.kv_cache import pack_nibbles, unpack_nibbles
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.ops.kernels import flash_attention, flash_decode

torch.set_num_threads(1)

# head_dim and max_seq 128-tileable, as the fused decode path requires; a
# global second layer and a window shorter than the sequences.
TINY128 = dict(hidden_size=64, num_heads=2, num_kv_heads=1, head_dim=128, sliding_window=16,
               sliding_pattern=2)
# Float32 stream: the two packages, and the dense and blockwise attention,
# differ in summation order and float32 exp only: 1e-5 of the largest logit.
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def tiny128():
    jmodel = JGemma3(JGemma3Config.tiny(**TINY128))
    jparams = jmodel.init(jax.random.key(0))
    return (jmodel, jparams, Gemma3(Gemma3Config.tiny(**TINY128)),
            from_jax_params(jparams, device="cpu"))


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("T", [32, 48])
def test_use_flash_matches_dense_and_jax(tiny128, T):
    """use_flash=True takes the blockwise branch (its plain version on CPU)
    and matches the port's einsum path and the JAX model's flash path."""
    jmodel, jparams, tmodel, tparams = tiny128
    ids = np.random.default_rng(T).integers(0, 256, (2, T)).astype(np.int32)
    tids = torch.from_numpy(ids).long()
    calls = []
    real = flash_attention.flash_attention
    flash_attention.flash_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        tmodel.use_flash = True
        flash = tmodel(tparams, tids)
    finally:
        flash_attention.flash_attention = real
        tmodel.use_flash = "auto"
    assert len(calls) == tmodel.cfg.num_layers
    tmodel.use_flash = False
    dense = tmodel(tparams, tids)
    tmodel.use_flash = "auto"
    _close(flash.numpy(), dense.numpy())
    jmodel.use_flash = True
    try:
        want = jmodel(jparams, ids)
    finally:
        jmodel.use_flash = "auto"
    _close(flash.numpy(), want)


def test_use_flash_takes_ragged_tiles(tiny128):
    """T = 144 passes the tileable rule (T % 16 == 0) but is no multiple of
    128: the JAX kernel asserts T % min(128, T) == 0 there, the port's
    blockwise path masks the ragged tile and matches its einsum path."""
    _, _, tmodel, tparams = tiny128
    tids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 144)))
    tmodel.use_flash = True
    try:
        flash = tmodel(tparams, tids)
    finally:
        tmodel.use_flash = "auto"
    _close(flash.numpy(), tmodel(tparams, tids).numpy())


def test_flash_dispatch_rule(tiny128):
    """The reference's rule: tileable T and head_dim; "auto" needs T >= 512 on
    the accelerator, so CPU tensors stay on the einsum path."""
    attn = tiny128[2].layers[0].attn
    x = torch.zeros((1, 512, 64))
    assert attn._flash_ok(True, x) and not attn._flash_ok(True, x[:, :500])
    assert not attn._flash_ok(False, x)
    assert not attn._flash_ok("auto", x)  # a CPU tensor


def _decode_run(engine_cls, model, params, fused, steps=4):
    engine = engine_cls(model, params, max_batch=2, max_seq=128, kv_quant=True,
                        fused_attention=fused)
    ids = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    lengths = np.array([4, 2], np.int32)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = np.asarray(np.argmax(np.asarray(logits), -1), np.int32)
    cache, gen = engine.decode_multi(cache, first, steps=steps)
    _, logits_last = engine.decode(cache, np.asarray(gen)[:, -1])
    return np.asarray(gen), np.asarray(logits_last)


def test_fused_decode_matches_unfused_and_jax(tiny128):
    """JAX's own bar (atol 2e-4, rtol 1e-4; tests/engine/test_fused_attention.py)
    between the fused and unfused port, and the fused port against the fused
    JAX engine; greedy tokens equal."""
    jmodel, jparams, tmodel, tparams = tiny128
    calls = []
    real = flash_decode.flash_decode_int8
    flash_decode.flash_decode_int8 = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        gen_fused, logits_fused = _decode_run(InferenceEngine, tmodel, tparams, True)
    finally:
        flash_decode.flash_decode_int8 = real
    # 4 decode steps and the final decode, each one call per layer; the
    # 4-token prefill stays on the scale-folded attend.
    assert len(calls) == 5 * tmodel.cfg.num_layers
    gen_ref, logits_ref = _decode_run(InferenceEngine, tmodel, tparams, False)
    np.testing.assert_array_equal(gen_fused, gen_ref)
    np.testing.assert_allclose(logits_fused, logits_ref, atol=2e-4, rtol=1e-4)
    jgen, jlogits = _decode_run(JEngine, jmodel, jparams, True)
    np.testing.assert_array_equal(gen_fused, jgen)
    np.testing.assert_allclose(logits_fused, jlogits, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(kv_quant=False), dict(kv_quant="int4"),
                                dict(kv_quant=True, max_seq=96)])
def test_fused_attention_validation_matches_jax(tiny128, kw):
    jmodel, jparams, tmodel, tparams = tiny128
    kw = dict(dict(max_batch=2, max_seq=128, fused_attention=True), **kw)
    with pytest.raises(ValueError, match="fused_attention") as theirs:
        JEngine(jmodel, jparams, **kw)
    with pytest.raises(ValueError, match="fused_attention") as ours:
        InferenceEngine(tmodel, tparams, **kw)
    assert str(ours.value) == str(theirs.value)


def test_kv_quant_values(tiny128):
    _, _, tmodel, tparams = tiny128
    for kv, bits in ((False, 8), (None, 8), (True, 8), ("int8", 8), ("int4", 4)):
        eng = InferenceEngine(tmodel, tparams, max_batch=1, max_seq=16, kv_quant=kv)
        assert eng.cache_cfg.quantized == bool(kv) and eng.cache_cfg.bits == bits
        assert not eng._fused_attn
    with pytest.raises(ValueError, match="kv_quant must be"):
        InferenceEngine(tmodel, tparams, kv_quant="int2")


def test_int4_pack_matches_jax_bytes():
    codes = np.random.default_rng(3).integers(-8, 8, (3, 5, 2, 64)).astype(np.int8)
    packed = pack_nibbles(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 5, 2, 32)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(codes)))
    np.testing.assert_array_equal(unpack_nibbles(packed).numpy(), codes)
    np.testing.assert_array_equal(unpack_nibbles(packed).numpy(),
                                  np.asarray(jax_unpack(np.asarray(jax_pack(codes)))))


def test_int4_cache_codes_and_logits_match_jax(tiny128):
    """Prefill and decode over the int4 cache: packed codes within one level
    (a .5 tie may round apart in float32) in at most 0.1% of entries, scales
    within 1e-5, logits and greedy tokens as the JAX engine's."""
    jmodel, jparams, tmodel, tparams = tiny128
    ids = np.random.default_rng(9).integers(0, 256, (2, 24)).astype(np.int32)
    lengths = np.array([24, 19], np.int32)
    jeng = JEngine(jmodel, jparams, max_batch=2, max_seq=32, kv_quant="int4")
    teng = InferenceEngine(tmodel, tparams, max_batch=2, max_seq=32, kv_quant="int4")
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, lengths)
    tcache, tlogits = teng.prefill(teng.new_cache(), ids, lengths)
    _close(tlogits.numpy(), jlogits)
    first = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jcache, jtoks = jeng.decode_multi(jcache, first, 5)
    tcache, ttoks = teng.decode_multi(tcache, first, 5)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert tcache["k"].dtype == torch.uint8 and tcache["k"].shape[-1] == 64
    for key in ("k", "v"):
        diff = np.abs(unpack_nibbles(tcache[key]).numpy().astype(np.int32)
                      - np.asarray(jax_unpack(jcache[key])).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        _close(tcache[key + "_scale"].numpy(), jcache[key + "_scale"])
