"""The PyTorch port's inference engine against the JAX package's on bridged
quantized weights: prefill logits, greedy decode tokens, cache lengths and
int8 KV codes agree, including ragged prompts longer than the sliding
window, an inactive slot, a masked re-prefill, and sequences at capacity."""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jax_fuse
from onnx_quantize_tpu_torch.engine import InferenceEngine, SamplingParams, sample
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

torch.set_num_threads(1)

TINY = dict(hidden_size=320, intermediate_size=512, num_layers=3, sliding_pattern=3,
            num_heads=2, num_kv_heads=1, head_dim=64, sliding_window=8, vocab_size=512)
B, S = 4, 32
LENGTHS = np.array([12, 9, 15, 1], np.int32)  # slot 3 stays inactive
ACTIVE = np.array([True, True, True, False])
STEPS = 8
# Float32 stream: the frameworks differ in summation order only; 1e-5 of the
# largest logit bounds that.
REL_TOL = 1e-5


def _close(got, want, rows=slice(None)):
    want = np.asarray(want)[rows]
    np.testing.assert_allclose(np.asarray(got)[rows], want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    params = jax_fuse(params)
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    rng = np.random.default_rng(0)
    ids = np.zeros((B, int(LENGTHS.max())), np.int32)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(0, TINY["vocab_size"], n)
    return jmodel, params, tmodel, from_jax_params(params), ids


@pytest.fixture(scope="module")
def served(setup):
    """Prefill (slot 3 masked out) then 8 greedy steps, in both packages."""
    jmodel, jparams, tmodel, tparams, ids = setup
    jeng = JEngine(jmodel, jparams, max_batch=B, max_seq=S, kv_quant=True)
    teng = InferenceEngine(tmodel, tparams, max_batch=B, max_seq=S, kv_quant=True)
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, LENGTHS, slot_mask=ACTIVE)
    tcache, tlogits = teng.prefill(teng.new_cache(), ids, LENGTHS, slot_mask=ACTIVE)
    prefill = (np.asarray(jlogits), tlogits.numpy())
    first = np.argmax(prefill[0], -1).astype(np.int32)
    jcache, jtoks = jeng.decode_multi(jcache, first, STEPS, active=ACTIVE)
    tcache, ttoks = teng.decode_multi(tcache, first, STEPS, active=ACTIVE)
    return dict(jeng=jeng, teng=teng, prefill=prefill, jcache=jcache, tcache=tcache,
                toks=(np.asarray(jtoks), ttoks.numpy()))


def test_prefill_logits_match(served):
    jlogits, tlogits = served["prefill"]
    _close(tlogits, jlogits, rows=ACTIVE)


def test_greedy_decode_tokens_and_lengths_match(served):
    jtoks, ttoks = served["toks"]
    assert ttoks.shape == (B, STEPS)
    np.testing.assert_array_equal(ttoks[ACTIVE], jtoks[ACTIVE])
    np.testing.assert_array_equal(served["tcache"]["lengths"].numpy(),
                                  np.asarray(served["jcache"]["lengths"]))
    np.testing.assert_array_equal(served["tcache"]["lengths"].numpy(),
                                  np.where(ACTIVE, LENGTHS + STEPS, 0))


def test_int8_kv_codes_match(served):
    """Codes may differ by one where a float32 rounding lands on a .5 tie:
    at most 1 apart, in at most 0.1% of entries; scales within 1e-5."""
    jc, tc = served["jcache"], served["tcache"]
    for key in ("k", "v"):
        diff = np.abs(tc[key].numpy().astype(np.int32) - np.asarray(jc[key]).astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3
        _close(tc[key + "_scale"].numpy(), jc[key + "_scale"])


def test_masked_prefill_keeps_other_slots(setup, served):
    """Re-prefilling slot 3 alone leaves slots 0-2 as they were, as the JAX
    engine's slot-mask merge does."""
    _, _, _, _, ids = setup
    jeng, teng = served["jeng"], served["teng"]
    tcache = {k: v.clone() for k, v in served["tcache"].items()}
    jcache = {k: jax.numpy.array(v, copy=True) for k, v in served["jcache"].items()}  # donated
    before = {k: v.clone() for k, v in tcache.items()}
    only3 = np.array([False, False, False, True])
    lengths = np.array([12, 9, 15, 6], np.int32)
    jcache, jlogits = jeng.prefill(jcache, ids, lengths, slot_mask=only3)
    tcache, tlogits = teng.prefill(tcache, ids, lengths, slot_mask=only3)
    for key, buf in tcache.items():
        if key == "lengths":
            continue
        assert torch.equal(buf[:, :3], before[key][:, :3])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [20, 17, 23, 6])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    _close(tlogits.numpy(), jlogits, rows=only3)
    diff = np.abs(tcache["k"][:, 3].numpy().astype(int) - np.asarray(jcache["k"])[:, 3])
    assert diff.max() <= 1


def test_fp_cache_and_capacity_match(setup):
    """Float cache; prompts that reach max_seq mid-decode stop advancing."""
    jmodel, jparams, tmodel, tparams, _ = setup
    max_seq = 16
    jeng = JEngine(jmodel, jparams, max_batch=2, max_seq=max_seq)
    teng = InferenceEngine(tmodel, tparams, max_batch=2, max_seq=max_seq)
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 14)).astype(np.int32)
    lengths = np.array([14, 10], np.int32)
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, lengths)
    tcache, tlogits = teng.prefill(teng.new_cache(), ids, lengths)
    _close(tlogits.numpy(), jlogits)
    first = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jcache, jtoks = jeng.decode_multi(jcache, first, 4)
    tcache, ttoks = teng.decode_multi(tcache, first, 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [max_seq, 14])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    _close(tcache["k"].numpy(), jcache["k"])


def test_generate_matches_jax(setup, served):
    prompts = [[5, 9, 200, 7], list(range(30, 41))]
    jout = served["jeng"].generate(prompts, max_new_tokens=5)
    tout = served["teng"].generate(prompts, max_new_tokens=5)
    assert tout == jout
    eos = tout[0][0]
    teos = served["teng"].generate(prompts, max_new_tokens=5, eos_token_id=eos)
    assert teos == served["jeng"].generate(prompts, max_new_tokens=5, eos_token_id=eos)
    assert teos[0] == [eos]


def test_sampling_respects_top_k_and_generator():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0], [2.0, 1.0, 0.0, 9.0, 8.0]])
    greedy = sample(logits, None, SamplingParams())
    assert greedy.tolist() == [1, 3]
    params = SamplingParams(temperature=1.0, top_k=2, top_p=0.9)
    draws = torch.stack([sample(logits, torch.Generator().manual_seed(i), params)
                         for i in range(40)])
    assert set(draws[:, 0].tolist()) <= {1, 2} and set(draws[:, 1].tolist()) <= {3, 4}
    again = torch.stack([sample(logits, torch.Generator().manual_seed(i), params)
                         for i in range(40)])
    assert torch.equal(draws, again)


def test_decode_multi_eos_freezes_like_jax(setup, served):
    _, _, _, _, ids = setup
    jeng, teng = served["jeng"], served["teng"]
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, LENGTHS, slot_mask=ACTIVE)
    tcache, _ = teng.prefill(teng.new_cache(), ids, LENGTHS, slot_mask=ACTIVE)
    first = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    eos = int(served["toks"][0][1, 2])  # row 1 emits it at step 2
    jcache, jtoks = jeng.decode_multi(jcache, first, 6, active=ACTIVE, eos_token_id=eos)
    tcache, ttoks = teng.decode_multi(tcache, first, 6, active=ACTIVE, eos_token_id=eos)
    np.testing.assert_array_equal(ttoks.numpy()[ACTIVE], np.asarray(jtoks)[ACTIVE])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    assert (ttoks.numpy()[1, 2:] == eos).all()


def test_engine_rejects_bad_host_input(served):
    teng = served["teng"]
    ids = np.zeros((B, 4), np.int32)
    with pytest.raises(ValueError, match="token ids"):
        teng.prefill(teng.new_cache(), ids + TINY["vocab_size"], np.full((B,), 4, np.int32))
    with pytest.raises(ValueError, match="lengths"):
        teng.prefill(teng.new_cache(), ids, np.full((B,), 5, np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        teng.prefill(teng.new_cache(), np.zeros((B, S + 1), np.int32), np.ones(B, np.int32))
    with pytest.raises(ValueError, match="token ids"):
        teng.decode(teng.new_cache(), np.full((B,), -1))
    cache, logits = teng.prefill(teng.new_cache(), ids, np.array([4, 0, 0, 0], np.int32))
    assert bool(torch.isfinite(logits[0]).all())
    np.testing.assert_array_equal(cache["lengths"].numpy(), [4, 0, 0, 0])
