"""The scoring slice against the JAX package on tiny Gemma-3: decode-path NLL
(``InferenceEngine.score_nll``/``score_ppl``) over float, int8 and int4
caches, fused and unfused, with row chunking; and the sliding-window
``perplexity_from_tokens`` with one window and several."""

import types

import jax
import numpy as np
import pytest
import torch

from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.tools.perplexity import perplexity_from_tokens as jax_ppl
from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.tools import perplexity_eval, perplexity_from_tokens

torch.set_num_threads(1)

TINY128 = dict(hidden_size=64, num_heads=2, num_kv_heads=1, head_dim=128, sliding_window=16,
               sliding_pattern=2)
# Rows longer than the 16-token window; the last row is padding (length 0)
# and the middle ones ragged. Five rows over max_batch=2: three chunks.
T = 40
LENGTHS = np.array([40, 33, 2, 27, 0], np.int32)
# Float cache: the packages differ in float32 summation order only, so per
# row NLL sums agree to 1e-5 relative. Quantized caches: a code may round
# the other way at a float32 .5 tie (test_torch_engine), which moves a
# logit by a fraction of a quantization step; 1e-4 relative bounds that.
NLL_RTOL = {False: 1e-5, "int8": 1e-4, "int4": 1e-4}


@pytest.fixture(scope="module")
def tiny128():
    jmodel = JGemma3(JGemma3Config.tiny(**TINY128))
    jparams = jmodel.init(jax.random.key(1))
    ids = np.random.default_rng(11).integers(0, 256, (len(LENGTHS), T)).astype(np.int32)
    return (jmodel, jparams, Gemma3(Gemma3Config.tiny(**TINY128)),
            from_jax_params(jparams, device="cpu"), ids)


@pytest.fixture(scope="module")
def jax_scores(tiny128):
    jmodel, jparams, _, _, ids = tiny128
    out = {}
    for kv in NLL_RTOL:
        eng = JEngine(jmodel, jparams, max_batch=2, max_seq=128, kv_quant=kv)
        out[kv] = eng.score_nll(ids, LENGTHS)
    return out


@pytest.mark.parametrize("kv", list(NLL_RTOL))
def test_score_nll_matches_jax(tiny128, jax_scores, kv):
    _, _, tmodel, tparams, ids = tiny128
    eng = InferenceEngine(tmodel, tparams, max_batch=2, max_seq=128, kv_quant=kv)
    nll, cnt = eng.score_nll(ids, LENGTHS)
    jnll, jcnt = jax_scores[kv]
    assert nll.dtype == np.float32 and cnt.dtype == np.int32
    np.testing.assert_array_equal(cnt, np.maximum(LENGTHS - 1, 0))
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_allclose(nll, jnll, rtol=NLL_RTOL[kv], atol=0)
    ppl = float(np.exp(jnll.sum() / jcnt.sum()))
    assert eng.score_ppl(ids, LENGTHS) == pytest.approx(ppl, rel=NLL_RTOL[kv])


def test_fused_scoring_matches_unfused_and_jax(tiny128, jax_scores):
    """Flash decode over the int8 cache (plain version on CPU) scores as the
    scale-folded attend does, within the fused-decode bar (rtol 1e-4)."""
    _, _, tmodel, tparams, ids = tiny128
    eng = InferenceEngine(tmodel, tparams, max_batch=2, max_seq=128, kv_quant=True,
                          fused_attention=True)
    nll, cnt = eng.score_nll(ids, LENGTHS)
    np.testing.assert_allclose(nll, jax_scores["int8"][0], rtol=1e-4, atol=0)
    np.testing.assert_array_equal(cnt, jax_scores["int8"][1])


def test_row_chunking_and_input_checks(tiny128):
    """Rows scored in chunks of max_batch give each row's own NLL."""
    _, _, tmodel, tparams, ids = tiny128
    wide = InferenceEngine(tmodel, tparams, max_batch=len(LENGTHS), max_seq=64, kv_quant=True)
    narrow = InferenceEngine(tmodel, tparams, max_batch=2, max_seq=64, kv_quant=True)
    one = InferenceEngine(tmodel, tparams, max_batch=1, max_seq=64, kv_quant=True)
    nll_w, cnt_w = wide.score_nll(ids, LENGTHS)
    for eng in (narrow, one):
        nll, cnt = eng.score_nll(ids, LENGTHS)
        np.testing.assert_array_equal(cnt, cnt_w)
        np.testing.assert_allclose(nll, nll_w, rtol=1e-6, atol=0)
    nll_1d, cnt_1d = one.score_nll(ids[0])
    assert cnt_1d.tolist() == [T - 1]
    np.testing.assert_allclose(nll_1d, nll_w[:1], rtol=1e-6)
    with pytest.raises(ValueError, match="max_seq"):
        InferenceEngine(tmodel, tparams, max_batch=1, max_seq=16).score_nll(ids)
    with pytest.raises(ValueError, match="two tokens"):
        one.score_nll(ids[:, :1])
    with pytest.raises(ValueError, match="token ids"):
        one.score_nll(ids + 256)


@pytest.mark.parametrize("n_tokens,max_length,stride", [(12, 32, 16), (50, 16, 8),
                                                        (64, 32, 16)])
def test_perplexity_from_tokens_matches_jax(tiny128, n_tokens, max_length, stride):
    """rel 1e-3, as tests/tools/test_perplexity.py holds the JAX tool to its
    oracle; one window (12 tokens) and several."""
    jmodel, jparams, tmodel, tparams, _ = tiny128
    tokens = np.random.default_rng(n_tokens).integers(1, 250, n_tokens).astype(np.int32)
    want = jax_ppl(jmodel, jparams, tokens, max_length=max_length, stride=stride)
    got = perplexity_from_tokens(tmodel, tparams, tokens, max_length=max_length, stride=stride)
    assert got == pytest.approx(want, rel=1e-3)
    tmodel.use_flash = True  # the blockwise branch (plain version on CPU): max_length % 16 == 0
    try:
        flash = perplexity_from_tokens(tmodel, tparams, tokens, max_length=max_length,
                                       stride=stride)
    finally:
        tmodel.use_flash = "auto"
    assert flash == pytest.approx(want, rel=1e-3)


def test_perplexity_eval_reads_npy_and_refuses_a_mesh(tiny128, tmp_path):
    _, _, tmodel, tparams, _ = tiny128
    tokens = np.random.default_rng(0).integers(1, 250, 30).astype(np.int32)
    np.save(tmp_path / "tokens.npy", tokens)
    got = perplexity_eval(tmodel, tparams, tokens_path=str(tmp_path / "tokens.npy"),
                          max_length=16, stride=8)
    assert got == perplexity_from_tokens(tmodel, tparams, tokens, max_length=16, stride=8)
    # The mesh reaches context-parallel scoring, which refuses a sequence axis
    # that does not divide the window (the multi-rank runs are in
    # tests/test_torch_pp_cp.py).
    mesh = types.SimpleNamespace(axis_names=("seq",), shape={"seq": 3}, coords={"seq": 0})
    with pytest.raises(ValueError, match="not divisible by cp shards 3"):
        perplexity_eval(tmodel, tparams, tokens_path=str(tmp_path / "tokens.npy"),
                        max_length=16, stride=8, mesh=mesh)
