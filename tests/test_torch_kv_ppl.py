"""Perplexity through the port's quantized-KV decode path, at the JAX pins.

Counterpart of ``tests/engine/test_kv_ppl.py`` on the port alone: the
structured-weight Gemma-3 (``models/structured.py``, the JAX package's seeded
numpy draws) scored by ``InferenceEngine.score_ppl``, which prefills one
token and teacher-forces the rest through the decode step, so every K/V row
passes through the cache's quantize/dequantize chain. Held to the JAX file's
frozen numbers at its ``ATOL`` 0.75: the full-forward teacher-forced oracle
``FWD_PPL`` and the float decode path equal to it within 0.05, the per-mode
``KV_PINS`` (``tests/engine/test_kv_ppl.py:36-42``), the logits distortion
growing from int8 to int4 (``:84-110``) and the row chunking with per-row
lengths (``:113-124``).
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.models.structured import STRUCTURED_GEMMA3, zipf_tokens

S = 512
ATOL = 0.75  # tests/engine/test_kv_ppl.py:34
FWD_PPL = 1240.164  # :36
KV_PINS = {False: 1240.167, "int8": 1241.788, "int4": 1228.763}  # :37-41


@pytest.fixture(scope="module")
def structured():
    model, params = STRUCTURED_GEMMA3(device="cpu")
    tokens = zipf_tokens(2 * S, 2048).reshape(2, S)
    return model, params, tokens


def forward_ppl(model, params, tokens) -> float:
    ids = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        logp = torch.log_softmax(model(params, ids).to(torch.float32), dim=-1)
    nll = -torch.gather(logp[:, :-1], 2, ids[:, 1:, None])[..., 0]
    return float(torch.exp(nll.to(torch.float64).mean()))


def test_fp_decode_path_matches_forward(structured):
    model, params, tokens = structured
    assert forward_ppl(model, params, tokens) == pytest.approx(FWD_PPL, abs=0.05)
    eng = InferenceEngine(model, params, max_batch=2, max_seq=S, kv_quant=False)
    assert eng.score_ppl(tokens) == pytest.approx(FWD_PPL, abs=0.05)


@pytest.mark.parametrize("kv", [False, "int8", "int4"])
def test_kv_mode_ppl_pins(structured, kv):
    model, params, tokens = structured
    eng = InferenceEngine(model, params, max_batch=2, max_seq=S, kv_quant=kv)
    ppl = eng.score_ppl(tokens)
    assert ppl == pytest.approx(KV_PINS[kv], abs=ATOL), (
        f"kv={kv!r}: decode-path ppl {ppl:.3f} drifted from {KV_PINS[kv]:.3f}")


def test_kv_quant_distortion_monotone(structured):
    """Cache error measured directly: |logits_kvq - logits_fp| along the
    teacher-forced trajectory grows from int8 to int4 (the JAX file's
    frozen bars: rel8 < 0.03, rel4 < 0.30, rel4 > 3 rel8)."""
    model, params, tokens = structured
    T = 128
    toks = tokens[:, :T]
    outs = {}
    for kv in (False, "int8", "int4"):
        eng = InferenceEngine(model, params, max_batch=2, max_seq=T, kv_quant=kv)
        cache, logits = eng.prefill(eng.new_cache(), toks[:, :1], np.ones(2, np.int32))
        per = [logits.numpy()]
        for i in range(1, T - 1):
            cache, logits = eng.decode(cache, toks[:, i])
            per.append(logits.numpy())
        outs[kv] = np.stack(per, 1)
    fp = outs[False]
    rel8 = np.abs(outs["int8"] - fp).mean() / np.abs(fp).mean()
    rel4 = np.abs(outs["int4"] - fp).mean() / np.abs(fp).mean()
    assert rel8 < 0.03, rel8
    assert rel4 < 0.30, rel4
    assert rel4 > 3 * rel8, (rel4, rel8)


def test_score_nll_row_chunking(structured):
    """N > max_batch rows chunk correctly and per-row lengths gate the sums."""
    model, params, tokens = structured
    eng = InferenceEngine(model, params, max_batch=2, max_seq=64, kv_quant="int8")
    ids = np.stack([tokens[0, :64], tokens[1, :64], tokens[0, 64:128]])
    nll, cnt = eng.score_nll(ids, np.array([64, 40, 64], np.int32))
    assert cnt.tolist() == [63, 39, 63]
    nll_b, cnt_b = eng.score_nll(ids[1:2, :40])
    assert cnt_b[0] == 39
    np.testing.assert_allclose(nll[1], nll_b[0], rtol=1e-5)
