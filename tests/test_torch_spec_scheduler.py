"""The port's ``SpeculativeScheduler`` (``engine/spec_scheduler.py``) against
the port's ``ContinuousBatchingScheduler`` and the JAX package's
``SpeculativeScheduler``.

Counterpart of ``tests/engine/test_spec_scheduler.py``: six staggered
requests through three slots, greedy outputs token for token equal to the
non-speculative scheduler's over the target alone and to JAX's speculative
scheduler's on the same bridged weights, for a perfect, a quantized and an
adversarial draft at two (k, rounds); EOS; mixed sampled and greedy rows
within their budgets (sampled tokens come from a ``torch.Generator``, so
only the greedy rows are compared across packages); submit's checks and the
stats. The target is drawn as in ``test_torch_speculative.py`` (seed 5, the
embedding and its tied head scaled by 1/4, in JAX, bridged), so the greedy
outputs are not one repeated token.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.engine import SpeculativeDecoder as JSpec
from onnx_quantize_tpu.engine import SpeculativeScheduler as JSpecScheduler
from onnx_quantize_tpu.models import gemma3 as jgemma3
from onnx_quantize_tpu_torch.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    SamplingParams,
    SpeculativeDecoder,
    SpeculativeScheduler,
)
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models import gemma3

torch.set_num_threads(1)

CFG = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2, num_kv_heads=1,
           head_dim=32, vocab_size=128)
SEED, EMBED_SCALE = 5, 0.25
# Six staggered requests through three slots exercise admission churn.
PROMPTS = [[5, 9, 17, 3], [11, 2], [7], [23, 4, 1], [2, 2, 2], [19, 8]]
MAX_NEW = [9, 5, 12, 7, 3, 8]


def _scaled_init(jmodel, seed):
    p = dict(jmodel.init(jax.random.key(seed)))
    for key in ("embed", "lm_head"):
        p[key] = {"w": p[key]["w"] * EMBED_SCALE}
    return p


@pytest.fixture(scope="module")
def setup():
    jmodel = jgemma3.Gemma3(jgemma3.Gemma3Config.tiny(**CFG))
    tmodel = gemma3.Gemma3(gemma3.Gemma3Config.tiny(**CFG))
    params = _scaled_init(jmodel, SEED)
    quantized, _ = joqt.quantize(jmodel, params, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16)))
    drafts = {"self": params, "quantized": quantized,
              "adversarial": _scaled_init(jmodel, 99)}
    bridged = {kind: from_jax_params(p, device="cpu") for kind, p in drafts.items()}

    def engine(kind="self", jax_side=False):
        if jax_side:
            return JEngine(jmodel, drafts[kind], max_batch=3, max_seq=64, kv_quant=True)
        return InferenceEngine(tmodel, bridged[kind], max_batch=3, max_seq=64, kv_quant=True)

    return engine


def _submit_all(sched, eos=None, temps=None):
    out = []
    for i, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
        kw = dict(max_new_tokens=m)
        if eos is not None:
            kw["eos_token_id"] = eos
        if temps is not None:
            kw["sampling"] = SamplingParams(temperature=temps[i])
        out.append(sched.submit(p, **kw))
    return out


def _cb_outputs(engine, eos=None):
    sched = ContinuousBatchingScheduler(engine())
    reqs = _submit_all(sched, eos=eos)
    sched.run()
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def base(setup):
    outputs = _cb_outputs(setup)
    # The streams the drafts are held to are not one repeated token.
    assert all(len(set(o)) >= 2 for o in outputs), outputs
    return outputs


def _spec_outputs(engine, draft_kind, k, rounds, jax_side=False, eos=None):
    cls, sched_cls = (JSpec, JSpecScheduler) if jax_side else (SpeculativeDecoder,
                                                                SpeculativeScheduler)
    spec = cls(engine("self", jax_side), engine(draft_kind, jax_side), k=k)
    sched = sched_cls(spec, rounds=rounds)
    reqs = _submit_all(sched, eos=eos)
    sched.run()
    return [r.output for r in reqs], sched


@pytest.mark.parametrize("draft_kind", ["self", "quantized", "adversarial"])
@pytest.mark.parametrize("k, rounds", [(3, 4), (2, 1)])
def test_greedy_exact_vs_cb_scheduler(setup, base, draft_kind, k, rounds):
    got, sched = _spec_outputs(setup, draft_kind, k, rounds)
    assert got == base, (draft_kind, k, rounds)
    jgot, jsched = _spec_outputs(setup, draft_kind, k, rounds, jax_side=True)
    assert got == jgot
    assert sched.stats == jsched.stats
    # Each live round emits its accepted drafts and one token of the
    # target's; the first token of each request comes from its admission.
    assert sched.stats["emitted"] == sum(len(o) - 1 for o in got)
    assert sched.stats["live_rounds"] <= sched.stats["emitted"] <= k * sched.stats["live_rounds"]


def test_eos_exact_vs_cb_scheduler(setup, base):
    # An EOS that first occurs mid-stream: request 0's first new token.
    at = next(i for i, t in enumerate(base[0]) if t not in base[0][:i] and i > 0)
    eos = base[0][at]
    want = _cb_outputs(setup, eos=eos)
    got, _ = _spec_outputs(setup, "quantized", 3, 3, eos=eos)
    assert got == want
    assert got[0] == base[0][:at + 1]
    assert got == _spec_outputs(setup, "quantized", 3, 3, jax_side=True, eos=eos)[0]


def test_sampled_rows_complete_and_respect_budgets(setup, base):
    """Mixed greedy and sampled rows: every request completes within its
    budget, the greedy rows keep the greedy stream, and the same generator
    seed repeats the whole run."""
    def run(seed):
        spec = SpeculativeDecoder(setup(), setup("quantized"), k=3)
        sched = SpeculativeScheduler(spec, rounds=2,
                                     generator=torch.Generator().manual_seed(seed))
        reqs = _submit_all(sched, temps=[0.0, 0.9, 0.7, 0.0, 1.1, 0.5])
        sched.run()
        return reqs

    reqs = run(7)
    for r, m in zip(reqs, MAX_NEW):
        assert r.done and 1 <= len(r.output) <= m
        assert all(0 <= t < CFG["vocab_size"] for t in r.output)
    assert reqs[0].output == base[0]
    assert reqs[3].output == base[3]
    assert [r.output for r in run(7)] == [r.output for r in reqs]


def test_submit_validation(setup):
    sched = SpeculativeScheduler(SpeculativeDecoder(setup(), setup(), k=3))
    with pytest.raises(ValueError, match="speculative window"):
        sched.submit(list(range(62)))  # no room for k+1
    with pytest.raises(ValueError, match="temperature-only"):
        sched.submit([1, 2], sampling=SamplingParams(temperature=0.8, top_k=5))
    with pytest.raises(ValueError, match="temperature-only"):
        sched.submit([1, 2], sampling=SamplingParams(temperature=0.8, top_p=0.9))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit([1, 2], max_new_tokens=0)
    with pytest.raises(NotImplementedError, match="prefix"):
        sched.submit([1, 2], use_prefix=True)
    with pytest.raises(ValueError, match="rounds"):
        SpeculativeScheduler(sched.spec, rounds=0)
    # A greedy request with top-k set is accepted: its sampling is argmax.
    sched.submit([1, 2], sampling=SamplingParams(temperature=0.0, top_k=5))
    assert len(sched.queue) == 1
