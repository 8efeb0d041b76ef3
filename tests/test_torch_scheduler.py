"""The PyTorch port's ``ContinuousBatchingScheduler`` against the JAX
package's, greedy, on bridged weights: every request's tokens are equal in
the per-step loop and in serve mode, pipelined or not, with narrow or masked
admission, over int8 and float caches, with EOS, budget and capacity
finishes and a registered prefix. Then the port's own relations, as the JAX
package's serving tests pin them: chunked equals per-step, narrow equals
masked under sampling, a prefix request equals its full prompt, the length
mirror, submit's checks, admission beside an in-flight sequence, eviction at
capacity."""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler as JScheduler
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jax_fuse
from onnx_quantize_tpu_torch.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    SamplingParams,
)
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

torch.set_num_threads(1)

TINY = dict(hidden_size=320, intermediate_size=512, num_layers=3, sliding_pattern=3,
            num_heads=2, num_kv_heads=1, head_dim=64, sliding_window=8, vocab_size=512)
B, S = 4, 48
PREFIX = [7, 3, 99, 12, 5, 44, 21, 300, 411, 2, 17]
SUFFIXES = [[9, 17, 3], [11], [2, 8, 30, 4], [250, 6]]


@pytest.fixture(scope="module")
def models():
    """The tiny Gemma with a weight-only tree (uint4 g64 body, int8 head,
    fused) in both packages. Weight-only: with int8 activations a row's
    tokens would depend on which rows share its forward."""
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    params = jax_fuse(params)
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    tparams = from_jax_params(params, device="cpu")
    engines = {}

    def engine(jax_side: bool, kv_quant=True, max_batch=B, max_seq=S):
        # One engine per configuration, shared by the schedulers: the JAX
        # engine's compiled programs are per engine.
        key = (jax_side, kv_quant, max_batch, max_seq)
        if key not in engines:
            cls, model, p = (JEngine, jmodel, params) if jax_side else (InferenceEngine, tmodel,
                                                                          tparams)
            engines[key] = cls(model, p, max_batch=max_batch, max_seq=max_seq,
                               kv_quant=kv_quant)
        return engines[key]

    return engine


def _run(engine, reqs, chunk=1, pipeline=1, narrow=True, jax_side=False, prefix=None,
         **engine_kw):
    eng = engine(jax_side, **engine_kw)
    sched = (JScheduler if jax_side else ContinuousBatchingScheduler)(
        eng, chunk=chunk, pipeline=pipeline)
    sched.narrow_admit = narrow
    if prefix is not None:
        assert sched.register_prefix(prefix) == len(prefix)
    handles = [sched.submit(list(p), **kw) for p, kw in reqs]
    finished = sched.run()
    assert all(r.done for r in handles) and len(finished) == len(handles)
    return [r.output for r in handles], sched


def _workload(engine):
    """Nine requests through four slots: queueing and slot reuse, budgets
    that end inside a round, two prompts that run into max_seq, and EOS ids
    taken from a probe run so that two requests stop on them."""
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(1, TINY["vocab_size"], int(rng.integers(2, 15))).tolist(),
             dict(max_new_tokens=int(rng.integers(3, 13)))) for _ in range(7)]
    reqs.insert(2, (rng.integers(1, TINY["vocab_size"], 30).tolist(), dict(max_new_tokens=40)))
    reqs.append((rng.integers(1, TINY["vocab_size"], 41).tolist(), dict(max_new_tokens=20)))
    probe, _ = _run(engine, reqs)
    for i in (0, 4):
        out = probe[i]
        later = [t for t in out[1:] if t != out[0]]
        reqs[i][1]["eos_token_id"] = later[0] if later else out[0]
    return reqs


@pytest.fixture(scope="module")
def workload(models):
    reqs = _workload(models)
    base, _ = _run(models, reqs)
    # EOS, budget and capacity finishes all occur.
    assert base[0][-1] == reqs[0][1]["eos_token_id"] and len(base[0]) < reqs[0][1]["max_new_tokens"]
    assert len(base[1]) == reqs[1][1]["max_new_tokens"]
    assert len(base[2]) == S - 30 + 1 and len(base[8]) == S - 41 + 1
    # The model emits varied tokens, so equal outputs mean something.
    assert len({t for out in base for t in out}) >= 3
    return reqs, base


MODES = [
    pytest.param(dict(chunk=1), id="per_step-int8"),
    pytest.param(dict(chunk=1, kv_quant=False), id="per_step-float"),
    pytest.param(dict(chunk=4, narrow=False), id="chunk4-masked-int8"),
    pytest.param(dict(chunk=4), id="chunk4-narrow-int8"),
    pytest.param(dict(chunk=4, pipeline=3), id="chunk4-pipeline3-narrow-int8"),
    pytest.param(dict(chunk=4, pipeline=3, narrow=False), id="chunk4-pipeline3-masked-int8"),
    pytest.param(dict(chunk=4, pipeline=3, kv_quant=False), id="chunk4-pipeline3-narrow-float"),
]


@pytest.mark.parametrize("mode", MODES)
def test_scheduler_tokens_equal_jax(models, workload, mode):
    reqs, base = workload
    got, sched = _run(models, reqs, **mode)
    want, jsched = _run(models, reqs, jax_side=True, **mode)
    assert got == want
    if mode["chunk"] > 1:
        assert sched.stats == jsched.stats
        np.testing.assert_array_equal(sched.lengths, np.asarray(jsched.lengths))
    if mode.get("kv_quant", True):
        # The port's relation: every mode gives the per-step loop's tokens.
        assert got == base


@pytest.mark.parametrize("chunk,pipeline", [(1, 1), (4, 2)])
def test_prefix_requests_equal_jax_and_full_prompt(models, chunk, pipeline):
    reqs = [(s, dict(max_new_tokens=8, use_prefix=True)) for s in SUFFIXES]
    reqs.append(([5, 9, 17, 3], dict(max_new_tokens=6)))  # a plain one beside them
    got, _ = _run(models, reqs, chunk=chunk, pipeline=pipeline, prefix=PREFIX)
    want, _ = _run(models, reqs, chunk=chunk, pipeline=pipeline, prefix=PREFIX, jax_side=True)
    assert got == want
    full = [(PREFIX + s, dict(max_new_tokens=8)) for s in SUFFIXES] + [reqs[-1]]
    assert got == _run(models, full, chunk=chunk, pipeline=pipeline)[0]


# -- the port's own relations ------------------------------------------------------

def _sampled(models, narrow, seed=0, chunk=2, pipeline=2):
    """Staggered budgets over more requests than slots, so admissions of one
    or two rows take the narrow path; top-k sampling."""
    rng = np.random.default_rng(3)
    budgets = (3, 9, 5, 12, 4, 8, 6, 10, 7, 5)
    sp = SamplingParams(temperature=0.8, top_k=8)
    eng = models(False, max_batch=8, max_seq=64)
    sched = ContinuousBatchingScheduler(eng, generator=torch.Generator().manual_seed(seed),
                                        chunk=chunk, pipeline=pipeline)
    sched.narrow_admit = narrow
    calls = []
    build = sched._build_admit_narrow
    sched._build_admit_narrow = lambda admitted: (calls.append(len(admitted)), build(admitted))[1]
    handles = [sched.submit(rng.integers(1, TINY["vocab_size"], int(rng.integers(2, 10))).tolist(),
                            max_new_tokens=m, sampling=sp) for m in budgets]
    sched.run()
    return [r.output for r in handles], calls


def test_narrow_equals_masked_under_sampling(models):
    narrow, calls = _sampled(models, narrow=True)
    assert calls, "no admission took the narrow path"
    masked, no_calls = _sampled(models, narrow=False)
    assert not no_calls
    assert narrow == masked
    assert narrow == _sampled(models, narrow=True)[0]  # the same seed, the same draws
    assert narrow != _sampled(models, narrow=True, seed=1)[0]
    for out, m in zip(narrow, (3, 9, 5, 12, 4, 8, 6, 10, 7, 5)):
        assert len(out) == m and all(0 <= t < TINY["vocab_size"] for t in out)


def test_mixed_sampling_keeps_greedy_rows(models):
    """A greedy request beside sampled ones in the same rounds gives its
    solo per-step tokens."""
    greedy = ([5, 9, 17], dict(max_new_tokens=10))
    solo, _ = _run(models, [greedy])
    sampled = [([3, 2, 77], dict(max_new_tokens=6,
                                 sampling=SamplingParams(temperature=0.9, top_p=0.9))),
               ([8, 8], dict(max_new_tokens=9, sampling=SamplingParams(temperature=1.1,
                                                                       top_k=5)))]
    outs, sched = _run(models, [greedy] + sampled, chunk=4, pipeline=2)
    assert outs[0] == solo[0] and sched._variant == (True, True, True)


@pytest.mark.parametrize("chunk", [1, 4])
def test_length_mirror_equals_device_lengths(models, chunk):
    eng = models(False, max_seq=24)
    sched = ContinuousBatchingScheduler(eng, chunk=chunk)
    rng = np.random.default_rng(3)
    for _ in range(6):
        sched.submit(rng.integers(1, 500, int(rng.integers(2, 7))).tolist(),
                     max_new_tokens=int(rng.integers(2, 20)))
    steps = 0
    while sched.has_work and steps < 60:
        sched.step()
        steps += 1
        device = sched.cache["lengths"].numpy()
        for slot_id, req in enumerate(sched.slots):
            if req is not None:
                assert sched.lengths[slot_id] == device[slot_id], slot_id
    assert not sched.has_work


def test_submit_checks(models):
    eng = models(False, max_seq=16)
    sched = ContinuousBatchingScheduler(eng, chunk=4)
    with pytest.raises(ValueError, match="max_seq"):
        sched.submit(list(range(1, 20)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit([1, 2, 3], max_new_tokens=0)
    with pytest.raises(ValueError, match="no prefix registered"):
        sched.submit([1, 2], use_prefix=True)
    with pytest.raises(ValueError, match="non-empty"):
        sched.register_prefix([])
    with pytest.raises(ValueError, match="no room"):
        sched.register_prefix(list(range(1, 17)))
    sched.register_prefix(list(range(1, 13)))  # 12 of 16 positions
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit([1, 2, 3, 4, 5], use_prefix=True)
    with pytest.raises(ValueError, match="suffix"):
        sched.submit([], use_prefix=True)
    with pytest.raises(ValueError, match="chunk"):
        ContinuousBatchingScheduler(eng, chunk=0)
    assert isinstance(sched.submit([1, 2, 3, 4], use_prefix=True), Request)


def test_full_length_prompt_emits_one_token(models):
    prompt = list(range(1, 13))
    outs = [_run(models, [(prompt, dict(max_new_tokens=4))], chunk=c, max_seq=12)[0]
            for c in (1, 4)]
    assert outs[0] == outs[1] and len(outs[0][0]) == 1


def test_prefix_admission_leaves_sibling_intact(models):
    """A prefix request admitted (per-step mode) beside an in-flight
    sequence: the sibling's cache rows and length are bit-equal across the
    admission, and its tokens equal its solo run."""
    long = ([5, 6, 7, 8], dict(max_new_tokens=12))
    solo, _ = _run(models, [long])
    eng = models(False)
    sched = ContinuousBatchingScheduler(eng)
    sched.register_prefix(PREFIX)
    req = sched.submit(*long[:1], **long[1])
    sched.step()
    sched.step()
    before = {key: buf[:, 0].clone() for key, buf in sched.cache.items() if key != "lengths"}
    length = int(sched.cache["lengths"][0])
    other = sched.submit(SUFFIXES[2], max_new_tokens=5, use_prefix=True)
    sched._admit()
    for key, rows in before.items():
        assert torch.equal(sched.cache[key][:, 0], rows), key
    assert int(sched.cache["lengths"][0]) == length
    assert int(sched.cache["lengths"][1]) == len(PREFIX) + len(SUFFIXES[2])
    sched.run()
    assert req.output == solo[0] and other.done and len(other.output) == 5


def test_admission_mid_decode_preserves_inflight_sequence(models):
    """Short requests finish and free a slot while a long one decodes: the
    long request's tokens equal its solo run, in both modes."""
    long = ([5, 6, 7, 8], dict(max_new_tokens=12))
    shorts = [([9, 10], dict(max_new_tokens=3))] * 3
    solo, _ = _run(models, [long], max_batch=2)
    for chunk in (1, 4):
        outs, _ = _run(models, [long] + shorts, chunk=chunk, max_batch=2)
        assert outs[0] == solo[0] and outs[1] == outs[2] == outs[3]


def test_eviction_at_capacity(models):
    outs, sched = _run(models, [([1, 2, 3, 4, 5], dict(max_new_tokens=100))],
                       max_batch=1, max_seq=8)
    # Five prompt tokens and at most three decoded before the cache fills.
    assert len(outs[0]) == 4 and int(sched.cache["lengths"][0]) == 8
