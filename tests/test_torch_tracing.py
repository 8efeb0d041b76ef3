"""The port's spans and counters (``onnx_quantize_tpu_torch.tracing``): off
(nothing recorded) while no profiler runs; under ``torch.profiler`` one
serve-mode step with an admission records the declared spans, nested
scheduler > round > admission or decode step > model boundary (the tiny MoE
model every span but ``model.mlp``, the tiny dense model ``model.mlp`` and
no MoE span); the admission counters equal the prompts, the padded shape
and the forwards, one or the plan's; served tokens do not depend on the
profiler; device-stream times are summed per timed span."""

import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch import tracing
from onnx_quantize_tpu_torch.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    SamplingParams,
    prepare_kernel_scales,
)
from onnx_quantize_tpu_torch.engine.scheduler import ADMIT_M_FLOOR, plan_admission
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.moe import (
    fuse_moe_experts,
    stack_moe_experts,
    tiny_moe_config,
)

torch.set_num_threads(1)

B, S, CHUNK = 8, 64, 3
PROMPTS = [[3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46, 26, 43, 38], list(range(1, 18))]
MOE_LAYER_SPANS = ("model.attention", "model.router", "model.experts", "model.shared_expert")


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def moe():
    """The tiny MoE model with a gated shared expert, W4 g16, its experts
    in the fused layout the benchmark serves."""
    model = Gemma3(tiny_moe_config(shared_expert_size=48))
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        ignore=[r"\.router$", r"\.shared_gate$"]))
    tree = stack_moe_experts(fuse_moe_experts(prepare_kernel_scales(fuse_gemma3_projections(q))))
    assert "_fused_experts" in tree["layers.0"]["mlp"]
    return model, tree


@pytest.fixture(scope="module")
def dense():
    """The tiny dense Gemma, W4 g16 body, fused."""
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16), ignore=["lm_head"]))
    return model, fuse_gemma3_projections(q)


def _scheduler(moe, narrow=True, pipeline=2):
    model, tree = moe
    engine = InferenceEngine(model, tree, max_batch=B, max_seq=S, kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, generator=torch.Generator().manual_seed(7),
                                        chunk=CHUNK, pipeline=pipeline)
    sched.narrow_admit = narrow
    return sched


def _submit(sched):
    sampled = SamplingParams(temperature=0.8, top_k=20)
    return [sched.submit(p, max_new_tokens=5, sampling=sampled if i % 2 else SamplingParams())
            for i, p in enumerate(PROMPTS)]


def _spans(prof):
    names = set(tracing.SPANS)
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in names and e.device_type == torch.autograd.DeviceType.CPU]


def _inside(inner, outers):
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def test_off_records_nothing(moe):
    assert not tracing.enabled()
    assert tracing.span("engine.decode") is tracing.span("model.experts")
    with tracing.span("engine.decode"):
        tracing.count("sched.admit_tokens", 5)
    sched = _scheduler(moe)
    _submit(sched)
    sched.step()
    assert tracing.counts() == {} and tracing.device_ms() == {}


def test_undeclared_names_are_refused_while_on():
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        with pytest.raises(ValueError, match="undeclared span"):
            tracing.span("model.nothing")
        with pytest.raises(ValueError, match="undeclared counter"):
            tracing.count("sched.nothing")
    assert not tracing.enabled()


def test_every_declared_name_is_used_and_every_used_name_declared():
    root = Path(tracing.__file__).parent
    used = {}
    for path in root.rglob("*.py"):
        for kind, name in re.findall(r"tracing\.(span|count)\(\s*\"([^\"]+)\"", path.read_text()):
            used.setdefault(kind, set()).add(name)
    assert used["span"] == set(tracing.SPANS)
    assert used["count"] == set(tracing.COUNTERS)


def _one_step(pair):
    """The spans of one serve step with an admission, by name; checks the
    nesting every model shares."""
    sched = _scheduler(pair)
    _submit(sched)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched.step()
    by = {}
    for s in _spans(prof):
        by.setdefault(s[0], []).append(s)
    rounds, steps = by["engine.serve_chunk"], by["engine.admit"] + by["engine.decode"]
    assert len(rounds) == 2 and len(by["engine.admit"]) == 1
    assert len(by["engine.decode"]) == 2 * CHUNK
    assert len(by["sched.fetch"]) == len(by["sched.unpack"]) == 1
    assert all(_inside(s, rounds) for s in steps)
    for name in by:
        if name.startswith("model."):
            assert all(_inside(s, steps) for s in by[name]), name
    # The scheduler's spans lie outside the rounds.
    for name in ("sched.plan", "sched.fetch", "sched.unpack"):
        assert not any(_inside(s, rounds) for s in by[name]), name
    assert tracing.device_ms() == {}  # no CUDA: nothing timed on a stream
    return by, 1 + 2 * CHUNK, pair[0].cfg.num_layers


def test_one_moe_serve_step_records_every_span_nested(moe):
    by, forwards, layers = _one_step(moe)
    # Every span but the dense MLP's: the MoE's shared expert runs its MLP
    # inside model.shared_expert.
    assert set(by) == set(tracing.SPANS) - {"model.mlp", "model.latent_attention"}
    for name in MOE_LAYER_SPANS:
        assert len(by[name]) == forwards * layers, name
    assert len(by["model.lm_head"]) == forwards


def test_one_dense_serve_step_records_the_mlp(dense):
    by, forwards, layers = _one_step(dense)
    assert set(by) == set(tracing.SPANS) - {"model.router", "model.experts",
                                            "model.shared_expert", "model.latent_attention"}
    assert len(by["model.mlp"]) == len(by["model.attention"]) == forwards * layers


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "masked"])
def test_admission_counters(moe, narrow):
    sched = _scheduler(moe, narrow=narrow)
    _submit(sched)
    with profile(activities=[ProfilerActivity.CPU]):
        sched.step()
    rows = 4 if narrow else B  # three admitted rows bucketed to a power of two
    t_pad = 64  # the longest prompt (17) bucketed to 64, at most max_seq
    assert tracing.counts() == {"sched.admit_tokens": sum(len(p) for p in PROMPTS),
                                "sched.admit_padded_tokens": rows * t_pad,
                                "sched.admit_forwards": 1}


def test_split_admission_counters(moe):
    """An admission whose prompts spread over several buckets runs the plan's
    sub-forwards: the padded tokens are theirs, exact rows at each one's
    longest prompt's bucket."""
    model, tree = moe
    lengths = [2 * ADMIT_M_FLOOR - 3, 10, ADMIT_M_FLOOR - 20, 12, 2 * ADMIT_M_FLOOR - 40, 11]
    max_seq = 2 * ADMIT_M_FLOOR + 64
    plan = plan_admission(lengths, max_seq)
    assert len(plan) > 1
    engine = InferenceEngine(model, tree, max_batch=16, max_seq=max_seq, kv_quant=True)
    sched = ContinuousBatchingScheduler(engine, chunk=2)
    for n in lengths:
        sched.submit([3] * n, max_new_tokens=2)
    with profile(activities=[ProfilerActivity.CPU]):
        sched.step()
    padded = sum(len(sub) * -(-max(lengths[i] for i in sub) // 64) * 64 for sub in plan)
    assert tracing.counts() == {"sched.admit_tokens": sum(lengths),
                                "sched.admit_padded_tokens": padded,
                                "sched.admit_forwards": len(plan)}


def test_served_tokens_do_not_depend_on_the_profiler(moe):
    def serve(traced):
        sched = _scheduler(moe, pipeline=2)
        reqs = _submit(sched) + [sched.submit([9, 8, 7, 6], max_new_tokens=7)]
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                sched.run()
        else:
            sched.run()
        return [r.output for r in reqs], dict(sched.stats)

    off, on = serve(False), serve(True)
    assert on == off
    assert all(len(out) >= 5 for out in off[0])


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` timed on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_device_ms_sums_each_span(monkeypatch):
    monkeypatch.setattr(tracing, "_stream_timing", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span("engine.serve_chunk"):
                with tracing.span("engine.decode"):
                    with tracing.span("model.attention"):  # not in TIMED: host only
                        time.sleep(0.002)
                with tracing.span("engine.decode"):
                    time.sleep(0.002)
    with tracing.span("engine.decode"):  # off again: not timed
        pass
    got = tracing.device_ms()
    assert set(got) == {"engine.serve_chunk", "engine.decode"}
    assert got["engine.serve_chunk"][0] == 3 and got["engine.decode"][0] == 6
    assert got["engine.decode"][1] >= 6 * 2.0 * 0.9
    assert got["engine.serve_chunk"][1] >= got["engine.decode"][1]
    tracing.reset()
    assert tracing.device_ms() == {} and tracing.counts() == {}


def test_per_step_decode_carries_its_span(moe):
    model, tree = moe
    engine = InferenceEngine(model, tree, max_batch=2, max_seq=S, kv_quant=True)
    cache, _ = engine.prefill(engine.new_cache(), np.array([[1, 2, 3], [4, 5, 0]]),
                              np.array([3, 2]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.decode(cache, np.array([7, 8]))
    names = [s[0] for s in _spans(prof)]
    assert names.count("engine.decode") == 1 and "engine.serve_chunk" not in names
