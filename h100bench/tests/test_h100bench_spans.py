"""The readers of the program's spans and counters (``benchlib/spans.py``
and the six metrics over it), fed a hand-built trace and registry: idle
gaps go to the innermost program span, operators and the benchmark's own
spans are passed over, and every reader reads None where its input is
missing (the CPU, or a program without the tracing module)."""

import types

import pytest

from h100bench.benchlib import spans
from h100bench.benchlib.cells import Cell, load_benchmark
from h100bench.benchlib.trace import TraceReading

NEW = ("admit_share.chat", "decode_ms.chat", "experts_share.chat", "idle_sched_pct.chat",
       "idle_forward_pct.chat", "admit_useful_pct.chat")
PROGRAM = ("sched.plan", "sched.fetch", "sched.unpack", "engine.serve_chunk", "engine.admit",
           "engine.decode", "model.attention", "model.router", "model.experts",
           "model.shared_expert", "model.mlp", "model.lm_head")

# Times in microseconds. Kernels run over 0-10, 30-40, 60-100, 130-140:
# gaps 10-30, 40-60, 100-130. On the host: the benchmark's scheduler.step
# over everything, sched.plan 5-25, a round 25-100 whose decode step 35-95
# holds the experts 45-55 (an operator inside them), the fetch 100-110, the
# unpack 110-120, the benchmark's deliveries 120-128.
KERNELS = [("w4_mma_kernel", 0, 10), ("w4_mma_kernel", 30, 40), ("elementwise", 60, 100),
           ("w4_mma_kernel", 130, 140)]
HOST = [("scheduler.step", 0, 121), ("sched.plan", 5, 25), ("aten::copy_", 12, 20),
        ("engine.serve_chunk", 25, 100), ("engine.decode", 35, 95), ("model.experts", 45, 55),
        ("aten::mm", 46, 54), ("sched.fetch", 100, 110), ("sched.unpack", 110, 120),
        ("harness.deliveries", 120, 128)]
WINDOW_S = 200e-6


def _reading(kernels=KERNELS, host=HOST):
    return TraceReading(window_s=WINDOW_S, kernels=list(kernels), host=list(host))


def _registry(ms=None, got=None):
    return types.SimpleNamespace(SPANS=PROGRAM, device_ms=lambda: dict(ms or {}),
                                 counts=lambda: dict(got or {}))


@pytest.fixture
def readers():
    bench = load_benchmark()
    cell = Cell(bench, "qwen1.5-moe.chat-conv")
    by = {m["name"]: m for m in cell.per_layer}
    return {name: cell.reader(by[name]) for name in NEW}


def test_gaps_go_to_the_innermost_program_span():
    by = spans.idle_by_span(_reading(), PROGRAM)
    want = {"sched.plan": 15, "engine.serve_chunk": 5, "engine.decode": 10,
            "model.experts": 10, "sched.fetch": 10, "sched.unpack": 10, None: 10}
    assert by.keys() == want.keys()
    for name, us in want.items():
        assert by[name] == pytest.approx(us / 1e6), name
    # The gaps are partitioned: their sum is the idle time between kernels.
    assert sum(by.values()) == pytest.approx(70e-6)


def test_a_child_that_outlasts_its_parent_keeps_its_time():
    host = [("engine.serve_chunk", 0, 50), ("engine.decode", 40, 52)]
    by = spans.idle_by_span(_reading([("k", 0, 10), ("k", 60, 70)], host), PROGRAM)
    assert by["engine.serve_chunk"] == pytest.approx(30e-6)
    assert by["engine.decode"] == pytest.approx(12e-6)
    assert by[None] == pytest.approx(8e-6)


def test_readers_on_a_traced_window(readers, monkeypatch):
    ms = {"engine.serve_chunk": (2, 100.0), "engine.admit": (1, 60.0),
          "engine.decode": (8, 32.0), "model.experts": (100, 70.0)}
    got = {"sched.admit_tokens": 300, "sched.admit_padded_tokens": 512}
    monkeypatch.setattr(spans, "registry", lambda: _registry(ms, got))
    obs = {"trace": _reading()}
    values = {name: read(obs) for name, read in readers.items()}
    assert values["admit_share.chat"] == pytest.approx(60.0)
    assert values["decode_ms.chat"] == pytest.approx(4.0)
    assert values["experts_share.chat"] == pytest.approx(70.0)
    assert values["idle_sched_pct.chat"] == pytest.approx(100 * 35 / 200)
    assert values["idle_forward_pct.chat"] == pytest.approx(100 * 25 / 200)
    assert values["admit_useful_pct.chat"] == pytest.approx(100 * 300 / 512)


@pytest.mark.parametrize("case", ["no_registry", "empty_registry", "no_trace", "no_spans"])
def test_readers_read_none_without_input(readers, monkeypatch, case):
    if case == "no_registry":  # a program without the tracing module
        monkeypatch.setattr(spans, "registry", lambda: None)
        obs = {"trace": _reading()}
    elif case == "empty_registry":  # the CPU, or a window the profiler did not cover
        monkeypatch.setattr(spans, "registry", lambda: _registry())
        obs = {"trace": _reading(kernels=[])}
    elif case == "no_trace":
        monkeypatch.setattr(spans, "registry", lambda: _registry())
        obs = {}
    else:  # a device timeline, but no program span on the host
        monkeypatch.setattr(spans, "registry", lambda: _registry())
        obs = {"trace": _reading(host=[h for h in HOST if h[0] not in PROGRAM])}
    assert {name: read(obs) for name, read in readers.items()} == dict.fromkeys(NEW)


def test_the_registry_is_the_port_tracing_module():
    from onnx_quantize_tpu_torch import tracing

    assert spans.registry() is tracing
    assert set(PROGRAM) == set(tracing.SPANS)
