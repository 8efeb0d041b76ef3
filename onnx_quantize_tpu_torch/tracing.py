"""The program's spans and counters, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` profile records; there is
no switch of its own. While it is off, ``span`` hands back a shared no-op
context and ``count`` returns after one flag check, so the serving path
pays a fraction of a microsecond a call.

While it is on:

* ``span(name)`` is a ``torch.profiler.record_function(name)``: the span
  lies on the profiler's host timeline, on the clock of the device trace,
  and an exported chrome trace shows it over the kernels it launched. A
  span named in ``TIMED``, where CUDA is initialized and the current stream
  is not capturing a graph, also records a pair of timing events on the
  current stream. Their elapsed time is the span's device-stream time: from
  the moment the stream reaches the span's first work to the moment it
  passes its last, including any time the stream sat starved inside it.
* ``count(name, n)`` adds ``n`` to an in-memory counter.

Both stores stay in memory until ``reset()``. ``device_ms()`` waits for
each recorded event, so read it after the traced work.

Every name is declared once, in ``SPANS`` or ``COUNTERS``; a name not
declared there is refused while tracing is on.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "TIMED", "COUNTERS", "enabled", "span", "count", "counts", "device_ms", "reset"]

SPANS = (
    "sched.plan",           # slot assignment, budgets, sampling rows, admission arrays
    "sched.fetch",          # the group's one host read of the stacked blobs
    "sched.unpack",         # the blobs into requests, and the slot table
    "engine.serve_chunk",   # one serve round
    "engine.admit",         # a round's admission prefill and first-token sampling
    "engine.decode",        # one decode step: forward, sampling, freezes
    "model.attention",      # projections, KV write and read, attention
    "model.router",         # the MoE router and its top-k
    "model.experts",        # the routed experts, on every path
    "model.shared_expert",  # the gated shared expert
    "model.mlp",            # a dense MLP's forward
    "model.lm_head",        # the lm_head and its tensor-parallel gather
)
# The spans whose device-stream time is taken: those the benchmark's readers
# use. Under the profiler an event pair costs a decode step's host ~0.25 ms
# (PERF.md), so the other spans mark the host timeline only; the profiler's
# trace shows their device extent.
TIMED = ("engine.serve_chunk", "engine.admit", "engine.decode", "model.experts")
COUNTERS = (
    "sched.admit_tokens",         # prompt tokens admitted
    "sched.admit_padded_tokens",  # tokens the admission forwards run
)
_SPAN_SET, _TIMED_SET, _COUNTER_SET = frozenset(SPANS), frozenset(TIMED), frozenset(COUNTERS)

_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}
_events: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []


def enabled() -> bool:
    """Whether a ``torch.profiler`` profile is recording."""
    return _profiler._is_profiler_enabled


def _stream_timing() -> bool:
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class _Span:
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        if name not in _SPAN_SET:
            raise ValueError(f"undeclared span {name!r} (tracing.SPANS)")
        self.name = name
        self._range = torch.profiler.record_function(name)
        self._start = None

    def __enter__(self):
        self._range.__enter__()
        if self.name in _TIMED_SET and _stream_timing():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _events.append((self.name, self._start, end))
        return self._range.__exit__(*exc)


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline (and, for a
    ``TIMED`` name, times it on the device stream); a shared no-op while no
    profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    if name not in _COUNTER_SET:
        raise ValueError(f"undeclared counter {name!r} (tracing.COUNTERS)")
    _counts[name] = _counts.get(name, 0) + int(n)


def counts() -> dict[str, int]:
    """The counters recorded since the last ``reset``."""
    return dict(_counts)


def device_ms() -> dict[str, tuple[int, float]]:
    """``{span: (calls, device-stream ms summed)}`` over the ``TIMED`` spans
    recorded since the last ``reset``; waits for each span's end event."""
    out: dict[str, tuple[int, float]] = {}
    for name, start, end in _events:
        end.synchronize()
        calls, ms = out.get(name, (0, 0.0))
        out[name] = (calls + 1, ms + start.elapsed_time(end))
    return out


def reset() -> None:
    """Forget every counter and timed span."""
    _counts.clear()
    _events.clear()
