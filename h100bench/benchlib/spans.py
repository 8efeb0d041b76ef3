"""The program's own spans and counters over a traced window.

The port records them (``onnx_quantize_tpu_torch.tracing``) only while a
``torch.profiler`` profile runs, so in a ``--trace 1`` run the traced
groups carry them and the timed window does not. Besides ``program.py``
this is the one place where the benchmark reaches into the program, and
only to read: a program without that module (an older version) gives no
registry, and the readers built on it read nothing.

``idle_by_span`` splits the idle gaps between kernels by the innermost
program span open at each instant, ignoring operators and the benchmark's
own spans, which ``TraceReading.idle_gaps`` names instead.
"""

from __future__ import annotations

__all__ = ["registry", "device_ms", "counts", "idle_by_span", "idle_pct"]


def registry():
    """The program's tracing module, or None where the program has none."""
    try:
        from onnx_quantize_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def device_ms() -> dict:
    """``{span: (calls, device-stream ms)}`` of the program's timed spans."""
    reg = registry()
    return reg.device_ms() if reg is not None else {}


def counts() -> dict:
    """The program's counters."""
    reg = registry()
    return reg.counts() if reg is not None else {}


def _gaps(kernels) -> list[tuple[float, float]]:
    """The idle intervals between the union of the kernel intervals."""
    gaps, end = [], None
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def _innermost(host, names) -> list[tuple[float, float, str]]:
    """The host timeline cut into (start, end, name) pieces, each under one
    innermost span of ``names``, in order; instants under none are left out.
    A child that outlasts its parent (microsecond rounding) keeps its time."""
    pieces: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    t = float("-inf")

    def close(until: float) -> None:
        nonlocal t
        while stack and stack[-1][1] <= until:
            _, b, name = stack.pop()
            if b > t:
                pieces.append((t, b, name))
                t = b

    opened = sorted(((a, b, n) for n, a, b in host if n in names), key=lambda s: (s[0], -s[1]))
    for a, b, name in opened:
        close(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][2]))
        t = max(t, a)
        stack.append((a, b, name))
    close(float("inf"))
    return pieces


def idle_by_span(reading, names) -> dict:
    """Seconds of idle device time between kernels, by the innermost span of
    ``names`` open on the host; the time under none of them under None."""
    pieces = _innermost(reading.host, frozenset(names))
    by: dict = {}
    i = 0
    for ga, gb in _gaps(reading.kernels):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= ga:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < gb:
            a, b, name = pieces[j]
            part = min(gb, b) - max(ga, a)
            if part > 0:
                by[name] = by.get(name, 0.0) + part / 1e6
                covered += part
            j += 1
        by[None] = by.get(None, 0.0) + (gb - ga - covered) / 1e6
    return by


def idle_pct(reading, prefixes: tuple[str, ...]) -> float | None:
    """Share of the traced window (%) with no kernel running while the
    innermost program span starts with one of ``prefixes``; None without a
    device timeline or a program that carries spans."""
    reg = registry()
    if reading is None or not reading.kernels or reg is None:
        return None
    names = frozenset(reg.SPANS)
    if not any(n in names for n, _, _ in reading.host):
        return None
    by = idle_by_span(reading, names)
    idle = sum(s for name, s in by.items() if name is not None and name.startswith(prefixes))
    return 100.0 * idle / reading.window_s
