"""Admission's share of the serve rounds' device time: the device-stream ms
of the program's ``engine.admit`` spans over those of its
``engine.serve_chunk`` spans, over the traced groups
(``benchlib/spans.py``)."""

NAME = "admit_share.chat"
UNIT = "%"
LAYER = "engine step"
MOVES = "ttft_p95_ms"

from h100bench.benchlib import spans


def read(obs):
    ms = spans.device_ms()
    admit, rounds = ms.get("engine.admit"), ms.get("engine.serve_chunk")
    if admit is None or rounds is None or not rounds[1]:
        return None
    return 100.0 * admit[1] / rounds[1]
