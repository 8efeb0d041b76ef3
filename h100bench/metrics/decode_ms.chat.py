"""The mean device-stream ms of one decode step of the serve rounds (the
program's ``engine.decode`` span: forward, sampling, freezes), over the
traced groups (``benchlib/spans.py``)."""

NAME = "decode_ms.chat"
UNIT = "ms"
LAYER = "engine step"
MOVES = "tpot_p95_ms"

from h100bench.benchlib import spans


def read(obs):
    step = spans.device_ms().get("engine.decode")
    if step is None or not step[0]:
        return None
    return step[1] / step[0]
