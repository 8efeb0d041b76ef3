"""The routed experts' share of the serve rounds' device time: the
device-stream ms of the program's ``model.experts`` spans over those of
its ``engine.serve_chunk`` spans, over the traced groups
(``benchlib/spans.py``)."""

NAME = "experts_share.chat"
UNIT = "%"
LAYER = "model"
MOVES = "gen_tok_s"

from h100bench.benchlib import spans


def read(obs):
    ms = spans.device_ms()
    experts, rounds = ms.get("model.experts"), ms.get("engine.serve_chunk")
    if experts is None or rounds is None or not rounds[1]:
        return None
    return 100.0 * experts[1] / rounds[1]
