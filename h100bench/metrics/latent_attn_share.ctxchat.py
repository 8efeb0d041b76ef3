"""The latent attention's share of the serve rounds' device time: the
device-stream ms of the program's ``model.latent_attention`` spans (the
attend over the latent rows, from the absorbed queries to the W_UV
product, admission and decode) over those of its ``engine.serve_chunk``
spans, over the traced groups (``benchlib/spans.py``)."""

NAME = "latent_attn_share.ctxchat"
UNIT = "%"
LAYER = "model"
MOVES = "tpot_p95_ms"

from h100bench.benchlib import spans


def read(obs):
    ms = spans.device_ms()
    attn, rounds = ms.get("model.latent_attention"), ms.get("engine.serve_chunk")
    if attn is None or rounds is None or not rounds[1]:
        return None
    return 100.0 * attn[1] / rounds[1]
