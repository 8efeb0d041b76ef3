"""Share of the traced window with no kernel running while the innermost
program span on the host is the engine's or the model's (``engine.*``,
``model.*``): the host between launches inside the serve rounds
(``benchlib/spans.py``)."""

NAME = "idle_forward_pct.chat"
UNIT = "%"
LAYER = "model"
MOVES = "gen_tok_s"

from h100bench.benchlib import spans


def read(obs):
    return spans.idle_pct(obs.get("trace"), ("engine.", "model."))
