"""The window over the decode steps run in it (rounds x chunk)."""

NAME = "step_ms.chat"
UNIT = "ms"
LAYER = "engine step"
MOVES = "gen_tok_s"


def read(obs):
    return obs.get("step_ms")
