"""The scheduler's emitted tokens over its slot-steps in the window
(``scheduler.stats``): the share of the fixed batch's decode that served a
token."""

NAME = "occupancy.chat"
UNIT = "%"
LAYER = "scheduler"
MOVES = "gen_tok_s"


def read(obs):
    return obs.get("occupancy")
