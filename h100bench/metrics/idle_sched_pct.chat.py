"""Share of the traced window with no kernel running while the innermost
program span on the host is the scheduler's (``sched.*``): planning, the
group's fetch and its unpacking (``benchlib/spans.py``)."""

NAME = "idle_sched_pct.chat"
UNIT = "%"
LAYER = "scheduler"
MOVES = "gen_tok_s"

from h100bench.benchlib import spans


def read(obs):
    return spans.idle_pct(obs.get("trace"), ("sched.",))
