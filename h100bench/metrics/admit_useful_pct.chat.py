"""The share of the tokens the admission forwards run that are prompt
tokens: 100 x the program's ``sched.admit_tokens`` over its
``sched.admit_padded_tokens`` (rows bucketed to a power of two, or the
whole batch, times the longest prompt bucketed to 64), over the traced
groups (``benchlib/spans.py``)."""

NAME = "admit_useful_pct.chat"
UNIT = "%"
LAYER = "scheduler"
MOVES = "ttft_p95_ms"

from h100bench.benchlib import spans


def read(obs):
    got = spans.counts()
    padded = got.get("sched.admit_padded_tokens")
    if not padded:
        return None
    return 100.0 * got.get("sched.admit_tokens", 0) / padded
