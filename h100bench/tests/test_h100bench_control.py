"""The controls come out not correct: a precision below the configuration's
(the reference with a 4-bit KV cache or with fp8 activations in the
program's place, and the program's own int4 cache) fails a limit that the
program's own runs pass. At the tiny size on the CPU; on the card the same
comparisons run at the cell's size (``h100bench/control.py``, PERF.md)."""

import pytest

from h100bench.tests import tiny

SEEDS = [2**31 + s for s in (0, 3, 5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_chat_controls_fail_the_limit_the_program_passes(seed):
    out = tiny.run("chat", tiny.chat_cell(), seed, seconds=2.0, controls=("kv4", "fp8"))
    assert out.correct, [c.line() for c in out.checks]
    assert out.obs["controls"]["kv4"]["max_gap"] > tiny.TINY_LIMITS["max_gap"], out.info
    assert out.obs["controls"]["fp8"]["mean_gap"] > tiny.TINY_LIMITS["mean_gap"], out.info


@pytest.mark.parametrize("seed", SEEDS)
def test_the_programs_int4_cache_fails_the_limit(seed):
    # The program's own path a precision below the configuration's int8 cache,
    # judged against the same reference (control.py --engine kv_cache='"int4"').
    cell = tiny.chat_cell()
    cell.traffic["engine"] = dict(cell.traffic["engine"], kv_cache="int4", fused_attention=False)
    out = tiny.run("chat", cell, seed, seconds=2.0)
    assert not out.correct
    assert out.checks[0].name == "max_gap" and not out.checks[0].ok
