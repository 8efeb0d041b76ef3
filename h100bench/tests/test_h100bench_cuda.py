"""On the card: the tiny chat cell through the port's CUDA kernels (W4,
W8, flash decode) passes against the reference, and a served token altered
where it is produced fails it. Run with
``python -m pytest h100bench/tests -m cuda``; skips without a card."""

import pytest
import torch

from h100bench.tests import tiny
from h100bench.tests.test_h100bench_faults import SEED, _token_altered


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_tiny_chat_on_the_card(card):
    out = tiny.run("chat", tiny.chat_cell(), SEED, seconds=3.0, device=card)
    assert out.correct, [c.line() for c in out.checks]
    out = tiny.run("chat", tiny.chat_cell(), SEED, seconds=3.0, device=card,
                   fault=_token_altered)
    assert not out.correct, [c.line() for c in out.checks]
