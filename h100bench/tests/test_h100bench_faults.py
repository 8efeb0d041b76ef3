"""With the timed path broken underneath, a run (everything but the look
for a card) comes out not correct: once for each fault the cells can have.
A chat step that leaves its state (the KV cache) unchanged, half of the
batch left out (its logits replaced by the mean of the rest), a token
altered where it is produced. One-chip cells have no exchange between
chips."""

import torch

from h100bench.tests import tiny

SEED = 2**31 + 3  # a seed whose tiny window finishes several greedy requests


def _state_unchanged(engine):
    inner = engine._decode_step

    def step(cache, tokens, active):
        keep = {k: v.clone() for k, v in cache.items() if k != "lengths"}
        out = inner(cache, tokens, active)
        for k, v in keep.items():
            cache[k].copy_(v)
        return out

    engine._decode_step = step


def _half_batch(engine):
    inner = engine._decode_step

    def step(cache, tokens, active):
        logits = inner(cache, tokens, active)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half], logits[:half].mean(0, keepdim=True).expand(
            logits.shape[0] - half, -1)])

    engine._decode_step = step


def _token_altered(engine):
    inner = engine.serve_chunk
    vocab = engine.model.cfg.vocab_size

    def serve_chunk(cache, tokens, steps, **kw):
        cache, blob, carry = inner(cache, tokens, steps, **kw)
        blob = blob.clone()
        blob[:, 2] = (blob[:, 2] + 1) % vocab
        return cache, blob, carry

    engine.serve_chunk = serve_chunk


def test_sound_chat_run_is_correct():
    out = tiny.run("chat", tiny.chat_cell(), SEED, seconds=3.0)
    assert out.correct, [c.line() for c in out.checks]


def test_chat_faults_come_out_not_correct():
    for fault in (_state_unchanged, _half_batch, _token_altered):
        out = tiny.run("chat", tiny.chat_cell(), SEED, seconds=3.0, fault=fault)
        assert not out.correct, (fault.__name__, [c.line() for c in out.checks])
