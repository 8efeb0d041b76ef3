"""The work counts equal hand counts at Qwen1.5-MoE-A2.7B's and
Mixtral-8x7B's shapes, and the peaks are the frozen H100 SXM data sheet."""

import json

import pytest

from h100bench.benchlib.cells import BENCH
from h100bench.benchlib.roofline import H100, Work, bound

QWEN = json.loads((BENCH / "configs" / "qwen1.5-moe-a2.7b.w4g64.json").read_text())
# Mixtral-8x7B's shapes (its Hugging Face config.json) under a W4 g128 recipe.
MIXTRAL = {"hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32,
           "num_key_value_heads": 8, "head_dim": 128, "num_experts": 8, "num_experts_per_tok": 2,
           "moe_intermediate_size": 14336, "shared_expert_intermediate_size": 0,
           "vocab_size": 32000, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
           "recipe": {"body": {"group_size": 128}}}
BW = 3350e9


def test_peaks_and_bound():
    assert H100.peak_ops_per_s("bf16") == 989e12 and H100.hbm_bytes_per_s == BW
    assert H100.peak_ops_per_s("float32") == 67e12 and H100.peak_ops_per_s("int8") == 1979e12
    assert bound(BW, 1.0, "bf16") == pytest.approx(1.0)
    assert bound(1.0, 989e12, "bf16") == pytest.approx(1.0)


def test_active_parameters_by_hand():
    # Qwen: q,k,v (2048 -> 3 x 2048) and o; 4 of 60 experts of 3 x 2048 x 1408; the
    # shared expert 3 x 2048 x 5632; 24 layers. With its lm_head and embedding this
    # is the "A2.7B" of the name.
    qwen = 24 * (2048 * 6144 + 2048 * 2048 + 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632)
    assert Work(QWEN).active_params() == qwen == 2_063_597_568
    # Mixtral: q (32 heads) and k, v (8 heads) of 128, o; 2 of 8 experts of 3 x 4096 x 14336.
    mixtral = 32 * (4096 * (32 + 16) * 128 + 4096 * 4096 + 2 * 3 * 4096 * 14336)
    assert Work(MIXTRAL).active_params() == mixtral == 12_616_466_432


def test_w4_least_time_of_a_qwen_decode_step_by_hand():
    m = 256

    def w4(k, n, gs=64):
        return k * n / 2 + (k / gs) * n * 2.5  # codes, bf16 scale, 4-bit zero point

    sites = [  # (bytes, ops)
        (w4(2048, 6144) + m * (2048 + 6144) * 2, 2 * m * 2048 * 6144),
        (w4(2048, 2048) + m * (2048 + 2048) * 2, 2 * m * 2048 * 2048),
        (60 * w4(2048, 2816) + m * 4 * (2048 + 2816) * 2, 2 * m * 4 * 2048 * 2816),
        (60 * w4(1408, 2048) + m * 4 * (1408 + 2048) * 2, 2 * m * 4 * 1408 * 2048),
        (w4(2048, 11264) + m * (2048 + 11264) * 2, 2 * m * 2048 * 11264),
        (w4(5632, 2048) + m * (5632 + 2048) * 2, 2 * m * 5632 * 2048),
    ]
    want = 24 * sum(max(b / BW, o / 989e12) for b, o in sites)
    assert Work(QWEN).w4_least_s(m) == pytest.approx(want, rel=1e-12)
    # At a decode batch every site is bound by its bytes, most of them the 60
    # experts' weights.
    assert 2.4e-3 < want < 3.2e-3


def test_w4_least_time_of_a_mixtral_admission_by_hand():
    m = 4096  # admitted prompt tokens in one forward

    def w4(k, n, gs=128):
        return k * n / 2 + (k / gs) * n * 2.5

    sites = [
        (w4(4096, 6144) + m * (4096 + 6144) * 2, 2 * m * 4096 * 6144),
        (w4(4096, 4096) + m * (4096 + 4096) * 2, 2 * m * 4096 * 4096),
        (8 * w4(4096, 28672) + m * 2 * (4096 + 28672) * 2, 2 * m * 2 * 4096 * 28672),
        (8 * w4(14336, 4096) + m * 2 * (14336 + 4096) * 2, 2 * m * 2 * 14336 * 4096),
    ]
    want = 32 * sum(max(b / BW, o / 989e12) for b, o in sites)
    assert Work(MIXTRAL).w4_least_s(m) == pytest.approx(want, rel=1e-12)


def test_flash_decode_by_hand():
    # 4 Qwen slots with 1000 live rows among them: int8 K and V rows of 16 heads x 128
    # with a float32 scale each, float32 queries and outputs; QK and PV 2 flops each.
    by = 1000 * 16 * (2 * 128 + 8) + 4 * 16 * 128 * 8
    want = 24 * max(by / BW, 4 * 1000 * 16 * 128 / 67e12)
    assert Work(QWEN).flash_decode_least_s(1000, 4) == pytest.approx(want, rel=1e-12)
    # Mixtral's 32 query heads read 8 KV heads.
    by = 1000 * 8 * (2 * 128 + 8) + 4 * 32 * 128 * 8
    want = 32 * max(by / BW, 4 * 1000 * 32 * 128 / 67e12)
    assert Work(MIXTRAL).flash_decode_least_s(1000, 4) == pytest.approx(want, rel=1e-12)


def test_model_flops_by_hand():
    w = Work(QWEN)
    # A Qwen decode step of 256 slots at 500 live rows each, logits for all.
    want = (2 * 256 * 2_063_597_568 + 2 * 256 * 2048 * 151_936
            + 4 * 256 * 500 * 16 * 128 * 24)
    assert w.flops(256, 256 * 500, 256) == pytest.approx(want, rel=1e-12)
    # An admission of a 1020-token prompt: every token through the body and
    # causal attention, only the last through the lm_head.
    want = (2 * 1020 * 2_063_597_568 + 2 * 1 * 2048 * 151_936
            + 4 * (1020 * 1021 // 2) * 16 * 128 * 24)
    assert w.flops(1020, Work.causal_context(1020), 1) == pytest.approx(want, rel=1e-12)
