"""The DeepSeek-V2 cell's parts at a tiny size on the CPU: the ``ctxchat``
driver end to end, the MLA reference against the port's model, the new
readers on a synthetic trace, the work counts by hand, and the faults and
controls reading ``correct`` false."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from h100bench.benchlib import program_mla, spans, weights_mla
from h100bench.benchlib.cells import BENCH, Cell, _module, load_benchmark
from h100bench.benchlib.roofline import H100
from h100bench.benchlib.roofline_mla import WorkMLA
from h100bench.benchlib.trace import TraceReading
from h100bench.reference import judge_mla
from h100bench.reference.deepseek_v2 import ReferenceMLA
from h100bench.tests import tiny, tiny_mla

SEED = 2**31 + 3
LITE = json.loads((BENCH / "configs" / "deepseek-v2-lite.w4g64.json").read_text())


def test_sound_ctxchat_run_is_correct_and_reports_its_metrics(monkeypatch):
    from h100bench.benchlib import trace as tr

    monkeypatch.setattr(tr, "traced", tiny.host_traced)  # no device timeline here
    out = tiny.run("ctxchat", tiny_mla.ctx_cell(), SEED, seconds=2.0, trace=True)
    assert out.correct, [c.line() for c in out.checks]
    assert out.e2e["gen_tok_s"] > 0 and out.e2e["setup_s"] > 0
    assert out.obs["model_flops"] > 0 and 0 < out.obs["occupancy"] <= 100
    assert out.obs["least_s"]["w4"] > 0
    assert any("prefix of 64 registered" in line for line in out.info)


def _state_unchanged(engine):
    inner = engine._decode_step

    def step(cache, tokens, active):
        keep = {k: v.clone() for k, v in cache.items() if k != "lengths"}
        out = inner(cache, tokens, active)
        for k, v in keep.items():
            cache[k].copy_(v)
        return out

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


def _prefix_at_wrong_offset(engine):
    """The prefix implanted 16 positions late: row p holds prefix row p - 16,
    the first 16 rows what an empty cache holds, the last 16 prefix rows
    lost."""
    inner = engine.prefill_prefix

    def prefill_prefix(tokens):
        out = {}
        for k, v in inner(tokens).items():
            out[k] = torch.zeros_like(v)
            out[k][:, 16:] = v[:, :-16]
        return out

    engine.prefill_prefix = prefill_prefix


@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered, _prefix_at_wrong_offset])
def test_ctxchat_faults_come_out_not_correct(fault):
    out = tiny.run("ctxchat", tiny_mla.ctx_cell(), SEED, seconds=2.0, fault=fault)
    assert not out.correct, (fault.__name__, [c.line() for c in out.checks])


@pytest.mark.parametrize("seed", [2**31 + s for s in (0, 3, 13)])
def test_ctxchat_controls_fail_the_limit_the_program_passes(seed):
    # Eight greedy requests of 32 tokens behind the prefix, served to their
    # end by the cell's program and scheduler: a timed window would finish
    # fewer on a loaded machine, and a few requests can all agree with the
    # reference and its controls.
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine

    cell = tiny_mla.ctx_cell()
    built = program_mla.build_program(cell.config, seed, "cpu")
    engine = InferenceEngine(built.model, built.tree, max_batch=16, max_seq=256,
                             kv_quant="int8", dtype=built.dtype, fused_attention=False)
    sched = ContinuousBatchingScheduler(engine, chunk=8, pipeline=2)
    rng = np.random.default_rng([seed, 5])
    prefix = rng.integers(0, 256, 64).tolist()
    sched.register_prefix(prefix)
    reqs = [sched.submit(rng.integers(0, 256, n).tolist(), max_new_tokens=32, use_prefix=True)
            for n in (8, 12, 16, 20, 24, 32, 40, 64)]
    sched.run()
    got = judge_mla.served_gaps(cell.config, seed, "cpu", prefix,
                                [(r.prompt, r.output) for r in reqs], ("kv4", "fp8"))
    limits = tiny_mla.TINY_MLA_LIMITS
    assert got["tokens"] == 256
    assert got["max_gap"] <= limits["max_gap"] and got["mean_gap"] <= limits["mean_gap"], got
    assert got["control_kv4"]["max_gap"] > limits["max_gap"], got
    assert got["control_fp8"]["mean_gap"] > limits["mean_gap"], got


def test_reference_logits_match_the_port_through_the_int8_latent_cache():
    """The reference (decompressed, pairs rope, its own RTN) against the
    port's program (absorbed, halves rope after the import's permutation, the
    port's RTN), float32 stream, a prompt behind a prefix."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    cfg = copy.deepcopy(tiny_mla.TINY_MLA)  # a float32 stream
    built = program_mla.build_program(cfg, SEED, "cpu")
    eng = InferenceEngine(built.model, built.tree, max_batch=2, max_seq=128, kv_quant=True)
    rng = np.random.default_rng(1)
    prefix, suffix = rng.integers(0, 256, 40).tolist(), rng.integers(0, 256, 17).tolist()
    rows = eng.prefill_prefix(prefix)
    logits = eng._admit_prefill(eng.new_cache(), [np.array([suffix])], np.array([57]),
                                np.array([1]), rows, [True])[0]
    ref = ReferenceMLA(cfg, SEED, "cpu")
    want = ref.logits(ref.final_hidden(prefix, [suffix])[0][-1:], ref.lm_head())[0]
    # Float32 against float32 through the same int8 rows: reassociation only.
    assert (logits[0].to(torch.float32) - want).abs().max() <= 1e-4 * want.abs().max()
    # The shared prefix computed once reads as the whole sequence would.
    whole = ref.final_hidden(prefix + suffix[:5], [suffix[5:]])[0]
    torch.testing.assert_close(whole, ref.final_hidden(prefix, [suffix])[0][5:], rtol=1e-4,
                               atol=1e-5)


def test_served_gaps_read_zero_for_the_references_own_tokens():
    cfg = copy.deepcopy(tiny_mla.TINY_MLA)
    ref = ReferenceMLA(cfg, SEED, "cpu")
    rng = np.random.default_rng(2)
    prefix, suffix = rng.integers(0, 256, 30).tolist(), rng.integers(0, 256, 9).tolist()
    served, head = [], ref.lm_head()
    for _ in range(5):
        h = ref.final_hidden(prefix, [suffix + served])[0][-1:]
        served.append(int(ref.logits(h, head).argmax()))
    got = judge_mla.served_gaps(cfg, SEED, "cpu", prefix, [(suffix, served)])
    assert got["max_gap"] == 0.0 and got["argmax_share"] == 1.0 and got["tokens"] == 5
    wrong = served[:2] + [(served[2] + 1) % 256] + served[3:]
    assert judge_mla.served_gaps(cfg, SEED, "cpu", prefix, [(suffix, wrong)])["max_gap"] > 0


def test_work_counts_by_hand_at_deepseek_v2_lite():
    w = WorkMLA(LITE)
    assert w.latent_row_bytes == 584
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    assert w.active_params() == 27 * attn + 3 * 2048 * 10944 + 26 * moe == 2_241_593_344
    # A decode step of 64 sequences at 17,400 rows: memory-bound, ~5.2 ms.
    rows = 64 * 17_400 * 27
    assert w.latent_least_s(rows, rows) == pytest.approx(rows * 584 / 3.35e12)
    pairs = 10 ** 9
    assert w.latent_least_s(1, pairs) == pytest.approx(pairs * 16 * 2 * 1088 / 989e12)
    # W4 at one token reads the weights once: memory-bound. q_proj beside
    # kv_a_proj, o_proj, the dense MLP of layer 0, then 26 layers of 64
    # experts and the 2,816-wide shared MLP; a g64 group adds 2.5 bytes.
    def w4_bytes(k, n):
        return k * n / 2 + k / 64 * n * 2.5

    weights = (27 * (w4_bytes(2048, 3648) + w4_bytes(2048, 2048))
               + w4_bytes(2048, 2 * 10944) + w4_bytes(10944, 2048)
               + 26 * (64 * (w4_bytes(2048, 2816) + w4_bytes(1408, 2048))
                       + w4_bytes(2048, 5632) + w4_bytes(2816, 2048)))
    rows = 2 * (27 * (2048 + 3648 + 2048 + 2048) + (2048 + 21888 + 10944 + 2048)
                + 26 * (6 * (2048 + 2816 + 1408 + 2048) + 2048 + 5632 + 2816 + 2048))
    assert w.w4_least_s(1) == pytest.approx((weights + rows) / 3.35e12)
    assert w.flops(1, 100, 1) == pytest.approx(2 * 2_241_593_344 + 2 * 2048 * 102_400
                                               + 2 * 100 * 16 * 320 * 27)


def test_the_config_holds_the_published_sizes():
    s = weights_mla.ShapesMLA(LITE)
    assert (s.hidden, s.layers, s.heads, s.rank, s.nope, s.rope, s.v_dim) == (
        2048, 27, 16, 512, 128, 64, 128)
    assert (s.experts, s.top_k, s.expert_width, s.shared_width, s.dense_width) == (
        64, 6, 1408, 2816, 10944)
    assert LITE["reduced"] == [] and not LITE["norm_topk_prob"]
    pcfg = program_mla.port_config(LITE)
    from onnx_quantize_tpu_torch.models.deepseek_v2 import DEEPSEEK_V2_LITE

    assert pcfg == dataclasses.replace(DEEPSEEK_V2_LITE, dtype="bfloat16")


def _reader(name):
    return _module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_new_readers_on_a_synthetic_trace(monkeypatch):
    reading = TraceReading(window_s=2.0, kernels=[("k", 0.0, 1.5e6)], host=[])
    monkeypatch.setattr(spans, "device_ms", lambda: {
        "model.latent_attention": (54, 300.0), "engine.serve_chunk": (2, 1200.0)})
    monkeypatch.setattr(spans, "counts", lambda: {"attn.latent_rows": 3 * 10 ** 7,
                                                  "attn.latent_pairs": 4 * 10 ** 7})
    obs = {"trace": reading, "model_flops": 9.89e12, "config": LITE, "least_s": {"w4": 0.3}}
    assert _reader("latent_attn_share.ctxchat").read(obs) == pytest.approx(25.0)
    least = max(3e7 * 584 / 3.35e12, 4e7 * 16 * 2 * 1088 / 989e12)
    assert _reader("latent_attn_roofline.ctxchat").read(obs) == pytest.approx(
        100 * least / 0.3)
    # The chat cells' readers of the driver's tally read this cell the same way.
    assert _reader("mfu.chat").read(obs) == pytest.approx(
        100 * 9.89e12 / (2.0 * H100.peak_ops_per_s("bf16")))
    w4 = TraceReading(window_s=2.0, kernels=[("w4_mma_kernel<2,2,4>", 0.0, 1.2e6),
                                             ("elementwise", 1.2e6, 1.5e6)], host=[])
    assert _reader("w4_roofline.chat").read(dict(obs, trace=w4)) == pytest.approx(25.0)
    # Nothing to read (a program without the spans or counters): no value.
    monkeypatch.setattr(spans, "device_ms", lambda: {})
    monkeypatch.setattr(spans, "counts", lambda: {})
    assert _reader("latent_attn_share.ctxchat").read(obs) is None
    assert _reader("latent_attn_roofline.ctxchat").read(obs) is None
    assert _reader("mfu.chat").read({}) is None
    assert _reader("w4_roofline.chat").read({"trace": w4}) is None


def test_the_new_cells_find_their_parts():
    bench = load_benchmark()
    ds = Cell(bench, "deepseek-v2-lite.chat-ctx16k")
    assert ds.entry["chips"] == 1
    assert {m["name"] for m in ds.end_to_end} == {"gen_tok_s", "ttft_p95_ms", "tpot_p95_ms",
                                                  "setup_s"}
    names = {m["name"] for m in ds.per_layer}
    assert {"latent_attn_share.ctxchat", "latent_attn_roofline.ctxchat", "w4_roofline.chat",
            "mfu.chat"} <= names
    assert "flash_decode_roofline.chat" not in names
    assert ds.traffic["kind"] == "ctxchat" and ds.traffic["prefix"]["tokens"] == 16384
