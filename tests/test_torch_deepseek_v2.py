"""DeepSeek-V2 on the port against the plain float32 reference
(``tests/plain_deepseek_v2.py``, the published decompressed form) at a tiny
size: three layers (the first dense), 8 routed experts top-3 with 2 shared,
rank 32, 16 + 16 query/key dims and 16 value dims a head, YaRN on.

Weights are a seeded state dict in the published names and layout (rope
dims in adjacent pairs), imported by ``deepseek_v2_tree``, which permutes
the rope columns to the port's halves; so every comparison below also
checks the import, the absorption of ``kv_b_proj`` and the latent cache.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch import tracing
from onnx_quantize_tpu_torch.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    SamplingParams,
    prepare_kernel_scales,
)
from onnx_quantize_tpu_torch.engine.scheduler import ADMIT_M_FLOOR, plan_admission
from onnx_quantize_tpu_torch.models.deepseek_v2 import (
    DEEPSEEK_V2_LITE,
    deepseek_v2_tree,
    load_deepseek_v2_hf,
    rope_pairs_to_halves,
    tiny_deepseek_v2_config,
)
from onnx_quantize_tpu_torch.models.gemma3 import (
    Gemma3,
    Gemma3MLP,
    Gemma3MoEMLP,
    fuse_gemma3_projections,
)
from onnx_quantize_tpu_torch.models.mla import latent_attend, softmax_scale
from onnx_quantize_tpu_torch.models.moe import fuse_moe_experts
from onnx_quantize_tpu_torch.nn.layers import yarn_inv_freq, yarn_mscale
from onnx_quantize_tpu_torch.engine.kv_cache import LatentKV
from tests import plain_deepseek_v2 as plain

torch.set_num_threads(1)

# The tiny model's config.json, in the published keys.
CFG = {
    "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "vocab_size": 256,
    "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 3,
    "moe_intermediate_size": 32, "n_shared_experts": 2, "first_k_dense_replace": 1,
    "norm_topk_prob": False, "routed_scaling_factor": 1.0, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "topk_method": "greedy", "scoring_func": "softmax",
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
}
SEED = 20240507

# Float32 against float32: the port sums the absorbed products (q_nope W_UK)
# . c and p . c W_UV where the reference forms k and v per head first, and it
# adds the routed experts in another order; both move a logit by float32
# rounding (measured: 6.0e-7 of the largest logit).
F32_TOL = 2e-5
# Through the int8 latent cache: the program and the reference round the same
# float32 rows to the same grid (measured: 6.2e-7 of the largest logit over
# the prompts below), but a row computed by a forward of another shape can
# land on the other side of a .5 tie, one code in a few thousand, which moves
# a logit by up to ~1e-5. The same reference with one scale a row reads
# 1.7e-2, with 4-bit codes 0.20, and without rounding the rows 1.6e-2.
INT8_TOL = 1e-4


def _state_dict(seed: int = SEED, pe_std: float = 0.02) -> dict:
    """Seeded weights under the checkpoint's names, (out, in). The rope
    columns of kv_a_proj_with_mqa are drawn at ``pe_std``, so k_pe is an
    order of magnitude smaller than the normalized c (where one scale for
    both parts coarsens k_pe)."""
    g = torch.Generator().manual_seed(seed)
    c = CFG
    H, nope, rope, r, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                            c["qk_rope_head_dim"], c["kv_lora_rank"], c["v_head_dim"])
    d = c["hidden_size"]

    def w(out, inp, std=0.12):
        return torch.randn((out, inp), generator=g) * std

    def gain(n):
        return 1.0 + 0.1 * torch.randn((n,), generator=g)

    sd = {"model.embed_tokens.weight": torch.randn((c["vocab_size"], d), generator=g),
          "model.norm.weight": gain(d), "lm_head.weight": w(c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        kv_a = w(r + rope, d)
        kv_a[r:] *= pe_std / 0.12
        sd.update({f"{p}.input_layernorm.weight": gain(d),
                   f"{p}.post_attention_layernorm.weight": gain(d),
                   f"{p}.self_attn.q_proj.weight": w(H * (nope + rope), d),
                   f"{p}.self_attn.kv_a_proj_with_mqa.weight": kv_a,
                   f"{p}.self_attn.kv_a_layernorm.weight": gain(r),
                   f"{p}.self_attn.kv_b_proj.weight": w(H * (nope + dv), r, 0.2),
                   f"{p}.self_attn.o_proj.weight": w(d, H * dv)})
        mlps = ([f"{p}.mlp"] if i < c["first_k_dense_replace"] else
                [f"{p}.mlp.experts.{e}" for e in range(c["n_routed_experts"])]
                + [f"{p}.mlp.shared_experts"])
        for m in mlps:
            width = (c["intermediate_size"] if m.endswith(".mlp") else
                     c["moe_intermediate_size"] * (c["n_shared_experts"]
                                                   if m.endswith("shared_experts") else 1))
            sd.update({f"{m}.gate_proj.weight": w(width, d), f"{m}.up_proj.weight": w(width, d),
                       f"{m}.down_proj.weight": w(d, width)})
        if i >= c["first_k_dense_replace"]:
            sd[f"{p}.mlp.gate.weight"] = w(c["n_routed_experts"], d, 0.3)
    return sd


def _port(sd=None, **cfg_kw):
    model = Gemma3(tiny_deepseek_v2_config(**cfg_kw))
    return model, deepseek_v2_tree(model, sd if sd is not None else _state_dict(),
                                   torch.float32, "cpu")


@pytest.fixture(scope="module")
def port():
    return _port()


@pytest.fixture(scope="module")
def sd():
    return _state_dict()


def _ids(n: int, seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], n).tolist()


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# -- YaRN and the softmax scale ------------------------------------------------


@pytest.mark.parametrize("dim,orig", [(64, 4096), (16, 64)])
def test_yarn_frequencies_and_mscale_follow_the_modelling_file(dim, orig):
    rs = dict(CFG["rope_scaling"], original_max_position_embeddings=orig)
    got = yarn_inv_freq(dim, 10000.0, 40.0, orig, 32.0, 1.0)
    torch.testing.assert_close(got, plain.yarn_inv_freq(dim, 10000.0, rs), rtol=1e-6, atol=0)
    # The ramp blends: the first frequencies are kept, the last divided by 40.
    base = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    assert got[0] == base[0] and torch.isclose(got[-1], base[-1] / 40)
    assert yarn_mscale(40.0, 0.707) == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert yarn_mscale(40.0, 0.707) == plain.yarn_mscale(40, 0.707)
    assert yarn_mscale(1.0, 0.707) == 1.0


def test_softmax_scale_is_the_originals():
    m = 0.1 * 0.707 * math.log(40) + 1  # 1.2608
    assert softmax_scale(DEEPSEEK_V2_LITE) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    no_yarn = dataclasses.replace(DEEPSEEK_V2_LITE, rope_yarn=None)
    assert softmax_scale(no_yarn) == pytest.approx(192 ** -0.5, rel=1e-12)


def test_rope_columns_regroup_pairs_into_halves():
    w = torch.arange(3 * 2 * 6, dtype=torch.float32).reshape(3, 12)  # 2 heads of 2 + 4
    got = rope_pairs_to_halves(w, heads=2, nope=2, rope=4)
    assert got[0].tolist() == [0, 1, 2, 4, 3, 5, 6, 7, 8, 10, 9, 11]
    kv_a = torch.arange(2 * 7, dtype=torch.float32).reshape(2, 7)  # rank 3 + rope 4
    assert rope_pairs_to_halves(kv_a, 1, 0, 4)[0].tolist() == [0, 1, 2, 3, 5, 4, 6]


# -- the model against the reference ----------------------------------------------


def test_structure_dense_first_layer_and_ungated_shared_experts(port):
    model, params = port
    assert isinstance(model.layers[0].mlp, Gemma3MLP)
    assert params["layers.0"]["mlp"]["down_proj"]["w"].shape == (96, 64)
    for block in model.layers[1:]:
        assert isinstance(block.mlp, Gemma3MoEMLP)
        assert hasattr(block.mlp, "shared") and not hasattr(block.mlp, "shared_gate")
    assert params["layers.1"]["mlp"]["shared"]["down_proj"]["w"].shape == (64, 64)
    # An MoE layer: the routed top-3 weighted unrenormalized, plus the shared MLP.
    mlp = model.layers[1].mlp
    x = torch.randn((5, 64), generator=torch.Generator().manual_seed(3))
    p = params["layers.1"]["mlp"]
    probs = torch.softmax(x @ p["router"]["w"], dim=-1)
    top_p, top_i = torch.topk(probs, 3, dim=-1)

    def silu_mlp(sub, rows):
        return (torch.nn.functional.silu(rows @ sub["gate_proj"]["w"])
                * (rows @ sub["up_proj"]["w"])) @ sub["down_proj"]["w"]

    want = silu_mlp(p["shared"], x)
    for t in range(5):
        for j in range(3):
            want[t] += top_p[t, j] * silu_mlp(p[f"experts.{int(top_i[t, j])}"], x[t:t + 1])[0]
    assert _rel(mlp(p, x), want) < F32_TOL


def test_prefill_logits_match_the_reference_in_float32(port, sd):
    model, params = port
    ids = _ids(40, 1)
    want = plain.forward(sd, CFG, ids)
    assert _rel(model(params, torch.tensor([ids]))[0], want) < F32_TOL
    eng = InferenceEngine(model, params, max_batch=2, max_seq=64, kv_quant=False)
    batch = np.zeros((2, 40), np.int32)
    batch[0], batch[1, :23] = ids, ids[:23]
    _, logits = eng.prefill(eng.new_cache(), batch, np.array([40, 23], np.int32))
    assert _rel(logits[0], want[39]) < F32_TOL and _rel(logits[1], want[22]) < F32_TOL


def _decompressed(q_nope, q_pe, c, k_pe, w_b, mask, cfg):
    """Attention in the published form: k = [c W_UK ; k_pe], v = c W_UV per head."""
    B, T, H, nope = q_nope.shape
    kv = (c @ w_b).reshape(B, -1, H, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None, :].expand(-1, -1, H, -1)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * softmax_scale(cfg) + mask
    out = torch.einsum("bhts,bshv->bthv", torch.softmax(scores, -1), kv[..., nope:])
    return out.reshape(B, T, H * cfg.v_head_dim)


def test_absorbed_attend_equals_the_decompressed_one(monkeypatch):
    cfg = tiny_deepseek_v2_config()
    g = torch.Generator().manual_seed(5)
    B, T, S, H = 2, 37, 37, cfg.num_heads
    q_nope = torch.randn((B, T, H, 16), generator=g)
    q_pe = torch.randn((B, T, H, 16), generator=g)
    c = torch.randn((B, S, 32), generator=g)
    k_pe = torch.randn((B, S, 16), generator=g)
    w_b = torch.randn((32, H * 32), generator=g) * 0.3
    mask = torch.where(torch.arange(S)[None, :] <= torch.arange(T)[:, None], 0.0, -1e30)
    mask = mask[None, None].expand(B, 1, T, S)
    want = _decompressed(q_nope, q_pe, c, k_pe, w_b, mask, cfg)
    got = latent_attend(q_nope, q_pe, LatentKV(torch.cat([c, k_pe], -1)), mask, w_b, cfg)
    assert _rel(got, want) < F32_TOL
    # In query blocks (a long prompt's path): the same numbers.
    monkeypatch.setattr("onnx_quantize_tpu_torch.models.mla._BLOCK_ELEMS", B * H * S * 5)
    blocked = latent_attend(q_nope, q_pe, LatentKV(torch.cat([c, k_pe], -1)), mask, w_b, cfg)
    assert torch.equal(blocked, got)


def _serve_logits(model, params, prompts, feed):
    """Prefill ``prompts`` through the int8 latent cache, then decode the
    ``feed`` tokens teacher-forced; each row's logits at every fed step."""
    eng = InferenceEngine(model, params, max_batch=len(prompts), max_seq=128, kv_quant=True)
    T = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    cache, logits = eng.prefill(eng.new_cache(), ids, np.array([len(p) for p in prompts]))
    steps = [logits]
    for t in range(len(feed[0])):
        cache, logits = eng.decode(cache, np.array([f[t] for f in feed]))
        steps.append(logits)
    assert cache["latent"].dtype == torch.int8 and cache["latent_scale"].shape[-1] == 2
    return torch.stack(steps, dim=1)


@pytest.fixture(scope="module")
def served(port):
    model, params = port
    prompts, feed = [_ids(21, 2), _ids(9, 3)], [_ids(12, 4), _ids(12, 5)]
    return prompts, feed, _serve_logits(model, params, prompts, feed)


def _worst(sd, prompts, feed, got, latent):
    worst = 0.0
    for row, (p, f) in enumerate(zip(prompts, feed)):
        want = plain.forward(sd, CFG, p + f, latent=latent)[len(p) - 1:]
        worst = max(worst, _rel(got[row], want))
    return worst


def test_prefill_then_decode_through_the_int8_latent_cache(sd, served):
    prompts, feed, got = served
    assert _worst(sd, prompts, feed, got, "int8") < INT8_TOL


@pytest.mark.parametrize("latent", ["int8_one_scale", "int4"])
def test_coarser_latent_caches_fail_the_tight_tolerance(sd, served, latent):
    """The controls: the reference with one scale a row, or with 4-bit codes,
    in the cache's place reads farther from the program than INT8_TOL."""
    prompts, feed, got = served
    assert _worst(sd, prompts, feed, got, latent) > 5 * INT8_TOL


def test_the_engine_refuses_what_a_latent_cache_lacks(port):
    model, params = port
    with pytest.raises(ValueError, match="latent cache"):
        InferenceEngine(model, params, max_batch=2, max_seq=128, kv_quant="int4")
    with pytest.raises(ValueError, match="fused_attention"):
        InferenceEngine(model, params, max_batch=2, max_seq=128, kv_quant=True,
                        fused_attention=True)


# -- admission: the prefix, the plan ---------------------------------------------


def _w4(model, params, group: int = 16):
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=group),
        ignore=["lm_head", r"\.router$", r"\.kv_b_proj$"]))
    return fuse_moe_experts(prepare_kernel_scales(fuse_gemma3_projections(q)))


@pytest.fixture(scope="module")
def w4(port):
    model, params = port
    tree = _w4(model, params)
    assert "_fused_qa" in tree["layers.1"]["attn"] and "_fused_experts" in tree["layers.1"]["mlp"]
    return model, tree


def test_prefix_admission_equals_the_whole_prompt(w4):
    """register_prefix's rows, then a suffix admitted behind them, give the
    whole prompt's logits and cache rows."""
    model, tree = w4
    prefix, suffix = _ids(40, 6), _ids(13, 7)
    eng = InferenceEngine(model, tree, max_batch=4, max_seq=128, kv_quant=True)
    rows = eng.prefill_prefix(prefix)
    assert set(rows) == {"latent", "latent_scale"} and rows["latent"].shape == (3, 40, 48)
    cache = eng.new_cache()
    got = eng._admit_prefill(cache, [np.array([suffix + [0] * 3])], np.array([53]),
                             np.array([2]), rows, [True])[0]
    whole = eng.new_cache()
    want = eng._admit_prefill(whole, np.array([prefix + suffix]), np.array([53]),
                              np.array([2]))[0]
    assert _rel(got, want) < INT8_TOL
    assert int(cache["lengths"][2]) == int(whole["lengths"][2]) == 53
    diff = (cache["latent"][:, 2, :53].int() - whole["latent"][:, 2, :53].int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
    assert not cache["latent"][:, [0, 1, 3]].any()  # no other slot touched


def test_prefix_requests_in_serve_mode_equal_their_whole_prompts(w4):
    """Serve mode, chunk 4, pipeline 2: requests behind the registered prefix
    are admitted narrow, as sub-forwards of their own beside plain ones (no
    masked prefill call), and emit the tokens of their whole prompts."""
    model, tree = w4
    prefix = _ids(48, 8)
    suffixes = [_ids(n, 10 + n) for n in (5, 17, 30, 9, 12, 26)]
    plain_one = _ids(11, 9)

    def run(use_prefix: bool):
        eng = InferenceEngine(model, tree, max_batch=16, max_seq=128, kv_quant=True)
        sched = ContinuousBatchingScheduler(eng, chunk=4, pipeline=2)
        calls = []
        eng.prefill = lambda *a, **k: calls.append(a)  # the masked path: not taken
        if use_prefix:
            sched.register_prefix(prefix)
        reqs = [sched.submit(s if use_prefix else prefix + s, max_new_tokens=6,
                             use_prefix=use_prefix) for s in suffixes]
        reqs.append(sched.submit(plain_one, max_new_tokens=5))
        sched.run()
        assert not calls
        return [r.output for r in reqs]

    got = run(True)
    assert got == run(False)
    assert [len(o) for o in got] == [6] * 6 + [5]


# Prompts over three buckets (F = ADMIT_M_FLOOR): the plan runs three forwards.
SPREAD = [2 * ADMIT_M_FLOOR - 3, 10, ADMIT_M_FLOOR - 20, 12, 2 * ADMIT_M_FLOOR - 40, 11]


def test_plan_sub_forwards_equal_one_forward(w4):
    model, tree = w4

    def serve(split: bool):
        eng = InferenceEngine(model, tree, max_batch=16, max_seq=2 * ADMIT_M_FLOOR + 64,
                              kv_quant=True)
        eng.rows_independent = split
        shapes = []
        run = eng._admit_forward
        eng._admit_forward = lambda *a: (shapes.append(tuple(a[1].shape)), run(*a))[1]
        sched = ContinuousBatchingScheduler(eng, generator=torch.Generator().manual_seed(2),
                                            chunk=2)
        sampled = SamplingParams(temperature=0.8, top_k=20)
        reqs = [sched.submit(_ids(n, 20 + i), max_new_tokens=3,
                             sampling=sampled if i % 3 == 1 else SamplingParams())
                for i, n in enumerate(SPREAD)]
        sched.step()
        return [r.output for r in reqs], sched.cache, shapes

    split, cache, shapes = serve(True)
    one, cache1, shapes1 = serve(False)
    assert len(plan_admission(SPREAD, 2 * ADMIT_M_FLOOR + 64)) == len(shapes) == 3
    assert shapes1 == [(8, 2 * ADMIT_M_FLOOR)]
    assert split == one
    for slot, n in enumerate(cache["lengths"].tolist()[:len(SPREAD)]):
        diff = (cache["latent"][:, slot, :n].int() - cache1["latent"][:, slot, :n].int()).abs()
        assert diff.max() <= 1 and (diff > 0).float().mean() <= 1e-3
        torch.testing.assert_close(cache["latent_scale"][:, slot, :n],
                                   cache1["latent_scale"][:, slot, :n], rtol=1e-5, atol=0)


def test_latent_counters_count_rows_and_pairs(w4):
    """While tracing: each attend's live latent rows and visible pairs,
    summed over the rows and layers, with no host read where counted."""
    from torch.profiler import ProfilerActivity, profile

    model, tree = w4
    eng = InferenceEngine(model, tree, max_batch=4, max_seq=128, kv_quant=True)
    sched = ContinuousBatchingScheduler(eng, chunk=2)
    sched.register_prefix(_ids(20, 30))
    lengths = [7, 12]
    for n in lengths:
        sched.submit(_ids(n, n), max_new_tokens=3, use_prefix=True)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        sched.step()
    got = tracing.counts()
    tracing.reset()
    L, P = 3, 20
    rows = sum(P + n for n in lengths) + sum(P + n + s for n in lengths for s in (1, 2))
    pairs = (sum(n * P + n * (n + 1) // 2 for n in lengths)
             + sum(P + n + s for n in lengths for s in (1, 2)))
    assert got["attn.latent_rows"] == L * rows and got["attn.latent_pairs"] == L * pairs


# -- the Hugging Face checkpoint ------------------------------------------------


def _save_safetensors(path, sd: dict) -> None:
    """A safetensors file: the 8-byte header length, the JSON header, the bytes."""
    header, blobs, at = {}, [], 0
    for name, t in sd.items():
        b = t.contiguous().to(torch.float32).numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def test_load_deepseek_v2_hf_reads_a_synthetic_checkpoint(tmp_path, sd):
    half = len(sd) // 2
    names = list(sd)
    _save_safetensors(tmp_path / "model-00001.safetensors", {k: sd[k] for k in names[:half]})
    _save_safetensors(tmp_path / "model-00002.safetensors", {k: sd[k] for k in names[half:]})
    model = Gemma3(tiny_deepseek_v2_config())
    params = load_deepseek_v2_hf(model, str(tmp_path), device="cpu")
    ids = _ids(30, 11)
    assert _rel(model(params, torch.tensor([ids]))[0], plain.forward(sd, CFG, ids)) < F32_TOL
    assert set(params["layers.1"]["mlp"]) == {"router", "shared"} | {
        f"experts.{e}" for e in range(8)}
    assert set(params["layers.0"]["attn"]) == {"q_proj", "kv_a_proj", "kv_a_norm", "kv_b_proj",
                                               "o_proj"}


def test_witness_against_transformers_without_rope_scaling(tmp_path):
    """Hugging Face's DeepseekV2ForCausalLM at rope_scaling None, the one
    setting where its softmax scale and the original's agree, saved and read
    back through load_deepseek_v2_hf."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = {k: v for k, v in CFG.items() if k != "rope_scaling"}
    conf = transformers.DeepseekV2Config(**hf_cfg, rope_scaling=None, attention_bias=False,
                                         tie_word_embeddings=False, n_group=1, topk_group=1)
    conf._attn_implementation = "eager"
    torch.manual_seed(0)
    hf = transformers.DeepseekV2ForCausalLM(conf).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.normal_(0.0, 0.1)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    model = Gemma3(tiny_deepseek_v2_config(rope_yarn=None))
    params = load_deepseek_v2_hf(model, str(tmp_path), device="cpu")
    ids = torch.tensor([_ids(24, 12)])
    with torch.no_grad():
        want = hf(ids).logits[0]
    assert _rel(model(params, ids)[0], want) < F32_TOL
