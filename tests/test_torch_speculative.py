"""The port's speculative decoding (``engine/speculative.py``) and its window
write (``kv_cache.write_kv_window``) against the JAX package's.

Counterpart of ``tests/engine/test_speculative.py``: every case runs the
port's ``SpeculativeDecoder`` and holds its stream to the target-only greedy
stream, as the JAX test does, and also to JAX's own speculative stream on the
same bridged weights (greedy: token for token; the blob of a ``decode`` call:
equal). Sampled streams draw from a ``torch.Generator``, which cannot
reproduce ``jax.random``'s draws, so the rejection scheme's arithmetic
(``accept_core``) is held to JAX's given JAX's own accept draws, and the
port's sampled stream to the JAX test's relations (repeatable, budgeted,
stopped at EOS, the Monte-Carlo marginal).

Weights: the JAX test's tiny config draws a model whose greedy stream for
the first prompt repeats one token at seed 0 under every scaling of the init
tried, which proves little about acceptance. So the target is drawn at seed
5 with its embedding (and the tied head) scaled by 1/4, in JAX, and bridged;
every greedy case asserts at least two distinct tokens in each row of the
target-only stream. Tolerances: tokens, counts and cache codes exact; the
residual distribution within 1e-6 (float32 softmax in two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.engine import SpeculativeDecoder as JSpec
from onnx_quantize_tpu.engine import kv_cache as jkv
from onnx_quantize_tpu.engine import speculative as jspec
from onnx_quantize_tpu.models import gemma3 as jgemma3
from onnx_quantize_tpu.models import moe as jmoe
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.ops import convert_to_w4a8 as jconvert
from onnx_quantize_tpu_torch.engine import InferenceEngine, SpeculativeDecoder
from onnx_quantize_tpu_torch.engine import kv_cache as tkv
from onnx_quantize_tpu_torch.engine.speculative import accept_core, sampled_accept
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models import gemma3
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config

torch.set_num_threads(1)

CFG = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2, num_kv_heads=1,
           head_dim=32, vocab_size=128)
SEED, EMBED_SCALE = 5, 0.25
PROMPTS = [[5, 9, 17, 3], [11, 2]]


def _scaled_init(jmodel, seed):
    """JAX's seeded init with the embedding and its tied head scaled."""
    p = dict(jmodel.init(jax.random.key(seed)))
    for key in ("embed", "lm_head"):
        p[key] = {"w": p[key]["w"] * EMBED_SCALE}
    return p


class Pair:
    """One tree in both packages and engines over it."""

    def __init__(self, jmodel, jparams, tmodel):
        self.jmodel, self.jparams, self.tmodel = jmodel, jparams, tmodel
        self.tparams = from_jax_params(jparams, device="cpu")

    def jax_engine(self, kv_quant=True, max_seq=64):
        return JEngine(self.jmodel, self.jparams, max_batch=2, max_seq=max_seq,
                       kv_quant=kv_quant)

    def engine(self, kv_quant=True, max_seq=64):
        return InferenceEngine(self.tmodel, self.tparams, max_batch=2, max_seq=max_seq,
                               kv_quant=kv_quant)


@pytest.fixture(scope="module")
def pairs():
    jmodel = jgemma3.Gemma3(jgemma3.Gemma3Config.tiny(**CFG))
    tmodel = gemma3.Gemma3(gemma3.Gemma3Config.tiny(**CFG))
    jparams = _scaled_init(jmodel, SEED)
    quantized, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16)))
    return {"self": Pair(jmodel, jparams, tmodel),
            "quantized": Pair(jmodel, quantized, tmodel),
            "adversarial": Pair(jmodel, _scaled_init(jmodel, 99), tmodel)}


def _varied(outputs):
    """Each row of a target-only stream holds at least two distinct tokens."""
    assert all(len(set(o)) >= 2 for o in outputs), outputs
    return outputs


# -- configs and the window write ---------------------------------------------

@pytest.mark.parametrize("name", ["GEMMA3_1B", "GEMMA3_4B", "GEMMA3_270M"])
def test_published_configs_equal_jax(name):
    want = dataclasses.asdict(getattr(jgemma3, name))
    got = dataclasses.asdict(getattr(gemma3, name))
    assert {k: got[k] for k in want} == want
    from onnx_quantize_tpu_torch import models
    assert getattr(models, name) is getattr(gemma3, name)


def _caches(kind, rng, L=2, B=4, S=16, H=2, D=8):
    """The same filled cache in both packages (float, int8 or int4)."""
    quantized, bits = {"float": (False, 8), "int8": (True, 8), "int4": (True, 4)}[kind]
    jcfg = jkv.KVCacheConfig(num_layers=L, batch=B, max_seq=S, num_kv_heads=H, head_dim=D,
                             quantized=quantized, bits=bits)
    jc = jkv.init_cache(jcfg)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in jc:
            continue
        a = jc[key]
        if a.dtype == jnp.float32:
            fill = rng.normal(size=a.shape).astype(np.float32)
        else:
            info = np.iinfo(np.dtype(a.dtype))
            fill = rng.integers(info.min, info.max + 1, size=a.shape).astype(np.dtype(a.dtype))
        jc[key] = jnp.asarray(fill)
    tc = {key: torch.from_numpy(np.array(a)) for key, a in jc.items()}
    return jc, tc


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_write_kv_window_matches_jax(kind):
    """Per-row windows at offsets: an ordinary row, a row not ok, a row whose
    window would run past S (its start clamps to S - T and it keeps its old
    window), and a row ending exactly at S. Bit-equal codes, scales and
    floats in every layer, the untouched layer too."""
    rng = np.random.default_rng(3)
    jc, tc = _caches(kind, rng)
    B, T, H, D = 4, 5, 2, 8
    k = rng.normal(size=(B, T, H, D)).astype(np.float32)
    v = rng.normal(size=(B, T, H, D)).astype(np.float32)
    start = np.array([2, 6, 13, 11], np.int32)
    ok = np.array([True, False, True, True])
    jc = jkv.write_kv_window(jc, 1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
                             jnp.asarray(ok))
    tkv.write_kv_window(tc, 1, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(start), torch.from_numpy(ok))
    for key in jc:
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)


def test_write_kv_window_rejects_oversized_window():
    _, tc = _caches("int8", np.random.default_rng(0), S=4)
    x = torch.zeros((4, 5, 2, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tkv.write_kv_window(tc, 0, x, x, torch.zeros(4, dtype=torch.int32),
                            torch.ones(4, dtype=torch.bool))


# -- the rejection scheme -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_core_matches_jax(seed, monkeypatch):
    """JAX's ``sampled_accept`` with its accept draws ``u`` fed to the port's
    core: ``n`` equal, and the residual that JAX's final draw reads (its
    categorical's logits, log(resid + 1e-30)) within 1e-6."""
    rng = np.random.default_rng(seed)
    B, kp, V = 4, 3, 16
    p = rng.normal(size=(B, kp + 1, V)).astype(np.float32)
    q = (p[:, :kp] + rng.normal(0, 1.0, size=(B, kp, V))).astype(np.float32)
    q[0] = p[0, :kp]  # a perfect draft row: every draft accepts
    # The draft proposes what it likes best, where q outweighs p.
    drafts = np.argmax(q, axis=-1).astype(np.int32)
    temps = np.array([1.0, 0.7, 1.3, 0.9], np.float32)
    key = jax.random.key(10 + seed)
    captured = {}
    real = jax.random.categorical

    def capture(k, logits, axis=-1):
        captured["logits"] = np.asarray(logits)
        return real(k, logits, axis=axis)

    monkeypatch.setattr(jspec.jax.random, "categorical", capture)
    _, jn = jspec.sampled_accept(jnp.asarray(p), jnp.asarray(q), jnp.asarray(drafts),
                                 jnp.asarray(temps), key)
    r_acc, _ = jax.random.split(key)
    u = np.array(jax.random.uniform(r_acc, (B, kp)))
    n, resid = accept_core(torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafts),
                           torch.from_numpy(temps), torch.from_numpy(u))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(n[0]) == kp and 0 < int(n.sum()) < B * kp
    np.testing.assert_allclose(resid.numpy() + 1e-30, np.exp(captured["logits"]), rtol=0,
                               atol=1e-6)


def test_sampled_accept_marginal_matches_target():
    """Monte-Carlo pin of the port's rejection scheme: the first emitted
    token's distribution is softmax(p_0) for a deliberately bad draft q (the
    JAX test's shapes and bar; 20000 trials as rows of one call)."""
    V, kp, trials = 6, 3, 20000
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal((1, kp + 1, V)).astype(np.float32))
    q = torch.from_numpy(2.0 * rng.standard_normal((1, kp, V)).astype(np.float32))
    gen = torch.Generator().manual_seed(42)
    # The draft proposes from q, position by position, as its steps do.
    drafts = torch.stack([torch.multinomial(torch.softmax(q[0, i], -1), trials,
                                            replacement=True, generator=gen)
                          for i in range(kp)], dim=1)
    toks, _ = sampled_accept(p.expand(trials, -1, -1), q.expand(trials, -1, -1), drafts,
                             torch.ones(trials), gen)
    emp = np.bincount(toks[:, 0].numpy(), minlength=V) / trials
    np.testing.assert_allclose(emp, torch.softmax(p[0, 0], -1).numpy(), atol=0.015)


def test_sampled_accept_perfect_draft_accepts():
    V, kp = 8, 3
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((2, kp + 1, V)).astype(np.float32))
    drafts = torch.from_numpy(rng.integers(0, V, size=(2, kp)))
    toks, n = sampled_accept(p, p[:, :kp], drafts, torch.ones(2),
                             torch.Generator().manual_seed(0))
    assert (n == kp).all()
    assert torch.equal(toks[:, :kp], drafts)


# -- greedy streams ---------------------------------------------------------------

@pytest.fixture(scope="module")
def target_greedy(pairs):
    """Target-only greedy streams (12 tokens), both packages."""
    t = pairs["self"]
    jout = t.jax_engine().generate(PROMPTS, max_new_tokens=12)
    tout = t.engine().generate(PROMPTS, max_new_tokens=12)
    assert tout == jout
    return _varied(tout)


@pytest.mark.parametrize("draft_kind", ["self", "quantized", "adversarial"])
@pytest.mark.parametrize("k", [2, 4])
def test_exact_greedy_equivalence(pairs, target_greedy, draft_kind, k):
    t, d = pairs["self"], pairs[draft_kind]
    spec = SpeculativeDecoder(t.engine(), d.engine(), k=k)
    got = spec.generate(PROMPTS, max_new_tokens=12)
    assert got == target_greedy, (draft_kind, k)
    # generate's counts: every token past the first came from a live round,
    # which emits 1..k; a self-draft's full rounds emit k.
    st = spec.stats
    assert st["emitted"] == sum(len(o) - 1 for o in got)
    assert st["live_rounds"] <= st["emitted"] <= k * st["live_rounds"]
    if draft_kind == "self":
        assert st["live_rounds"] == sum(-(-(len(o) - 1) // k) for o in got)
    jgot = JSpec(t.jax_engine(), d.jax_engine(), k=k).generate(PROMPTS, max_new_tokens=12)
    assert got == jgot


def test_eos_and_budget(pairs, target_greedy):
    t = pairs["self"]
    eos = target_greedy[0][3]  # stop request 0 at its 4th token
    ref = t.engine().generate(PROMPTS, max_new_tokens=10, eos_token_id=eos)
    got = SpeculativeDecoder(t.engine(), t.engine(), k=3).generate(
        PROMPTS, max_new_tokens=10, eos_token_id=eos)
    assert got == ref
    assert got[0][-1] == eos and len(got[0]) <= 4
    assert got == JSpec(t.jax_engine(), t.jax_engine(), k=3).generate(
        PROMPTS, max_new_tokens=10, eos_token_id=eos)


def _prefilled(eng):
    ids = np.zeros((2, 4), np.int32)
    ids[0, :4] = PROMPTS[0]
    ids[1, :2] = PROMPTS[1]
    lengths = np.array([4, 2], np.int32)
    cache, _, first = eng.prefill(eng.new_cache(), ids, lengths, with_tokens=True)
    return cache, np.asarray(first)


def test_acceptance_speeds_up_round_count(pairs):
    """A self-draft accepts k-1 a round, so a full round emits k; the whole
    (B, rounds, k+3) blob equals JAX's."""
    t = pairs["self"]
    budgets = np.array([12, 12], np.int32)
    tgt, dft = t.engine(), t.engine()
    tgt_cache, first = _prefilled(tgt)
    dft_cache, _ = _prefilled(dft)
    _, _, blob = SpeculativeDecoder(tgt, dft, k=4).decode(tgt_cache, dft_cache, first, rounds=3,
                                                          budgets=budgets)
    blob = blob.numpy()
    assert blob.shape == (2, 3, 7) and blob.dtype == np.int32
    assert (blob[:, 0, 4] == 4).all()
    jt, jd = t.jax_engine(), t.jax_engine()
    jtc, jfirst = _prefilled(jt)
    jdc, _ = _prefilled(jd)
    np.testing.assert_array_equal(first, jfirst)
    _, _, jblob = JSpec(jt, jd, k=4).decode(jtc, jdc, jfirst, rounds=3, budgets=budgets)
    np.testing.assert_array_equal(blob, np.asarray(jblob))


def test_capacity_freeze(pairs):
    """Rows without room for a k+1 window freeze instead of writing past
    max_seq: 16 - 4 prompt = 12 slots, emitted in rounds until fewer than 5
    remain."""
    t = pairs["self"]
    got = SpeculativeDecoder(t.engine(max_seq=16), t.engine(max_seq=16), k=4).generate(
        [[5, 9, 17, 3]], max_new_tokens=32)
    assert 1 <= len(got[0]) <= 12
    assert got == JSpec(t.jax_engine(max_seq=16), t.jax_engine(max_seq=16), k=4).generate(
        [[5, 9, 17, 3]], max_new_tokens=32)


def test_mismatched_engines_rejected(pairs):
    t = pairs["self"]
    with pytest.raises(ValueError, match="max_batch/max_seq"):
        SpeculativeDecoder(t.engine(max_seq=64), t.engine(max_seq=32))
    with pytest.raises(ValueError, match="k must be >= 2"):
        SpeculativeDecoder(t.engine(), t.engine(), k=1)


def test_int4_kv_speculative_exactness(pairs):
    """Over int4 caches the window write quantizes and packs as the step's
    write does, so speculative greedy equals the int4 engine's own greedy,
    and JAX's."""
    t = pairs["self"]
    base = _varied(t.engine(kv_quant="int4").generate(PROMPTS, max_new_tokens=12))
    got = SpeculativeDecoder(t.engine(kv_quant="int4"), t.engine(kv_quant="int4"),
                             k=3).generate(PROMPTS, max_new_tokens=12)
    assert got == base
    assert got == JSpec(t.jax_engine(kv_quant="int4"), t.jax_engine(kv_quant="int4"),
                        k=3).generate(PROMPTS, max_new_tokens=12)


def test_float_kv_adversarial_draft(pairs):
    """Over float caches too (the window write's float branch in a stream)."""
    t, d = pairs["self"], pairs["adversarial"]
    base = _varied(t.engine(kv_quant=False).generate(PROMPTS, max_new_tokens=12))
    got = SpeculativeDecoder(t.engine(kv_quant=False), d.engine(kv_quant=False),
                             k=3).generate(PROMPTS, max_new_tokens=12)
    assert got == base
    assert got == JSpec(t.jax_engine(kv_quant=False), d.jax_engine(kv_quant=False),
                        k=3).generate(PROMPTS, max_new_tokens=12)


# -- sampled streams ----------------------------------------------------------------

def test_sampled_generate_deterministic_and_budgeted(pairs):
    t, d = pairs["self"], pairs["quantized"]
    spec = SpeculativeDecoder(t.engine(), d.engine(), k=3)

    def run(seed):
        return spec.generate(PROMPTS, max_new_tokens=11, temperature=0.8,
                             generator=torch.Generator().manual_seed(seed))

    a = run(7)
    assert a == run(7)
    assert all(len(o) == 11 for o in a)
    assert all(0 <= tok < CFG["vocab_size"] for o in a for tok in o)
    assert run(8) != a  # another seed, another stream


def test_sampled_eos_stops(pairs):
    t = pairs["self"]
    spec = SpeculativeDecoder(t.engine(), t.engine(), k=3)

    def run(**kw):
        return spec.generate(PROMPTS, max_new_tokens=10, temperature=0.9,
                             generator=torch.Generator().manual_seed(3), **kw)

    probe = run()
    eos = probe[0][2]
    got = run(eos_token_id=eos)
    assert got[0][-1] == eos or len(got[0]) == 10
    # The stream up to EOS is the unstopped stream's (same seed).
    assert got[0] == probe[0][:len(got[0])]


# -- other trees: an MoE target, the A8 trees -----------------------------------

def test_speculative_decoding_with_moe_target():
    """An MoE target in the fused-expert layout (the JAX MoE test's case):
    the stream equals the target engine's own greedy stream, and JAX's."""
    jmodel = jgemma3.Gemma3(jmoe.tiny_moe_config())
    tmodel = gemma3.Gemma3(tiny_moe_config())
    jparams = jmodel.init(jax.random.key(0))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16), ignore=[r"\.router$"]))
    jfused = jmoe.fuse_moe_experts(jfuse(jq))
    tfused = from_jax_params(jfused, device="cpu")

    def eng(jax_side):
        cls, model, p = (JEngine, jmodel, jfused) if jax_side else (InferenceEngine, tmodel,
                                                                     tfused)
        return cls(model, p, max_batch=2, max_seq=64, kv_quant=True)

    base = _varied(eng(False).generate(PROMPTS, max_new_tokens=8))
    got = SpeculativeDecoder(eng(False), eng(False), k=3).generate(PROMPTS, max_new_tokens=8)
    assert got == base
    assert got == JSpec(eng(True), eng(True), k=3).generate(PROMPTS, max_new_tokens=8)


def test_a8_trees_match_jax(pairs):
    """``convert_to_w4a8`` target and adversarial draft (W4 g16 body, int8
    head, fused):
    the port's speculative stream equals JAX's. W4A8's per-tensor activation
    scale couples the rows of a forward, so the stream is held to JAX's
    speculative stream, not to the target-only one."""
    def a8(pair):
        p, _ = joqt.quantize(pair.jmodel, pair.jparams, joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="uint4", group_size=16), ignore=["lm_head"]))
        p, _ = joqt.quantize(pair.jmodel, p, joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
            ignore=[r"^layers\."]))
        return Pair(pair.jmodel, jconvert(jfuse(p)), pair.tmodel)

    ta8, da8 = a8(pairs["self"]), a8(pairs["adversarial"])
    qkv = ta8.tparams["layers.0"]["attn"]["_fused_qkv"]["w"]
    assert qkv.meta.input_quant.mode == "dynamic"
    assert ta8.tparams["lm_head"]["w"].meta.input_quant.dtype == "int8"
    got = SpeculativeDecoder(ta8.engine(), da8.engine(), k=3).generate(PROMPTS,
                                                                       max_new_tokens=10)
    jgot = JSpec(ta8.jax_engine(), da8.jax_engine(), k=3).generate(PROMPTS, max_new_tokens=10)
    assert got == jgot
    assert all(len(o) == 10 for o in got)


def test_gemma3_family_pair_matches_jax():
    """The published pairing's shapes at a small size: a target cut from
    ``GEMMA3_1B`` and a W4 draft cut from ``GEMMA3_270M`` (4 query heads on
    1 KV head, narrow widths, 3 and 2 layers, a 512-token vocabulary), seeded
    in JAX and bridged. The draft's widths and depth differ from the
    target's; the stream equals the target-only one and JAX's."""
    def pair(published, **cut):
        cfg = dataclasses.replace(getattr(jgemma3, published), **cut)
        tcfg = dataclasses.replace(getattr(gemma3, published), **cut)
        return jgemma3.Gemma3(cfg), gemma3.Gemma3(tcfg)

    shared = dict(vocab_size=512, head_dim=64, sliding_window=16, sliding_pattern=2)
    jt, tt = pair("GEMMA3_1B", hidden_size=144, intermediate_size=288, num_layers=3, **shared)
    jd, td = pair("GEMMA3_270M", hidden_size=96, intermediate_size=192, num_layers=2, **shared)
    target = Pair(jt, _scaled_init(jt, SEED), tt)
    jdraft, _ = joqt.quantize(jd, _scaled_init(jd, SEED + 1), joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=32)))
    draft = Pair(jd, jdraft, td)
    prompts = [[5, 9, 170, 3, 411, 2], [11, 2, 300]]
    base = _varied(target.engine().generate(prompts, max_new_tokens=12))
    got = SpeculativeDecoder(target.engine(), draft.engine(), k=3).generate(
        prompts, max_new_tokens=12)
    assert got == base
    assert got == JSpec(target.jax_engine(), draft.jax_engine(), k=3).generate(
        prompts, max_new_tokens=12)
