"""The PyTorch port's serving pieces against the JAX package's: the per-row
sampler (``sample_batch``, ``batch_sampling_arrays``), the narrow
admission's KV write (``write_kv_rows``), ``prefill(with_tokens=, prefix=)``
with ``snapshot_prefix``, the narrow admission prefill and one
``serve_chunk`` round, on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.engine import kv_cache as jkv
from onnx_quantize_tpu.engine import sampling as jsampling
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jax_fuse
from onnx_quantize_tpu_torch.engine import (
    InferenceEngine,
    SamplingParams,
    batch_sampling_arrays,
    sample_batch,
)
from onnx_quantize_tpu_torch.engine import kv_cache as tkv
from onnx_quantize_tpu_torch.engine.sampling import _masked_rows
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

torch.set_num_threads(1)

TINY = dict(hidden_size=320, intermediate_size=512, num_layers=3, sliding_pattern=3,
            num_heads=2, num_kv_heads=1, head_dim=64, sliding_window=8, vocab_size=512)
B, S = 4, 48
# Float32 stream: the frameworks differ in summation order only; 1e-5 of the
# largest logit bounds that over a float cache. Over an int8 or int4 cache
# that difference can move a K/V value across a rounding tie, and one code
# off by one moves the logits by up to ~1e-3 of the largest: there the
# tokens are compared, and the codes as in ``_codes_close``.
REL_TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL_TOL * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the per-row sampler ---------------------------------------------------------

# One row of each kind. The last two carry C1's overrun: V = 32000 logits of
# N(0, 0.1^2) whose float32 mass ends below top_p (0.99999988 < 0.99999994).
ROW_PARAMS = [SamplingParams(), SamplingParams(temperature=0.7),
              SamplingParams(temperature=0.9, top_k=40), SamplingParams(temperature=1.3, top_p=0.8),
              SamplingParams(temperature=0.8, top_k=100, top_p=0.6),
              SamplingParams(temperature=1.0, top_p=0.99999994),
              SamplingParams(temperature=1.0, top_k=50, top_p=0.99999994)]


def _mixed_logits():
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.standard_normal((len(ROW_PARAMS), 32000))).astype(np.float32)
    logits[-2:] = rng.normal(0, 0.1, (2, 32000)).astype(np.float32)
    return logits


def test_sampler_keeps_the_jax_set_on_every_row_kind(monkeypatch):
    logits = _mixed_logits()
    (temps, top_ks, top_ps), variant = batch_sampling_arrays(ROW_PARAMS)
    assert variant == (True, True, True)
    kept = {}

    def capture(key, x, axis=-1):
        kept["jax"] = np.asarray(x)
        return jnp.zeros(x.shape[:-1], jnp.int32)

    monkeypatch.setattr(jsampling.jax.random, "categorical", capture)
    jsampling.sample_batch(jnp.asarray(logits), jax.random.key(0), temps, top_ks, top_ps)
    got = _masked_rows(_t(logits), _t(temps), _t(top_ks), _t(top_ps), True, True).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(kept["jax"]))
    np.testing.assert_array_equal(got[np.isfinite(got)], kept["jax"][np.isfinite(got)])
    # The overrun rows keep every logit, or top-k's 50.
    assert np.isfinite(got[-2]).all() and np.isfinite(got[-1]).sum() == 50


@pytest.mark.parametrize("plist", [
    [SamplingParams()] * 3,
    [SamplingParams(), SamplingParams(temperature=0.5)],
    [SamplingParams(top_k=5, top_p=0.5), SamplingParams(temperature=0.5, top_k=5)],
    [SamplingParams(temperature=0.5, top_p=0.9), SamplingParams(top_k=3)],
    ROW_PARAMS,
], ids=["greedy", "temp", "greedy_rows_carry_masks", "topp_only", "mixed"])
def test_variant_flags_and_arrays_equal_jax(plist):
    (arrays, variant) = batch_sampling_arrays(plist)
    j_arrays, j_variant = jsampling.batch_sampling_arrays(
        [jsampling.SamplingParams(p.temperature, p.top_k, p.top_p) for p in plist])
    assert variant == j_variant
    for got, want in zip(arrays, j_arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_greedy_rows_exact_and_draws_in_kept_set():
    logits = _mixed_logits()
    (temps, top_ks, top_ps), _ = batch_sampling_arrays(ROW_PARAMS)
    args = [_t(a) for a in (temps, top_ks, top_ps)]
    masked = _masked_rows(_t(logits), *args, True, True).numpy()
    draws = torch.stack([sample_batch(_t(logits), torch.Generator().manual_seed(s), *args)
                         for s in range(20)])
    again = torch.stack([sample_batch(_t(logits), torch.Generator().manual_seed(s), *args)
                         for s in range(20)])
    assert torch.equal(draws, again)
    assert draws.dtype == torch.int64
    assert (draws[:, 0] == int(np.argmax(logits[0]))).all()
    for row in range(1, len(ROW_PARAMS)):
        assert np.isfinite(masked[row, draws[:, row].numpy()]).all(), row
    assert len(set(draws[:, 1].tolist())) > 1  # temperature rows do sample
    # With need_temp off the call is a bare argmax and draws nothing.
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    greedy = sample_batch(_t(logits), gen, *args, need_temp=False)
    assert torch.equal(greedy, _t(logits).argmax(-1)) and torch.equal(gen.get_state(), state)


# -- write_kv_rows ---------------------------------------------------------------

def _random_cache(kind, rng, L=2, H=1, D=8):
    shape = (L, B, S, H, D)
    if kind == "float":
        return {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32),
                "lengths": np.zeros(B, np.int32)}
    dt, last = (np.int8, D) if kind == "int8" else (np.uint8, D // 2)
    lo, hi = (-127, 128) if kind == "int8" else (0, 256)
    cache = {key: rng.integers(lo, hi, shape[:-1] + (last,)).astype(dt) for key in ("k", "v")}
    for key in ("k_scale", "v_scale"):
        cache[key] = rng.random(shape[:-1]).astype(np.float32)
    cache["lengths"] = np.zeros(B, np.int32)
    return cache


@pytest.mark.parametrize("kind", ["int8", "int4", "float"])
def test_write_kv_rows_matches_jax_and_drops_padding(kind):
    rng = np.random.default_rng(5)
    cache = _random_cache(kind, rng)
    A, T, layer = 4, 6, 1
    k = rng.standard_normal((A, T, 1, 8)).astype(np.float32)
    v = rng.standard_normal((A, T, 1, 8)).astype(np.float32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (A, T)).copy()
    positions[2] += 7  # a row written at an offset
    slots = np.array([2, B, 0, 3], np.int32)  # row 1 is a bucket's padding row
    jnew, jfresh = jkv.write_kv_rows({key: jnp.asarray(a) for key, a in cache.items()}, layer,
                                     jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
                                     jnp.asarray(slots))
    tcache = {key: _t(a).clone() for key, a in cache.items()}
    rows, slot_index = tkv.admitted_rows(slots, B, "cpu")
    assert rows.tolist() == [0, 2, 3] and slot_index.tolist() == [2, 0, 3]
    fresh = tkv.write_kv_rows(tcache, layer, _t(k), _t(v), _t(positions), rows, slot_index)
    for key in cache:
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jnew[key]), err_msg=key)
    # Slot 1 is written by no row: the padding row left it as it was.
    for key in cache:
        if key != "lengths":
            np.testing.assert_array_equal(tcache[key][:, 1].numpy(), cache[key][:, 1])
    if kind == "float":
        for got, want in zip(fresh, jfresh):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        for field in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(fresh, field).numpy(),
                                          np.asarray(getattr(jfresh, field)), err_msg=field)


# -- engines on bridged weights ----------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    params, _ = oqt.quantize(jmodel, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    params = jax_fuse(params)
    return jmodel, params, Gemma3(Gemma3Config.tiny(**TINY)), from_jax_params(params, device="cpu")


def _engines(setup, kv_quant=True):
    jmodel, jparams, tmodel, tparams = setup
    return (JEngine(jmodel, jparams, max_batch=B, max_seq=S, kv_quant=kv_quant),
            InferenceEngine(tmodel, tparams, max_batch=B, max_seq=S, kv_quant=kv_quant))


def _prompts(seed, lengths, width):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, TINY["vocab_size"], n)
    return ids


def _codes_close(got, want):
    """int8 codes of the same forward in two frameworks: a float32 rounding
    can land on a .5 tie, so at most 1 apart in at most 0.1% of entries."""
    diff = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_with_tokens_matches_jax(setup, kv_quant):
    jeng, teng = _engines(setup, kv_quant)
    ids = _prompts(0, [12, 9, 15, 1], 16)
    lengths = np.array([12, 9, 15, 1], np.int32)
    mask = np.array([True, True, True, False])
    _, jlogits, jtok = jeng.prefill(jeng.new_cache(), ids, lengths, slot_mask=mask,
                                    with_tokens=True)
    _, tlogits, ttok = teng.prefill(teng.new_cache(), ids, lengths, slot_mask=mask,
                                    with_tokens=True)
    assert ttok.dtype == torch.int32
    if not kv_quant:
        _close(tlogits.numpy()[mask], np.asarray(jlogits)[mask])
    np.testing.assert_array_equal(ttok.numpy()[mask], np.asarray(jtok)[mask])
    np.testing.assert_array_equal(ttok.numpy(), tlogits.numpy().argmax(-1))


PREFIX = [7, 3, 99, 12, 5, 44, 21, 300, 411, 2, 17]


@pytest.mark.parametrize("kv_quant", [True, "int4", False])
def test_prefix_prefill_and_snapshot_match_jax(setup, kv_quant):
    """The snapshot of a prefix prefill, then a suffix prefill on top of it
    into slots 0 and 2 of a cache whose slot 1 holds another sequence:
    logits, tokens and lengths as JAX's, slot 1's rows and length untouched,
    and the same logits as prefilling the whole prompt."""
    jeng, teng = _engines(setup, kv_quant)
    P = len(PREFIX)
    ids_p = np.zeros((B, P), np.int32)
    ids_p[0] = PREFIX
    only0 = np.array([True, False, False, False])
    plen = np.array([P, 1, 1, 1], np.int32)
    jscratch, _ = jeng.prefill(jeng.new_cache(), ids_p, plen, slot_mask=only0)
    tscratch, _ = teng.prefill(teng.new_cache(), ids_p, plen, slot_mask=only0)
    jprefix = jeng.snapshot_prefix(jscratch, 0, P)
    tprefix = teng.snapshot_prefix(tscratch, 0, P)
    assert set(tprefix) == set(jprefix)
    for key in tprefix:
        assert tuple(tprefix[key].shape) == tuple(jprefix[key].shape)
        if key.endswith("scale") or not kv_quant:
            _close(tprefix[key].numpy(), jprefix[key])
        else:
            _codes_close(tprefix[key].numpy(), jprefix[key])

    # Slot 1 holds a 20-token sequence; slots 0 and 2 take the prefix.
    other = _prompts(3, [20], 20)
    tcache, _ = teng.prefill(teng.new_cache(), np.repeat(other, B, 0),
                             np.array([0, 20, 0, 0], np.int32),
                             slot_mask=np.array([False, True, False, False]))
    before = {key: buf.clone() for key, buf in tcache.items()}
    suffix = _prompts(4, [5, 3, 5, 3], 5)
    lengths = np.array([P + 5, 20, P + 3, 0], np.int32)
    mask = np.array([True, False, True, False])
    jcache, jlogits, jtok = jeng.prefill(jeng.new_cache(), suffix, lengths, slot_mask=mask,
                                         with_tokens=True, prefix=jprefix)
    tcache, tlogits, ttok = teng.prefill(tcache, suffix, lengths, slot_mask=mask,
                                         with_tokens=True, prefix=tprefix)
    if not kv_quant:
        _close(tlogits.numpy()[mask], np.asarray(jlogits)[mask])
    np.testing.assert_array_equal(ttok.numpy()[mask], np.asarray(jtok)[mask])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [P + 5, 20, P + 3, 0])
    for key, buf in tcache.items():
        if key != "lengths":
            assert torch.equal(buf[:, 1], before[key][:, 1]), key

    # The same rows prefilled whole: the same logits.
    full = np.zeros((B, P + 5), np.int32)
    full[0] = PREFIX + suffix[0].tolist()
    full[2, :P + 3] = PREFIX + suffix[2, :3].tolist()
    _, flogits, ftok = teng.prefill(teng.new_cache(), full, lengths, slot_mask=mask,
                                    with_tokens=True)
    np.testing.assert_array_equal(ttok.numpy()[mask], ftok.numpy()[mask])
    if not kv_quant:
        _close(tlogits.numpy()[mask], flogits.numpy()[mask])


def test_prefix_suffix_bucket_past_max_seq(setup):
    """A suffix bucket that runs past max_seq (the scheduler pads to 64 at
    most max_seq, after a prefix): its padding columns are not written, and
    the real rows match JAX's."""
    jeng, teng = _engines(setup)
    P = len(PREFIX)
    ids_p = np.zeros((B, P), np.int32)
    ids_p[:] = PREFIX
    plen = np.full((B,), P, np.int32)
    jprefix = jeng.snapshot_prefix(jeng.prefill(jeng.new_cache(), ids_p, plen)[0], 0, P)
    tprefix = teng.snapshot_prefix(teng.prefill(teng.new_cache(), ids_p, plen)[0], 0, P)
    suffix = _prompts(6, [S - P, 4, 9, 1], S)  # P + S columns, S - P written
    lengths = np.array([S, P + 4, P + 9, P + 1], np.int32)
    jcache, jlogits, jtok = jeng.prefill(jeng.new_cache(), suffix, lengths, with_tokens=True,
                                         prefix=jprefix)
    tcache, tlogits, ttok = teng.prefill(teng.new_cache(), suffix, lengths, with_tokens=True,
                                         prefix=tprefix)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), lengths)
    _codes_close(tcache["k"].numpy(), jcache["k"])


@pytest.mark.parametrize("kv_quant", [True, False])
def test_narrow_admission_prefill_matches_jax_and_masked(setup, kv_quant):
    """Rows-only admission into slots 3 and 1 of a cache whose slots 0 and 2
    hold sequences, with a padding row: logits and tokens as JAX's
    ``_admit_prefill_impl`` and as the port's masked prefill; the padding
    row and the other slots leave cache, lengths and tokens untouched."""
    jeng, teng = _engines(setup, kv_quant)
    held = _prompts(7, [10, 10, 14, 10], 14)
    held_len = np.array([10, 0, 14, 0], np.int32)
    held_mask = held_len > 0
    tcache, _ = teng.prefill(teng.new_cache(), held, held_len, slot_mask=held_mask)
    jcache, _ = jeng.prefill(jeng.new_cache(), held, held_len, slot_mask=held_mask)
    before = {key: buf.clone() for key, buf in tcache.items()}
    ids = _prompts(8, [7, 12, 1, 1], 16)
    lengths = np.array([7, 12, 1, 1], np.int32)
    slots = np.array([3, 1, B, B], np.int32)
    jnew, jlogits, jgreedy = jax.jit(jeng._admit_prefill_impl)(
        jeng.params, jcache, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(slots))
    tlogits, tgreedy, rows, slot_index = teng._admit_prefill(tcache, ids, lengths, slots)
    assert rows.tolist() == [0, 1] and slot_index.tolist() == [3, 1]
    np.testing.assert_array_equal(tgreedy.numpy()[:2], np.asarray(jgreedy)[:2])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), [10, 12, 14, 7])
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jnew["lengths"]))
    for slot, n in ((3, 7), (1, 12)):
        if kv_quant:
            _codes_close(tcache["k"][:, slot, :n].numpy(), np.asarray(jnew["k"])[:, slot, :n])
            _close(tcache["v_scale"][:, slot, :n].numpy(),
                   np.asarray(jnew["v_scale"])[:, slot, :n])
        else:
            _close(tcache["k"][:, slot, :n].numpy(), np.asarray(jnew["k"])[:, slot, :n])
    if not kv_quant:
        _close(tlogits.numpy()[:2], np.asarray(jlogits)[:2])
    for key in before:
        if key != "lengths":
            assert torch.equal(tcache[key][:, [0, 2]], before[key][:, [0, 2]]), key

    # The masked prefill of the same admissions: the same logits and tokens.
    wide = np.zeros((B, 16), np.int32)
    wide[3], wide[1] = ids[0], ids[1]
    mlen = np.array([10, 12, 14, 7], np.int32)
    _, mlogits, mtok = teng.prefill(teng.new_cache(), wide, mlen,
                                    slot_mask=np.array([False, True, False, True]),
                                    with_tokens=True)
    np.testing.assert_array_equal(tgreedy.numpy()[:2], mtok.numpy()[[3, 1]])
    if not kv_quant:
        _close(tlogits.numpy()[:2], mlogits.numpy()[[3, 1]])


GREEDY = batch_sampling_arrays([SamplingParams()] * B)


@pytest.mark.parametrize("narrow", [False, True], ids=["masked", "narrow"])
def test_serve_chunk_rounds_match_jax(setup, narrow):
    """Two rounds: slots 0 and 1 decode (slot 0 with an EOS that fires, slot
    1 on a short budget) while slot 2 is admitted (masked or narrow); then a
    continuation from the carry that admits slot 3 with ``admit_budgets``.
    Blob and carry equal JAX's."""
    jeng, teng = _engines(setup)
    held = _prompts(9, [9, 13], 13)
    jcache, jlog = jeng.prefill(jeng.new_cache(), np.pad(held, ((0, 2), (0, 0))),
                                np.array([9, 13, 0, 0], np.int32),
                                slot_mask=np.array([True, True, False, False]))
    tcache, _ = teng.prefill(teng.new_cache(), np.pad(held, ((0, 2), (0, 0))),
                             np.array([9, 13, 0, 0], np.int32),
                             slot_mask=np.array([True, True, False, False]))
    first = np.asarray(jlog).argmax(-1).astype(np.int32)
    first[2:] = 0
    # Slot 0's EOS: the token its greedy decode emits third.
    probe = teng.decode_multi({k: v.clone() for k, v in tcache.items()}, first, 3,
                              active=np.array([True, False, False, False]))[1]
    eos = np.array([int(probe[0, 2]), -1, -1, -1], np.int32)
    e0 = probe[0].tolist().index(eos[0]) + 1
    prompt2 = _prompts(10, [11], 11)[0]
    prompt3 = _prompts(11, [6], 6)[0]

    def admit(slot, prompt, lengths_now):
        if narrow:
            ids = np.zeros((2, 64 if S >= 64 else S), np.int32)
            ids[0, :len(prompt)] = prompt
            return dict(admit_ids=ids, admit_lengths=np.array([len(prompt), 1], np.int32),
                        admit_slots=np.array([slot, B], np.int32))
        ids = np.zeros((B, S), np.int32)
        ids[slot, :len(prompt)] = prompt
        lengths = lengths_now.copy()
        lengths[slot] = len(prompt)
        mask = np.zeros(B, bool)
        mask[slot] = True
        return dict(admit_ids=ids, admit_lengths=lengths, admit_mask=mask)

    kw = dict(steps=4, eos=eos, sampling_arrays=GREEDY[0], variant=GREEDY[1],
              active=np.array([True, True, False, False]),
              budgets=np.array([9, 3, 6, 0], np.int32))
    lengths0 = np.array([9, 13, 0, 0], np.int32)
    jcache, jblob, jcarry = jeng.serve_chunk(jcache, first, rng=jax.random.key(0), **kw,
                                             **admit(2, prompt2, lengths0))
    tcache, tblob, tcarry = teng.serve_chunk(tcache, first, **kw, **admit(2, prompt2, lengths0))
    jblob, tblob = np.asarray(jblob), tblob.numpy()
    assert tblob.dtype == np.int32 and tblob.shape == (B, 4 + 4)
    np.testing.assert_array_equal(tblob[:, 1:], jblob[:, 1:])
    np.testing.assert_array_equal(tblob[2, 0], jblob[2, 0])
    # Slot 0 froze on its EOS, slot 1 spent its budget of 3, slot 2 runs on.
    np.testing.assert_array_equal(tblob[:, -3], [e0, 3, 4, 0])
    np.testing.assert_array_equal(tblob[:, -2], [1, 1, 0, 1])
    np.testing.assert_array_equal(tblob[:, -1], [9 + e0, 16, 15, 0])
    for got, want in zip(tcarry, jcarry):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))

    # A continuation from the carry that admits slot 3 with its own budget.
    kw2 = dict(steps=4, eos=eos, sampling_arrays=GREEDY[0], variant=GREEDY[1],
               admit_budgets=np.array([0, 0, 0, 5], np.int32))
    jcache, jblob, jcarry = jeng.serve_chunk(jcache, None, rng=jax.random.key(1), carry=jcarry,
                                             **kw2, **admit(3, prompt3, tblob[:, -1]))
    tcache, tblob, tcarry = teng.serve_chunk(tcache, None, carry=tcarry, **kw2,
                                             **admit(3, prompt3, tblob[:, -1]))
    jblob, tblob = np.asarray(jblob), tblob.numpy()
    np.testing.assert_array_equal(tblob[:, 1:], jblob[:, 1:])
    np.testing.assert_array_equal(tblob[3, 0], jblob[3, 0])
    np.testing.assert_array_equal(tblob[:, -3], [0, 0, 1, 4])
    for got, want in zip(tcarry, jcarry):
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
