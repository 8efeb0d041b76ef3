"""The narrow admission's plan (``scheduler.plan_admission``) and the engine's
sub-forwards that run it.

The plan: over seeded prompt sets of 1-32 rows, every row once, sub-batches
consecutive in length order, never more padded tokens than the single
forward, the least cost that any partition of the rows gives (brute force up
to 8 rows), and one forward where the single forward's padded tokens are
under ``ADMIT_M_FLOOR``. The run: at the tiny MoE and dense models, a
narrow admission run as several sub-forwards gives the first tokens, the
continuation over a chunk, the cache rows and lengths of one padded forward;
a tree with int8 activations keeps one forward."""

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.engine import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    SamplingParams,
    prepare_kernel_scales,
)
from onnx_quantize_tpu_torch.engine import scheduler as sched_mod
from onnx_quantize_tpu_torch.engine.scheduler import ADMIT_M_CAP, ADMIT_M_FLOOR, plan_admission
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.moe import (
    fuse_moe_experts,
    stack_moe_experts,
    tiny_moe_config,
)
from onnx_quantize_tpu_torch.ops import convert_to_w4a8

torch.set_num_threads(1)

MAX_SEQ = 2560


def _bucket(n):
    return max(min(-(-max(n, 1) // 64) * 64, MAX_SEQ), n)


def _single_tokens(lengths):
    """The padded tokens of the admission run as one forward: rows bucketed to
    a power of two, every row at the longest prompt's bucket."""
    return (1 << (len(lengths) - 1).bit_length()) * _bucket(max(lengths))


def _tokens(lengths, plan):
    if len(plan) == 1:
        return _single_tokens(lengths)
    return sum(len(sub) * _bucket(max(lengths[i] for i in sub)) for sub in plan)


def _cost(lengths, plan):
    if len(plan) == 1:
        return max(_single_tokens(lengths), ADMIT_M_FLOOR)
    return sum(max(len(sub) * _bucket(max(lengths[i] for i in sub)), ADMIT_M_FLOOR)
               for sub in plan)


def _partitions(items):
    """Every partition of ``items`` into non-empty sets."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _partitions(rest):
        yield [[first]] + part
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]


def _length_set(seed):
    """Seeded prompt lengths in [1, 2048]: 1-32 rows, log-uniform, the chat
    cell's log-normal law, or within one or two 64-token buckets."""
    rng = np.random.default_rng(seed)
    n = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32][seed % 12]
    kind = (seed // 12) % 3
    if kind == 0:
        x = np.exp(rng.uniform(0.0, np.log(2048.0), n))
    elif kind == 1:
        x = np.exp(np.log(1020.0) + 0.5 * rng.standard_normal(n))
    else:
        x = rng.integers(1, 128, n)
    return np.clip(np.round(x), 1, 2048).astype(int).tolist()


@pytest.mark.parametrize("seed", range(36))
def test_plan_partitions_rows_at_least_cost(seed):
    lengths = _length_set(seed)
    n = len(lengths)
    plan = plan_admission(lengths, MAX_SEQ)
    flat = [i for sub in plan for i in sub]
    assert sorted(flat) == list(range(n))  # every row exactly once
    assert all(sub for sub in plan)
    if len(plan) > 1:
        # Consecutive in length order: the plan's rows, read in order, are sorted.
        assert [lengths[i] for i in flat] == sorted(lengths)
    assert _tokens(lengths, plan) <= _single_tokens(lengths)
    if _single_tokens(lengths) <= ADMIT_M_FLOOR:
        assert plan == [list(range(n))]
    if n <= 8:
        best = min(_cost(lengths, part) for part in _partitions(list(range(n))))
        assert _cost(lengths, plan) == best


def _forward_tokens(lengths, plan, max_seq):
    """Each forward's tokens: rows (bucketed to a power of two when the plan
    is one forward) x its longest prompt's bucket."""
    def bucket(n):
        return max(min(-(-max(n, 1) // 64) * 64, max_seq), n)

    if len(plan) == 1:
        return [(1 << (len(lengths) - 1).bit_length()) * bucket(max(lengths))]
    return [len(sub) * bucket(max(lengths[i] for i in sub)) for sub in plan]


@pytest.mark.parametrize("seed", range(12))
def test_plan_forwards_stay_under_the_cap(seed):
    """Prompts of 1-4k (the long-context cell's law) and 16k-token single
    rows: no forward of two or more rows above ADMIT_M_CAP tokens, and a
    row longer than the cap runs alone."""
    rng = np.random.default_rng(1000 + seed)
    n = [2, 4, 8, 12, 16, 24, 32][seed % 7]
    lengths = np.clip(np.round(np.exp(np.log(2048.0) + 0.5 * rng.standard_normal(n))),
                      1024, 4096).astype(int).tolist()
    if seed % 3 == 0:
        lengths[0] = ADMIT_M_CAP + 5
    max_seq = ADMIT_M_CAP + 2048
    plan = plan_admission(lengths, max_seq)
    assert sorted(i for sub in plan for i in sub) == list(range(n))
    for sub, tokens in zip(plan, _forward_tokens(lengths, plan, max_seq)):
        assert len(sub) == 1 or tokens <= ADMIT_M_CAP, (sub, tokens)


@pytest.mark.parametrize("seed", range(36))
def test_plan_is_unchanged_where_the_cap_does_not_bind(seed, monkeypatch):
    """Over the chat prompt sets above (at most 32 rows of at most 2048
    tokens), the plan equals the plan without a cap wherever that plan's
    forwards all lie within it."""
    lengths = _length_set(seed)
    monkeypatch.setattr(sched_mod, "ADMIT_M_CAP", 1 << 40)
    free = plan_admission(lengths, MAX_SEQ)
    monkeypatch.undo()
    if all(t <= ADMIT_M_CAP or len(sub) == 1
           for sub, t in zip(free, _forward_tokens(lengths, free, MAX_SEQ))):
        assert plan_admission(lengths, MAX_SEQ) == free


def test_plan_of_short_prompts_and_of_a_spread():
    # Three short prompts in one bucket (4 x 64 padded tokens): one forward,
    # in the given order.
    assert plan_admission([5, 9, 17], 64) == [[0, 1, 2]]
    assert plan_admission([17, 5, 9], 64) == [[0, 1, 2]]
    # Rows of equal buckets merge; the wide spread splits, shortest first.
    f = ADMIT_M_FLOOR
    lengths = [2 * f - 3, 10, f - 20, 12, 2 * f - 40, 11]
    plan = plan_admission(lengths, 2 * f + 64)
    assert plan == [[1, 5, 3], [2], [4, 0]]


# -- the engine runs the plan --------------------------------------------------


def _moe_tree():
    model = Gemma3(tiny_moe_config(shared_expert_size=48))
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        ignore=[r"\.router$", r"\.shared_gate$"]))
    return model, stack_moe_experts(fuse_moe_experts(prepare_kernel_scales(
        fuse_gemma3_projections(q))))


def _dense_tree():
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16), ignore=["lm_head"]))
    return model, fuse_gemma3_projections(q)


@pytest.fixture(scope="module", params=["moe", "dense"])
def pair(request):
    return _moe_tree() if request.param == "moe" else _dense_tree()


# Three short prompts, one of ~F and two of ~2F tokens (F = ADMIT_M_FLOOR):
# the plan runs three forwards, where one forward pads 8 rows to 2F.
SPREAD = [2 * ADMIT_M_FLOOR - 3, 10, ADMIT_M_FLOOR - 20, 12, 2 * ADMIT_M_FLOOR - 40, 11]
SPREAD_SEQ = 2 * ADMIT_M_FLOOR + 64
B = 16


def _codes_close(got, want):
    """int8 codes of the same rows from forwards of other shapes: a float32
    rounding can land on a .5 tie, so at most 1 apart in at most 0.1% of
    entries."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _serve(pair, split: bool):
    """One serve-mode step that admits SPREAD (greedy and sampled rows) and
    decodes a chunk; ``split=False`` holds the admission to one forward."""
    model, tree = pair
    engine = InferenceEngine(model, tree, max_batch=B, max_seq=SPREAD_SEQ, kv_quant=True)
    engine.rows_independent = split
    forwards = []
    run = engine._admit_forward
    engine._admit_forward = lambda *a: (forwards.append(a[1].shape), run(*a))[1]
    sched = ContinuousBatchingScheduler(engine, generator=torch.Generator().manual_seed(11),
                                        chunk=4, pipeline=1)
    rng = np.random.default_rng(4)
    sampled = SamplingParams(temperature=0.8, top_k=20)
    reqs = [sched.submit(rng.integers(1, model.cfg.vocab_size, n).tolist(), max_new_tokens=6,
                         sampling=sampled if i % 3 == 1 else SamplingParams())
            for i, n in enumerate(SPREAD)]
    sched.step()
    return [r.output for r in reqs], sched.cache, forwards


def test_sub_forwards_equal_one_padded_forward(pair):
    plan = plan_admission(SPREAD, SPREAD_SEQ)
    assert len(plan) == 3
    split, cache, forwards = _serve(pair, split=True)
    one, cache1, forwards1 = _serve(pair, split=False)
    f = ADMIT_M_FLOOR
    assert forwards == [(3, 64), (1, f), (2, 2 * f)]
    assert forwards1 == [(8, 2 * f)]
    assert [len(out) for out in split] == [5] * len(SPREAD)  # first token and a chunk
    assert split == one
    np.testing.assert_array_equal(cache["lengths"].numpy(), cache1["lengths"].numpy())
    for slot, n in enumerate(cache["lengths"].tolist()[:len(SPREAD)]):
        for key in ("k", "v"):
            _codes_close(cache[key][:, slot, :n].numpy(), cache1[key][:, slot, :n].numpy())
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(cache[key][:, slot, :n].numpy(),
                                       cache1[key][:, slot, :n].numpy(), rtol=1e-5, atol=0)


def test_int8_activation_tree_keeps_one_forward():
    model, tree = _dense_tree()
    engine = InferenceEngine(model, convert_to_w4a8(tree), max_batch=B, max_seq=SPREAD_SEQ,
                             kv_quant=True)
    assert not engine.rows_independent
    assert InferenceEngine(model, tree, max_batch=B, max_seq=SPREAD_SEQ).rows_independent
    sched = ContinuousBatchingScheduler(engine, chunk=4)
    admitted = [(slot, sched.submit([1] * n, max_new_tokens=2))
                for slot, n in enumerate(SPREAD)]
    ids, lengths, slots = sched._build_admit_narrow(admitted)
    assert isinstance(ids, np.ndarray) and ids.shape == (8, 2 * ADMIT_M_FLOOR)
    assert lengths.tolist() == SPREAD + [1, 1] and slots.tolist() == list(range(6)) + [B, B]
