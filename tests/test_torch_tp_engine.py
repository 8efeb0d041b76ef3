"""The port's engine on a (data, model) mesh of gloo ranks on the CPU, held to
the JAX package's engine: tensor parallelism with KV heads split (tp 2) and
replicated and sliced (tp 4), unfused and fused projections, a (data 2,
model 2) mesh, the GQA grid, EOS freeze, serve rounds through the
scheduler, and the refusals of the mesh path. Sampled decoding on a (data
2, model 1) mesh is held to the port's single-device engine (the random
streams are the port's own, not JAX's).

One world of four ranks runs every case (``tests/torch_world.py``); a case
on two ranks leaves the other two out of its mesh. Tolerance: the JAX dry
run's, prefill logits within ``atol=2e-4, rtol=1e-4`` of the JAX engine's,
first tokens, greedy tokens and served outputs equal; every rank of a case
returns the same outputs.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler as JScheduler
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JConfig
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.parallel import make_mesh as jmake_mesh
from onnx_quantize_tpu_torch.interop import from_jax_params

from .torch_world import result, run_world

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4
TP_FRIENDLY = dict(vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
                   num_heads=8, num_kv_heads=2, head_dim=64, sliding_window=16,
                   sliding_pattern=2)
# tests/parallel/test_tp_engine.py's grid config, at its KV head count.
GRID = dict(vocab_size=256, hidden_size=128, intermediate_size=128, num_layers=2, num_heads=4,
            head_dim=32, sliding_window=16, sliding_pattern=2)
ENGINE_CASES = {"tp2_unfused": (1, 2, False), "tp2_fused": (1, 2, True),
                "tp4_unfused": (1, 4, False), "tp4_fused": (1, 4, True),
                "dp2_tp2_unfused": (2, 2, False), "dp2_tp2_fused": (2, 2, True)}
GRID_CASES = [(1, 2), (1, 4), (2, 2), (4, 2), (4, 4), (2, 4)]
STEPS = 2
SAMPLED_STEPS = 6


def quantized(cfg: dict):
    model = JGemma3(JConfig.tiny(**cfg))
    q, _ = joqt.quantize(model, model.init(jax.random.key(0)),
                         joqt.QConfig(weights=joqt.QWeightArgs(dtype="uint4", group_size=16)))
    return model, q


def jax_engine(model, params, ids, prompts=None, mesh=None, eos=None):
    """The JAX engine's prefill, greedy decode_multi and serve rounds."""
    B = ids.shape[0]
    lengths = np.full((B,), ids.shape[1], np.int32)
    engine = JEngine(model, params, max_batch=B, max_seq=32, kv_quant=True, mesh=mesh)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = np.asarray(np.argmax(logits, -1), np.int32)
    cache, gen = engine.decode_multi(cache, first, steps=STEPS, eos_token_id=eos)
    out = {"logits": np.asarray(logits), "first": first, "gen": np.asarray(gen),
           "lengths": np.asarray(cache["lengths"])}
    if prompts is not None:
        sched = JScheduler(engine, chunk=2, pipeline=2)
        reqs = [sched.submit(list(p), max_new_tokens=3) for p in prompts]
        sched.run()
        out["served"] = [r.output for r in reqs]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jmodel, q = quantized(TP_FRIENDLY)
    fq = jfuse(q)
    ids = np.random.default_rng(3).integers(1, 512, size=(4, 8)).astype(np.int32)
    lengths = np.full((4,), 8, np.int32)
    prompts = [ids[i, :5].tolist() for i in range(4)]
    want = jax_engine(jmodel, q, ids, prompts)
    want_mesh = jax_engine(jmodel, fq, ids, prompts,
                           mesh=jmake_mesh(model_parallel=4, devices=jax.devices()[:4]))
    eos = int(want["gen"][0, 0])
    want_eos = jax_engine(jmodel, q, ids, eos=eos)
    ported = {False: from_jax_params(q, device="cpu"), True: from_jax_params(fq, device="cpu")}
    common = dict(cfg=TP_FRIENDLY, ids=ids, lengths=lengths, steps=STEPS, prompts=prompts)
    cases = {"single": ("engine", dict(params=ported[False], dp=0, tp=1, **common))}
    for name, (dp, tp, fused) in ENGINE_CASES.items():
        cases[name] = ("engine", dict(params=ported[fused], dp=dp, tp=tp,
                                      eos_from_first=name == "dp2_tp2_fused",
                                      refusals=name == "tp4_unfused", **common))
    # Sampled: rows 0 and 2 (the first row of each data rank) hold one prompt.
    sids = ids.copy()
    sids[2] = sids[0]
    sprompts = [sids[i, :5].tolist() for i in range(4)]
    for name, dp in (("single_sampled", 0), ("dp2_sampled", 2)):
        cases[name] = ("engine", dict(cfg=TP_FRIENDLY, params=ported[False], dp=dp, tp=1,
                                      ids=sids, lengths=lengths, steps=SAMPLED_STEPS,
                                      prompts=sprompts, max_new_tokens=SAMPLED_STEPS,
                                      sample_seed=11))
    grid_want = {}
    for kv in sorted({kv for kv, _ in GRID_CASES}):
        cfg = dict(GRID, num_kv_heads=kv)
        gmodel, gq = quantized(cfg)
        gids = np.random.default_rng(7).integers(1, 256, size=(4, 8)).astype(np.int32)
        grid_want[kv] = jax_engine(gmodel, gq, gids)
        gparams = from_jax_params(gq, device="cpu")
        for _, tp in [c for c in GRID_CASES if c[0] == kv]:
            cases[f"grid_kv{kv}_tp{tp}"] = ("engine", dict(
                cfg=cfg, params=gparams, dp=1, tp=tp, ids=gids, lengths=lengths, steps=STEPS))
    results = run_world(4, cases, tmp_path_factory.mktemp("tp_engine"))
    return results, want, want_mesh, want_eos, grid_want


def members(name):
    dp, tp, _ = ENGINE_CASES[name]
    return range(dp * tp)


def assert_engine_equal(got, want, served=True):
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got["first"], want["first"])
    np.testing.assert_array_equal(got["gen"], want["gen"])
    if served:
        assert got["served"] == want["served"]


def test_single_device_port_matches_jax(world):
    results, want, *_ = world
    assert_engine_equal(result(results, "single"), want)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_tp_engine_matches_jax_single_device(world, name):
    results, want, *_ = world
    for rank in members(name):
        assert_engine_equal(result(results, name, rank), want)
    for rank in range(len(members(name)), 4):
        assert results[rank][name] is None


def test_tp4_fused_matches_jax_mesh_engine(world):
    results, _, want_mesh, *_ = world
    assert_engine_equal(result(results, "tp4_fused"), want_mesh)


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_tp_engine_ranks_agree_and_hold_their_rows(world, name):
    """Every rank returns the same global outputs; each holds the cache rows
    of its data coordinate."""
    results, want, *_ = world
    dp, tp, _ = ENGINE_CASES[name]
    first = result(results, name, 0)
    for rank in members(name):
        got = result(results, name, rank)
        assert got["logits"].tobytes() == first["logits"].tobytes()
        assert got["served"] == first["served"]
        rows = slice((rank // tp) * 4 // dp, (rank // tp + 1) * 4 // dp)
        np.testing.assert_array_equal(got["lengths"], want["lengths"][rows])


@pytest.mark.parametrize("kv,tp", GRID_CASES)
def test_tp_engine_gqa_grid(world, kv, tp):
    """KV heads split, replicated and sliced, or replicated (MQA), across the
    kv x tp grid of tests/parallel/test_tp_engine.py."""
    results, *_, grid_want = world
    got = result(results, f"grid_kv{kv}_tp{tp}")
    assert_engine_equal(got, grid_want[kv], served=False)
    np.testing.assert_array_equal(got["lengths"], grid_want[kv]["lengths"])


def test_tp_engine_eos_freeze_matches_jax(world):
    results, want, _, want_eos, _ = world
    for rank in members("dp2_tp2_fused"):
        got = result(results, "dp2_tp2_fused", rank)
        assert got["eos"] == int(want["gen"][0, 0])
        np.testing.assert_array_equal(got["gen_eos"], want_eos["gen"])
        rows = slice((rank // 2) * 2, (rank // 2 + 1) * 2)
        np.testing.assert_array_equal(got["lengths_eos"], want_eos["lengths"][rows])
    assert (want_eos["gen"][0, 1:] == want_eos["gen"][0, 0]).all()


@pytest.mark.parametrize("what", ["speculative", "score_nll", "prefix", "narrow"])
def test_mesh_engine_refuses_as_jax(world, what):
    """What the JAX engine refuses on a mesh raises NotImplementedError here too."""
    results, *_ = world
    refused = result(results, "tp4_unfused")["refused"]
    assert refused[what] is not None, f"{what} ran on a mesh engine"


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_sampled_decode_matches_single_device(world, rank):
    """A (data 2, model 1) engine sampling from a seeded generator gives the
    single-device engine's tokens, in decode_multi and in serve rounds: each
    data rank draws the whole batch's noise and keeps its rows."""
    results, *_ = world
    want = result(results, "single_sampled")
    got = result(results, "dp2_sampled", rank)
    np.testing.assert_array_equal(got["sampled"], want["sampled"])
    assert got["served_sampled"] == want["served_sampled"]


def test_dp_sampled_equal_prompts_draw_their_own_streams(world):
    """Slots 0 and B/2 hold one prompt; on the mesh they are the first row
    of each data rank, and still sample different streams."""
    results, *_ = world
    got = result(results, "dp2_sampled")
    assert got["sampled"][0].tolist() != got["sampled"][2].tolist()
    assert got["served_sampled"][0] != got["served_sampled"][2]
