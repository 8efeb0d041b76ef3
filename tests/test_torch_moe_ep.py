"""Expert parallelism in the port on worlds of gloo ranks on the CPU, held to
the JAX package: the MoE engine on a mesh (stacked and fused experts split
over the model axis, attention tensor-parallel, the shared expert a Megatron
pair; with and without the shared expert; serve rounds), the refusal of
indivisible experts, and the token-split ``a2a_moe_mlp`` with and without
capacity drops (the cases of ``tests/parallel/test_moe_ep.py`` and
``test_ep_a2a.py``).

Tolerances: the engine as the JAX TP tests (prefill logits within
``atol=2e-4, rtol=1e-4`` of JAX's single-device engine, tokens and served
outputs equal); ``a2a_moe_mlp`` within 2e-5 of the JAX MoE MLP and of JAX's
``a2a_moe_mlp`` (``test_ep_a2a.py``'s bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.engine import ContinuousBatchingScheduler as JScheduler
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.models.moe import fuse_moe_experts as jfuse_experts
from onnx_quantize_tpu.models.moe import stack_moe_experts as jstack
from onnx_quantize_tpu.models.moe import tiny_moe_config as jtiny_moe
from onnx_quantize_tpu.nn.qtensor import QTensor as JQTensor
from onnx_quantize_tpu.parallel.ep import a2a_moe_mlp as ja2a
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config

from .torch_world import result, run_world

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4
A2A_ATOL = 2e-5
EP = 4
MOE = dict(shared_expert_size=128, num_heads=4, num_kv_heads=2, hidden_size=64, head_dim=32,
           moe_intermediate_size=96)
LAYOUTS = {"stacked": jstack, "fused": jfuse_experts}


def quantized_moe(shared: int, layout):
    kw = dict(MOE, shared_expert_size=shared)
    model = JGemma3(jtiny_moe(**kw))
    q, _ = joqt.quantize(model, model.init(jax.random.key(0)), joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16),
        ignore=[r"\.router$", r"\.shared_gate$"]))
    return model, layout(jfuse(q)), dataclasses.asdict(tiny_moe_config(**kw))


def jax_engine(model, tree, ids, max_seq=32, kv_quant=True, steps=3, prompts=None):
    B = ids.shape[0]
    engine = JEngine(model, tree, max_batch=B, max_seq=max_seq, kv_quant=kv_quant)
    cache, logits = engine.prefill(engine.new_cache(), ids, np.full((B,), ids.shape[1], np.int32))
    first = np.asarray(np.argmax(logits, -1), np.int32)
    _, gen = engine.decode_multi(cache, first, steps=steps)
    out = {"logits": np.asarray(logits), "first": first, "gen": np.asarray(gen)}
    if prompts is not None:
        sched = JScheduler(engine, chunk=2, pipeline=2)
        reqs = [sched.submit(p, max_new_tokens=4) for p in prompts]
        sched.run()
        out["served"] = [r.output for r in reqs]
    return out


def a2a_setup(quantized: bool):
    cfg = jtiny_moe(num_experts=4, num_experts_per_tok=2, hidden_size=64,
                    moe_intermediate_size=96, norm_topk_prob=True)
    model = JGemma3(cfg)
    params = model.init(jax.random.key(0))
    if quantized:
        params, _ = joqt.quantize(model, params, joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="uint4", group_size=16), ignore=[r"\.router$"]))
    mlp_params = jstack(jfuse(params))["layers.0"]["mlp"]
    return cfg, model.blocks[0].mlp, mlp_params


def jax_a2a(cfg, mlp, mlp_params, x, top_p, top_i, capacity):
    mesh = JMesh(np.asarray(jax.devices()[:EP]), ("ep",))
    experts = mlp_params["_stacked_experts"]

    def spec(leaf):
        if isinstance(leaf, JQTensor):
            children, meta = leaf.tree_flatten()
            return JQTensor.tree_unflatten(meta, tuple(None if c is None else JP("ep")
                                                       for c in children))
        return JP("ep")

    def fn(x_local, tp, ti, experts_local):
        return ja2a(x_local, experts_local, tp, ti, axis="ep", num_experts=cfg.num_experts,
                    activation=mlp.activation, capacity=capacity)

    specs = jax.tree.map(spec, experts, is_leaf=lambda v: isinstance(v, JQTensor))
    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(JP("ep"), JP("ep"), JP("ep"), specs), out_specs=JP("ep"),
        check_vma=False))(x, top_p, top_i, experts))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, wants = {}, {}
    ids = np.random.default_rng(0).integers(1, 256, size=(4, 8)).astype(np.int32)
    lengths = np.full((4,), 8, np.int32)
    for name, layout in LAYOUTS.items():
        model, tree, cfg = quantized_moe(128, layout)
        wants[name] = jax_engine(model, tree, ids)
        params = from_jax_params(tree, device="cpu")
        for dp, tp in ((2, 2), (1, 4)):
            cases[f"{name}_tp{tp}"] = ("engine", dict(cfg=cfg, params=params, dp=dp, tp=tp,
                                                      ids=ids, lengths=lengths, steps=3))
    # Without the shared expert: prefill at (2, 6), a float cache of 16.
    model, tree, cfg = quantized_moe(0, jstack)
    ids2 = np.random.default_rng(1).integers(1, 256, size=(2, 6)).astype(np.int32)
    wants["no_shared"] = jax_engine(model, tree, ids2, max_seq=16, kv_quant=False, steps=1)
    cases["no_shared"] = ("engine", dict(cfg=cfg, params=from_jax_params(tree, device="cpu"),
                                         dp=1, tp=4, ids=ids2, lengths=np.full((2,), 6, np.int32),
                                         steps=1, max_seq=16, kv_quant=False))
    # Serve rounds on a (data 2, model 2) mesh at max_batch 2.
    model, tree, cfg = quantized_moe(128, jstack)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=int(n)).tolist() for n in (5, 3, 7, 4)]
    wants["serve"] = jax_engine(model, tree, ids[:2], prompts=prompts)
    cases["serve"] = ("engine", dict(cfg=cfg, params=from_jax_params(tree, device="cpu"), dp=2,
                                     tp=2, ids=ids[:2], lengths=lengths[:2], steps=3,
                                     prompts=prompts, max_new_tokens=4))
    # a2a_moe_mlp: 8 rows a rank; capacities None, 1 (drops) and the worst case.
    for quantized in (False, True):
        cfg_a, mlp, mlp_params = a2a_setup(quantized)
        M = 8 * EP
        x = jnp.asarray(np.random.default_rng(0).standard_normal((M, cfg_a.hidden_size)),
                        jnp.float32)
        top_p, top_i = mlp._routing(mlp_params, x, None)
        caps = (None, 1, (M // EP) * cfg_a.num_experts_per_tok)
        key = "a2a_quantized" if quantized else "a2a_fp"
        wants[key] = {"module": np.asarray(mlp(mlp_params, x[:, None, :])[:, 0]),
                      **{cap: jax_a2a(cfg_a, mlp, mlp_params, x, top_p, top_i, cap)
                         for cap in caps}}
        cases[key] = ("a2a", dict(
            ep=EP, x=torch.from_numpy(np.array(x)), top_p=torch.from_numpy(np.array(top_p)),
            top_i=torch.from_numpy(np.array(top_i)).long(),
            stacked=from_jax_params(mlp_params["_stacked_experts"], device="cpu"),
            num_experts=cfg_a.num_experts, activation=mlp.activation, capacities=caps))
    return run_world(4, cases, tmp_path_factory.mktemp("moe_ep")), wants


def assert_engine_equal(got, want):
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got["first"], want["first"])
    np.testing.assert_array_equal(got["gen"], want["gen"])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_ep_engine_matches_jax_single_device(world, layout, tp):
    results, wants = world
    for rank in range(4):
        assert_engine_equal(result(results, f"{layout}_tp{tp}", rank), wants[layout])


def test_moe_ep_without_shared_expert(world):
    results, wants = world
    np.testing.assert_allclose(result(results, "no_shared")["logits"],
                               wants["no_shared"]["logits"], atol=ATOL, rtol=RTOL)


def test_moe_ep_serve_rounds_match_jax(world):
    results, wants = world
    for rank in range(4):
        assert result(results, "serve", rank)["served"] == wants["serve"]["served"]


def test_moe_tp_rejects_indivisible_experts():
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3

    with pytest.raises(ValueError, match="num_experts"):
        JGemma3(jtiny_moe(num_experts=3, num_heads=4, head_dim=32)).tp_localize(tp=2)
    with pytest.raises(ValueError, match="num_experts"):
        Gemma3(tiny_moe_config(num_experts=3, num_heads=4, head_dim=32)).tp_localize(tp=2)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "quantized"])
def test_a2a_matches_single_device_and_jax(world, quantized):
    results, wants = world
    key = "a2a_quantized" if quantized else "a2a_fp"
    want = wants[key]
    got = np.concatenate([result(results, key, r)[None] for r in range(EP)])
    np.testing.assert_allclose(got, want["module"], atol=A2A_ATOL, rtol=A2A_ATOL)
    np.testing.assert_allclose(got, want[None], atol=A2A_ATOL, rtol=A2A_ATOL)


def test_a2a_capacity_drops_are_zero_contributions(world):
    results, wants = world
    want = wants["a2a_fp"]
    caps = [c for c in want if c not in ("module", None)]
    exact = np.concatenate([result(results, "a2a_fp", r)[None] for r in range(EP)])
    dropped = np.concatenate([result(results, "a2a_fp", r)[1] for r in range(EP)])
    worst = np.concatenate([result(results, "a2a_fp", r)[caps[1]] for r in range(EP)])
    assert np.isfinite(dropped).all() and not np.allclose(dropped, exact)
    np.testing.assert_allclose(dropped, want[1], atol=A2A_ATOL, rtol=A2A_ATOL)
    np.testing.assert_array_equal(worst, exact)
