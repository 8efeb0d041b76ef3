"""Pipeline and context parallelism in the port on worlds of gloo ranks on
the CPU, held to the JAX package: ``pp_logits`` (2 and 4 stages, float and
quantized, the split and the replicated head, Gemma's sliding pattern),
``cp_logits`` (ring and gather, contiguous and zigzag, quantized, sliding
window, MoE), ``cp_tp_logits`` on a (seq 2, model 2) mesh (dense and MoE),
and ``perplexity_from_tokens(mesh=)``.

JAX's own PP and CP tests are slow-marked, so each case is held to JAX's
one-device forward (cheap), and one case, at the smallest size, to JAX's
``cp_logits`` itself. Tolerances: the JAX tests' own, ``atol=2e-5,
rtol=1e-5`` for PP and CP, ``atol=2e-4, rtol=1e-4`` for CP x TP;
perplexity within a relative 1e-5 of JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JConfig
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.models.llama import tiny_llama_config as jtiny_llama
from onnx_quantize_tpu.models.moe import stack_moe_experts as jstack
from onnx_quantize_tpu.models.moe import tiny_moe_config as jtiny_moe
from onnx_quantize_tpu.parallel import cp as jcp
from onnx_quantize_tpu.tools.perplexity import perplexity_from_tokens as jppl
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3Config
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config
from onnx_quantize_tpu_torch.tools.perplexity import perplexity_from_tokens

from .torch_world import result, run_world

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5
TP_ATOL, TP_RTOL = 2e-4, 1e-4
LLAMA = dict(hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=16)
GEMMA_PP = dict(num_layers=4, sliding_pattern=2, hidden_size=64, num_heads=2, num_kv_heads=1,
                head_dim=32, sliding_window=8)
GEMMA_CP = dict(GEMMA_PP, sliding_window=6)
MOE_CP = dict(shared_expert_size=128, num_heads=4, num_kv_heads=2, hidden_size=64, head_dim=32,
              moe_intermediate_size=96)
RUNS = [(m, lay) for m in ("ring", "gather") for lay in ("contiguous", "zigzag")]
# name -> (stages, microbatches, batch, model, quantized)
PP_CASES = {"fp_s2_mb4": (2, 4, 8, "llama", False), "fp_s4_mb8": (4, 8, 8, "llama", False),
            "fp_s4_mb4": (4, 4, 8, "llama", False), "quantized_s4_mb8": (4, 8, 8, "llama", True),
            "replicated_head": (4, 3, 6, "llama", False), "gemma_s2": (2, 4, 4, "gemma", False)}


def ids_of(batch, seq):
    return np.random.default_rng(0).integers(1, 256, size=(batch, seq)).astype(np.int32)


def build(kind: str, layers: int = 4, quantized: bool = False, seed: int = 0):
    """(JAX model, JAX params, the port's config dict) of a tiny family model."""
    if kind == "llama":
        jcfg, cfg = (jtiny_llama(num_layers=layers, **LLAMA),
                     tiny_llama_config(num_layers=layers, **LLAMA))
    elif kind == "gemma":
        jcfg, cfg = JConfig.tiny(**GEMMA_PP), Gemma3Config.tiny(**GEMMA_PP)
    elif kind == "gemma_cp":
        jcfg, cfg = JConfig.tiny(**GEMMA_CP), Gemma3Config.tiny(**GEMMA_CP)
    elif kind == "moe":
        jcfg, cfg = jtiny_moe(num_layers=2), tiny_moe_config(num_layers=2)
    else:
        jcfg, cfg = jtiny_moe(**MOE_CP), tiny_moe_config(**MOE_CP)
    model = JGemma3(jcfg)
    params = model.init(jax.random.key(seed))
    if quantized:
        ignore = [r"\.router$", r"\.shared_gate$"] if kind == "moe_tp" else ["lm_head"]
        params, _ = joqt.quantize(model, params, joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="uint4", group_size=16), ignore=ignore))
    if kind == "moe_tp":
        params = jstack(jfuse(params))
    return model, params, dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, wants = {}, {}
    for name, (stages, mb, batch, kind, quantized) in PP_CASES.items():
        model, params, cfg = build(kind, quantized=quantized, seed=1 if kind == "gemma" else 0)
        ids = ids_of(batch, 10 if kind == "gemma" else 12)
        wants[f"pp_{name}"] = np.asarray(model(params, ids))
        cases[f"pp_{name}"] = ("pp", dict(cfg=cfg, params=from_jax_params(params, device="cpu"),
                                          stages=stages, ids=ids, microbatches=mb))
    cp_cases = {"llama": ("llama", False, 2, 16, 4, RUNS),
                "llama_quantized": ("llama", True, 2, 16, 4, [("ring", "contiguous")]),
                "gemma_window": ("gemma_cp", False, 2, 32, 4,
                                 [("ring", "contiguous"), ("ring", "zigzag")]),
                "moe": ("moe", False, 2, 16, 4, [("ring", "contiguous")])}
    for name, (kind, quantized, batch, seq, shards, runs) in cp_cases.items():
        model, params, cfg = build(kind, layers=2, quantized=quantized,
                                   seed={"gemma_cp": 1, "moe": 2}.get(kind, 0))
        ids = ids_of(batch, seq)
        wants[f"cp_{name}"] = np.asarray(model(params, ids))
        if name == "llama":
            with torch.inference_mode():
                wants["cp_llama_port"] = _port_model(cfg)(
                    from_jax_params(params, device="cpu"), torch.from_numpy(ids).long()).numpy()
        cases[f"cp_{name}"] = ("cp", dict(cfg=cfg, params=from_jax_params(params, device="cpu"),
                                          shards=shards, ids=ids, runs=runs))
    # One case against JAX's cp_logits itself, at the smallest size.
    model, params, cfg = build("llama", layers=2)
    ids = ids_of(1, 8)
    wants["cp_jax"] = np.asarray(jcp.cp_logits(model, params, ids, jcp.make_cp_mesh(2),
                                               layout="zigzag"))
    cases["cp_jax"] = ("cp", dict(cfg=cfg, params=from_jax_params(params, device="cpu"),
                                  shards=2, ids=ids, runs=[("ring", "zigzag")]))
    for name, (kind, quantized, runs) in {
            "llama": ("llama", False, [("ring", "contiguous"), ("gather", "zigzag")]),
            "llama_quantized": ("llama", True, [("ring", "zigzag")]),
            "moe": ("moe_tp", True, [("ring", "contiguous")])}.items():
        model, params, cfg = build(kind, layers=2, quantized=quantized,
                                   seed=3 if kind == "moe_tp" else 0)
        ids = ids_of(2, 16)
        wants[f"cptp_{name}"] = np.asarray(model(params, ids))
        cases[f"cptp_{name}"] = ("cp", dict(cfg=cfg, params=from_jax_params(params, device="cpu"),
                                            shards=2, tp=2, ids=ids, runs=runs))
    model, params, cfg = build("llama", layers=2)
    tokens = np.random.default_rng(0).integers(1, 256, size=64)
    wants["ppl"] = jppl(model, params, tokens, max_length=16, stride=8)
    wants["ppl_port"] = perplexity_from_tokens(
        _port_model(cfg), from_jax_params(params, device="cpu"), tokens, 16, 8)
    cases["ppl"] = ("perplexity", dict(cfg=cfg, params=from_jax_params(params, device="cpu"),
                                       shards=4, tokens=tokens, max_length=16, stride=8,
                                       modes=("ring", "gather")))
    return run_world(4, cases, tmp_path_factory.mktemp("pp_cp")), wants


def _port_model(cfg):
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3

    return Gemma3(Gemma3Config(**cfg))


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_matches_jax_forward(world, name):
    results, wants = world
    for rank in range(PP_CASES[name][0]):
        np.testing.assert_allclose(result(results, f"pp_{name}", rank), wants[f"pp_{name}"],
                                   atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(r))
def test_cp_matches_jax_forward(world, run):
    results, wants = world
    for rank in range(4):
        np.testing.assert_allclose(result(results, "cp_llama", rank)[run], wants["cp_llama"],
                                   atol=ATOL, rtol=RTOL)


def test_cp_gather_contiguous_equals_port_forward(world):
    """The gather mode in the contiguous layout sums over the keys in the
    one-device order: its logits are the port's one-device forward's bits."""
    results, wants = world
    for rank in range(4):
        got = result(results, "cp_llama", rank)[("gather", "contiguous")]
        np.testing.assert_array_equal(got, wants["cp_llama_port"], err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", ["llama_quantized", "gemma_window", "moe"])
def test_cp_variants_match_jax_forward(world, name):
    results, wants = world
    for run, got in result(results, f"cp_{name}").items():
        np.testing.assert_allclose(got, wants[f"cp_{name}"], atol=ATOL, rtol=RTOL,
                                   err_msg=str(run))


def test_cp_matches_jax_cp_logits(world):
    results, wants = world
    for rank in range(2):
        np.testing.assert_allclose(result(results, "cp_jax", rank)[("ring", "zigzag")],
                                   wants["cp_jax"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["llama", "llama_quantized", "moe"])
def test_cp_tp_matches_jax_forward(world, name):
    results, wants = world
    for rank in range(4):
        for run, got in result(results, f"cptp_{name}", rank).items():
            np.testing.assert_allclose(got, wants[f"cptp_{name}"], atol=TP_ATOL, rtol=TP_RTOL,
                                       err_msg=f"rank {rank} {run}")


@pytest.mark.parametrize("mode", ["ring", "gather"])
def test_perplexity_on_cp_mesh_matches_jax(world, mode):
    results, wants = world
    for rank in range(4):
        got = result(results, "ppl", rank)[mode]
        assert abs(got - wants["ppl"]) <= 1e-5 * wants["ppl"], (rank, got, wants["ppl"])
        assert abs(got - wants["ppl_port"]) <= 1e-5 * wants["ppl_port"]
