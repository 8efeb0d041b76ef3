"""Checkpoints in the port, and across the two packages.

Counterpart of ``tests/test_checkpoint.py``, plus: a bfloat16 tree round
trips (its leaves as uint16 bits, named in ``meta.json``: the JAX writer's
raw ``|V2`` bytes do not load); the JAX package and the port read each
other's float32 checkpoints; the engine's baked scale layout and the logical
one both load; a QuaRot checkpoint carries its folded rotation, and the
online transforms must be stamped again (the logits differ without).
Tolerances: a round trip within the port is bit-equal; across packages the
logits agree within 1e-5 abs (float32 summation order).
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu import checkpoint as jckpt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.llama import tiny_llama_config as jtiny_llama_config
from onnx_quantize_tpu.models.moe import tiny_moe_config
from onnx_quantize_tpu.prepasses.rotate import stamp_online_rotations as jstamp
from onnx_quantize_tpu_torch.checkpoint import (
    load_checkpoint,
    load_params,
    save_checkpoint,
    save_params,
)
from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor
from onnx_quantize_tpu_torch.prepasses.rotate import stamp_online_rotations
from onnx_quantize_tpu_torch.utils import tree_map

from .torch_helpers import TwoMatMul

IDS = np.array([[1, 2, 3, 4], [9, 8, 7, 6]], np.int32)
ONLINE = dict(rotate_qk=True, rotate_v=True, rotate_down=True, online_block=64, seed=4)


def _run(model, params, ids=IDS):
    return model(params, torch.from_numpy(ids).long()).float().numpy()


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _tensors(leaf):
    if isinstance(leaf, (QTensor, QBias)):
        names = ("data", "scale", "zero_point", "input_scale", "input_zero_point",
                 "output_scale", "output_zero_point")
        return [getattr(leaf, n, None) for n in names]
    return [leaf]


def _assert_trees_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert type(x) is type(y)
        for s, t in zip(_tensors(x), _tensors(y), strict=True):
            if s is None:
                assert t is None
                continue
            assert s.dtype == t.dtype and s.shape == t.shape
            assert torch.equal(s, t)


def test_quantized_checkpoint_roundtrip(tmp_path):
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(torch.Generator().manual_seed(0))
    qparams, plan = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=["lm_head"]))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, model, qparams, plan)
    model2, params2 = load_checkpoint(path, device="cpu")
    assert model2.cfg == model.cfg
    _assert_trees_bit_equal(qparams, params2)
    np.testing.assert_array_equal(_run(model2, params2), _run(model, qparams))


def test_qbias_roundtrip(tmp_path):
    model = TwoMatMul(bias=True)
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen)
    for site in ("fc1", "fc2"):
        params[site]["b"] = 0.1 * torch.randn(params[site]["b"].shape, generator=gen)
    x = 0.1 * torch.randn((4, 16), generator=gen)
    static = oqt.QActivationArgs(dtype="uint8")
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        format="qlinear", weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        input_activations=static, output_activations=static, calibration_data=x.numpy()))
    assert isinstance(qparams["fc1"]["b"], QBias)
    path = str(tmp_path / "ckpt2")
    save_params(path, qparams)
    params2, _ = load_params(path, device="cpu")
    _assert_trees_bit_equal(qparams, params2)
    np.testing.assert_array_equal(model(params2, x).numpy(), model(qparams, x).numpy())


def test_bf16_checkpoint_round_trips(tmp_path):
    """A bfloat16 Llama tree (float leaves and a W4 body): the same bits, the
    same dtypes and the same logits after the reload."""
    model = Gemma3(tiny_llama_config(dtype="bfloat16"))
    params = model.init(torch.Generator().manual_seed(2))
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16), ignore=["lm_head"]))
    assert qparams["embed"]["w"].dtype == torch.bfloat16
    path = str(tmp_path / "bf16")
    save_checkpoint(path, model, qparams)
    model2, params2 = load_checkpoint(path, device="cpu")
    assert model2.cfg == model.cfg
    _assert_trees_bit_equal(qparams, params2)
    np.testing.assert_array_equal(_run(model2, params2), _run(model, qparams))


def test_engine_baked_and_logical_layouts_both_load(tmp_path):
    """A tree after ``prepare_kernel_scales`` saves its baked (G_pad/2, 2, N)
    scales and says so; both layouts reload and serve the same logits."""
    model = Gemma3(Gemma3Config.tiny())
    params = model.init(torch.Generator().manual_seed(3))
    qparams, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=["lm_head"]))
    baked = prepare_kernel_scales(fuse_gemma3_projections(qparams))
    assert baked["layers.0"]["attn"]["_fused_qkv"]["w"].scale.ndim == 3
    logits = {}
    for name, tree in (("logical", qparams), ("baked", baked)):
        path = str(tmp_path / name)
        save_params(path, tree)
        back, _ = load_params(path, device="cpu")
        _assert_trees_bit_equal(tree, back)
        engine = InferenceEngine(model, back, max_batch=2, max_seq=16, kv_quant=True)
        _, logits[name] = engine.prefill(engine.new_cache(), IDS, np.array([4, 4], np.int32))
    assert torch.equal(logits["logical"], logits["baked"])
    with open(tmp_path / "baked" / "meta.json") as f:
        assert '"scale_layout": "baked"' in f.read()


def _jax_rotated_llama():
    jmodel = JGemma3(jtiny_llama_config(num_layers=2, tie_lm_head=False))
    jparams = jmodel.init(jax.random.key(5))
    jq, jplan = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[joqt.RotateConfig(**ONLINE)], ignore=["lm_head"]))
    return jmodel, jq, jplan


def test_jax_written_checkpoint_loads_into_port(tmp_path):
    """A float32 QuaRot checkpoint written by the JAX package: the port
    rebuilds the Llama model, re-stamps the online rotations and gives JAX's
    logits; without the stamp the logits differ."""
    jmodel, jq, jplan = _jax_rotated_llama()
    path = str(tmp_path / "jax")
    jckpt.save_checkpoint(path, jmodel, jq, jplan)
    want = np.asarray(jmodel(jq, IDS))
    model, params = load_checkpoint(path, device="cpu")
    assert model.cfg == tiny_llama_config(num_layers=2, tie_lm_head=False)
    unstamped = _run(model, params)
    stamp_online_rotations(model, qk=True, down=True, block=64, seed=ONLINE["seed"])
    np.testing.assert_allclose(_run(model, params), want, atol=1e-5, rtol=0)
    assert np.abs(unstamped - want).max() > 1e-2


def test_port_written_checkpoint_loads_into_jax(tmp_path):
    """The port's float32 QuaRot checkpoint in the JAX package: JAX rebuilds
    the model, re-stamps and gives the port's logits."""
    jmodel, jq, _ = _jax_rotated_llama()
    model = Gemma3(tiny_llama_config(num_layers=2, tie_lm_head=False))
    jparams = JGemma3(jmodel.cfg).init(jax.random.key(5))
    q, plan = oqt.quantize(model, from_jax_params(jparams, device="cpu"), oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[oqt.RotateConfig(**ONLINE)], ignore=["lm_head"]))
    path = str(tmp_path / "port")
    save_checkpoint(path, model, q, plan)
    jmodel2, jparams2 = jckpt.load_checkpoint(path)
    jstamp(jmodel2, qk=True, down=True, block=64, seed=ONLINE["seed"])
    np.testing.assert_allclose(np.asarray(jmodel2(jparams2, IDS)), _run(model, q), atol=1e-5,
                               rtol=0)


def test_rotated_checkpoint_needs_the_stamp(tmp_path):
    """Within the port: the reload is bit-equal once stamped again, and differs
    without the stamp."""
    model = Gemma3(tiny_llama_config(num_layers=2))
    params = model.init(torch.Generator().manual_seed(6))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[oqt.RotateConfig(**ONLINE)], ignore=["lm_head"]))
    want = _run(model, q)
    path = str(tmp_path / "rot")
    save_checkpoint(path, model, q)
    model2, params2 = load_checkpoint(path, device="cpu")
    assert np.abs(_run(model2, params2) - want).max() > 1e-2
    stamp_online_rotations(model2, qk=True, down=True, block=64, seed=ONLINE["seed"])
    np.testing.assert_array_equal(_run(model2, params2), want)


def test_moe_checkpoint_waits_for_moe(tmp_path):
    """An MoE checkpoint written by the JAX package (uint4 experts, a shared
    expert) loads into the port: the MoE config rebuilt, every leaf bit-equal
    to the bridged JAX tree, and JAX's logits; the stacked engine layout of it
    round trips through the port's checkpoint bit-equal."""
    from onnx_quantize_tpu.models.moe import stack_moe_experts as jstack

    from onnx_quantize_tpu_torch.models.moe import stack_moe_experts
    from onnx_quantize_tpu_torch.models.moe import tiny_moe_config as port_tiny_moe_config

    cfg = dict(num_layers=2, shared_expert_size=48)
    jmodel = JGemma3(tiny_moe_config(**cfg))
    jq, jplan = joqt.quantize(jmodel, jmodel.init(jax.random.key(0)), joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16),
        ignore=[r"\.router$", r"\.shared_gate$"]))
    path = str(tmp_path / "moe")
    jckpt.save_checkpoint(path, jmodel, jq, jplan)
    model, params = load_checkpoint(path, device="cpu")
    assert model.cfg == port_tiny_moe_config(**cfg)
    assert model.layers[0].mlp.cfg.num_experts == 4
    _assert_trees_bit_equal(params, from_jax_params(jq, device="cpu"))
    np.testing.assert_allclose(_run(model, params), np.asarray(jmodel(jq, IDS)), atol=1e-5,
                               rtol=0)
    stacked = stack_moe_experts(fuse_gemma3_projections(params))
    save_checkpoint(str(tmp_path / "stacked"), model, stacked)
    _, back = load_checkpoint(str(tmp_path / "stacked"), device="cpu")
    _assert_trees_bit_equal(back, stacked)
    np.testing.assert_array_equal(_run(model, back), _run(model, stacked))
    # JAX's stacking of the same tree, bridged: the same leaves.
    from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse

    _assert_trees_bit_equal(from_jax_params(jstack(jfuse(jq)), device="cpu"), stacked)
