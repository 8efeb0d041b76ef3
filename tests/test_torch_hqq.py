"""HQQ in the port against the JAX package, on the same numpy weights, and
its route through the kernels.

Tolerances: the codes and scales are exact; the float zero points within
1e-6 relative (the port takes the group means in float64 and rounds them,
JAX sums in float32). An HQQ site with dynamic int8 inputs runs W4 behind
the activation QDQ, never W4A8 (a float zero point cannot fold into the
int8 sums), with baked scales too; the tiny model's sites on JAX's own
inputs agree within 1e-5 of max|y|, its logits within the int8 tie-flip
bound of ``test_torch_w8a8.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu import ops as jax_ops
from onnx_quantize_tpu.algorithms.hqq import hqq_quantize as jax_hqq
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import QTensor as JQTensor
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp
from onnx_quantize_tpu_torch.algorithms import hqq_quantize
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QTensor
from onnx_quantize_tpu_torch.ops import convert_to_w4a8, quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, select_kernel

torch.set_num_threads(1)

ZP_RTOL = 1e-6
REL_TOL = 1e-5
FLIP_TOL = 5e-2  # test_torch_w8a8.py's bound for int8 tie flips through the layers


def _weight(K, N, seed):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    w[:, 0] = 0.0  # a zero column: scale 1, its codes at the zero point
    return w


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("K,N,gs,iters", [(128, 48, 32, 20), (256, 32, 64, 20),
                                          (64, 40, 16, 5), (192, 16, 128, 30)])
def test_hqq_matches_jax(K, N, gs, iters, early_stop):
    w = _weight(K, N, seed=K + gs)
    jq, js, jz = jax_hqq(w, JQuantType.QUInt4, gs, iters=iters, early_stop=early_stop)
    tq, ts, tz = hqq_quantize(torch.from_numpy(w), QuantType.QUInt4, gs, iters=iters,
                              early_stop=early_stop)
    assert tz.dtype == torch.float32 and tq.dtype == torch.uint8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=ZP_RTOL, atol=0)
    # The loop moved the zero points off the integers.
    assert np.mean(np.asarray(jz) != np.round(np.asarray(jz))) > 0.5


def test_hqq_variants_match_jax():
    """reduce_range, a clip ratio and the MSE-searched start."""
    w = _weight(128, 24, seed=9)
    for kw in (dict(reduce_range=True), dict(clip_ratio=0.9), dict(mse=True),
               dict(lp_norm=0.5, beta=5.0, kappa=1.05)):
        jq, js, jz = jax_hqq(w, JQuantType.QUInt4, 32, **kw)
        tq, ts, tz = hqq_quantize(torch.from_numpy(w), QuantType.QUInt4, 32, **kw)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=ZP_RTOL, atol=0)


# (QWeightArgs keywords): HQQ's constraints are checked before the strategy
# is inferred, as in the JAX package (so a bare group_size is refused).
ARGS_CASES = [
    dict(dtype="uint4", strategy="group", group_size=32),
    dict(dtype="uint4", group_size=32),
    dict(dtype="int4", strategy="group", group_size=32),
    dict(dtype="uint4", strategy="group", group_size=32, symmetric=True),
    dict(dtype="uint4", strategy="group", group_size=24),
    dict(dtype="uint4", strategy="group", group_size=8),
    dict(dtype="uint4", strategy="channel", group_size=-1),
]


def _args_outcome(pkg, kwargs):
    try:
        w = pkg.QWeightArgs(**kwargs, algorithm=pkg.HqqConfig())
    except ValueError:
        return "ValueError"
    return (w.strategy.value, str(w.zp_dtype).replace("torch.", ""))


@pytest.mark.parametrize("kwargs", ARGS_CASES, ids=lambda k: "-".join(map(str, k.values())))
def test_hqq_weight_args_validate_like_jax(kwargs):
    assert _args_outcome(toqt, kwargs) == _args_outcome(joqt, kwargs)


TINY = dict(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
            head_dim=64, sliding_window=8, vocab_size=256)
DYN_INT8 = dict(mode="dynamic", dtype="int8", symmetric=True)


def _dynamic_int8(tree, make):
    """Every QTensor of the tree with dynamic symmetric int8 inputs."""
    if isinstance(tree, dict):
        return {k: _dynamic_int8(v, make) for k, v in tree.items()}
    if isinstance(tree, (QTensor, JQTensor)):
        return make(tree)
    return tree


def _jax_a8(qt):
    meta = dataclasses.replace(qt.meta, input_quant=JActQuantSpec(**DYN_INT8))
    return JQTensor(qt.data, qt.scale, qt.zero_point, meta, qt.input_scale,
                    qt.input_zero_point, qt.output_scale, qt.output_zero_point)


def _port_a8(qt):
    return dataclasses.replace(qt, meta=dataclasses.replace(
        qt.meta, input_quant=ActQuantSpec(**DYN_INT8)))


@pytest.fixture(scope="module")
def hqq_a8_models():
    """HQQ uint4 g32 body in both packages (the port quantizes the bridged
    float weights itself), every body site then given dynamic int8 inputs."""
    jmodel, tmodel = JGemma3(JGemma3Config.tiny(**TINY)), Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(5))
    w = dict(dtype="uint4", strategy="group", group_size=32)
    jq, _ = joqt.quantize(jmodel, params, joqt.QConfig(
        weights=joqt.QWeightArgs(**w, algorithm=joqt.HqqConfig()), ignore=["lm_head"]))
    tq, _ = toqt.quantize(tmodel, from_jax_params(params, device="cpu"), toqt.QConfig(
        weights=toqt.QWeightArgs(**w, algorithm=toqt.HqqConfig()), ignore=["lm_head"]))
    return jmodel, _dynamic_int8(jq, _jax_a8), tmodel, _dynamic_int8(tq, _port_a8)


def _sites(tree):
    for layer in ("layers.0", "layers.1"):
        for block, names in (("attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                yield tree[layer][block][name]["w"]


def test_hqq_tree_matches_jax_and_skips_w4a8(hqq_a8_models):
    _, jp, _, tp = hqq_a8_models
    for jqt, tqt in zip(_sites(jp), _sites(tp)):
        assert tqt.meta.float_zero_point
        assert tqt.meta == from_jax_params({"w": jqt}, device="cpu")["w"].meta
        np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
        np.testing.assert_allclose(tqt.zero_point.numpy(), np.asarray(jqt.zero_point),
                                   rtol=ZP_RTOL, atol=0)
        baked = prepare_kernel_scales({"w": tqt})["w"]
        assert baked.meta.float_zero_point
        for qt in (tqt, baked):
            x = torch.zeros((1, qt.meta.shape[0]))
            assert select_kernel(x, qt, None).__module__ == matmul_w4.__name__
    # convert_to_w4a8 leaves HQQ sites weight-only, baked or not.
    weight_only = _dynamic_int8(tp, lambda qt: dataclasses.replace(
        qt, meta=dataclasses.replace(qt.meta, input_quant=ActQuantSpec(mode="none"))))
    for tree in (weight_only, prepare_kernel_scales(weight_only)):
        assert all(qt.meta.input_quant.mode == "none" for qt in _sites(convert_to_w4a8(tree)))


@pytest.mark.parametrize("bake", [False, True])
def test_hqq_a8_sites_and_logits_match_jax(hqq_a8_models, monkeypatch, bake):
    """Each site fed the JAX package's own input through the port's dispatch
    (W4 behind the int8 QDQ) within 1e-5 of max|y|; the logits within the
    tie-flip bound; before and after the scales are baked."""
    jmodel, jp, tmodel, tp = hqq_a8_models
    ids = np.random.default_rng(3).integers(0, TINY["vocab_size"], (3, 12)).astype(np.int32)
    seen = []

    def record(x, qt, bias=None):
        y = quantized_matmul_jnp(x, qt, bias)
        seen.append((np.array(x), qt, np.asarray(y)))
        return y

    monkeypatch.setattr(jax_ops, "quantized_matmul_jnp", record)
    want = np.asarray(jmodel(jp, ids))
    assert len(seen) == 7 * TINY["num_layers"]
    for x, jqt, y in seen:
        tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
        if bake:
            tqt = prepare_kernel_scales({"w": tqt})["w"]
        counts = matmul_w4.launches
        got = quantized_matmul(torch.from_numpy(x), tqt).numpy()
        assert matmul_w4.launches == counts  # the plain version on the CPU
        np.testing.assert_allclose(got, y, rtol=0, atol=REL_TOL * np.abs(y).max())
    params = prepare_kernel_scales(tp) if bake else tp
    got = tmodel(params, torch.from_numpy(ids).long()).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= FLIP_TOL * np.abs(want).max()
    assert np.median(diff) <= REL_TOL * np.abs(want).max()
