"""The PyTorch port's qparam math against the JAX package: bit-equal codes,
scales and zero points from the same float32 weights."""

import dataclasses

import numpy as np
import pytest
import torch

import onnx_quantize_tpu as oqt
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core import numerics as jnum
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu_torch import QActivationArgs, QConfig, QuantType, QWeightArgs, quantize
from onnx_quantize_tpu_torch.core.qconfig import SmoothQuantConfig
from onnx_quantize_tpu_torch.algorithms import rtn_quantize
from onnx_quantize_tpu_torch.core import numerics as tnum
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

torch.set_num_threads(1)

# (dtype, strategy, group_size, symmetric, reduce_range)
RTN_CASES = [
    ("uint4", "group", 128, False, False),  # the Gemma body
    ("int8", "channel", -1, True, False),  # the Gemma lm_head
    ("uint4", "group", 64, False, False),
    ("int4", "group", 64, True, False),
    ("uint8", "channel", -1, True, False),  # zp = 128, min(pos, neg) levels
    ("uint8", "tensor", -1, False, False),
    ("int8", "channel", -1, False, True),  # reduced range (-64, 64)
    ("uint4", "channel", -1, False, False),
]


def _weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    w[:, 0] = 0.0  # a degenerate (all-zero) channel: scale falls back to 1
    w[:3, 1] = [0.5, -0.5, 0.25]  # exact .5 ties under round-half-even
    return w


@pytest.mark.parametrize("dtype,strategy,gs,sym,reduce", RTN_CASES)
def test_rtn_codes_scales_zps_bit_equal(dtype, strategy, gs, sym, reduce):
    w = _weights(256, 96, seed=1)
    jq, js, jz = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, sym, reduce)
    tq, ts, tz = rtn_quantize(torch.from_numpy(w), QuantType(dtype),
                              QuantizationStrategy(strategy), gs, sym, reduce)
    assert tq.dtype == (torch.int8 if dtype.startswith("int") else torch.uint8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("dtype", [t.value for t in JQuantType])
@pytest.mark.parametrize("sym,reduce", [(False, False), (True, False), (False, True)])
def test_qrange_tables_equal(dtype, sym, reduce):
    assert QuantType(dtype).qrange(sym, reduce) == JQuantType(dtype).qrange(sym, reduce)
    assert QuantType(dtype).bitwidth == JQuantType(dtype).bitwidth
    assert QuantType(dtype).is_signed == JQuantType(dtype).is_signed


def test_compute_qparams_and_dequantize_match():
    rng = np.random.default_rng(2)
    rmin = np.minimum(rng.standard_normal(64).astype(np.float32), 0)
    rmax = np.maximum(rng.standard_normal(64).astype(np.float32), 0)
    rmin[0] = rmax[0] = 0.0
    for qt in ("uint8", "int8", "uint4", "int4"):
        for sym in (False, True):
            js, jz = jnum.compute_qparams(rmin, rmax, JQuantType(qt), sym, False)
            ts, tz = tnum.compute_qparams(torch.from_numpy(rmin), torch.from_numpy(rmax),
                                          QuantType(qt), sym, False)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    q = rng.integers(0, 16, size=(8, 64)).astype(np.uint8)
    s = rng.random(64).astype(np.float32)
    z = rng.integers(0, 16, size=64).astype(np.uint8)
    jd = jnum.dequantize(q, s, z, preprocess=True, strategy=JStrategy.CHANNEL)
    td = tnum.dequantize(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(z),
                         preprocess=True, strategy=QuantizationStrategy.CHANNEL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_tree_bit_equal_with_group_fallback():
    """Both of the main path's passes over a Gemma-3 tree; hidden 320 is not
    a multiple of 128, so the body's K=320 sites fall back to one group."""
    import jax

    kw = dict(hidden_size=320, intermediate_size=256, num_layers=2, num_heads=2,
              num_kv_heads=1, head_dim=64, vocab_size=384)
    jmodel, tmodel = JGemma3(JGemma3Config.tiny(**kw)), Gemma3(Gemma3Config.tiny(**kw))
    params = jmodel.init(jax.random.key(3))
    body = dict(weights=dict(dtype="uint4", group_size=128), ignore=["lm_head"])
    head = dict(weights=dict(dtype="int8", group_size=-1, symmetric=True),
                ignore=[r"^layers\."])
    jq = params
    tq = from_jax_params(params, device="cpu")
    for cfg in (body, head):
        jq, _ = oqt.quantize(jmodel, jq, oqt.QConfig(weights=oqt.QWeightArgs(**cfg["weights"]),
                                                     ignore=cfg["ignore"]))
        tq, _ = quantize(tmodel, tq, QConfig(weights=QWeightArgs(**cfg["weights"]),
                                            ignore=cfg["ignore"]))
    sites = [s.param_path for s in tmodel.linear_sites()]
    assert len(sites) == 2 * 7 + 1
    for path in sites:
        jw, tw = jq, tq
        for key in path:
            jw, tw = jw[key], tw[key]
        jw, tw = jw["w"], tw["w"]
        assert tw.meta.pack_group == jw.meta.pack_group
        assert tw.meta.group_size == jw.meta.group_size
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
        np.testing.assert_array_equal(tw.zero_point.numpy(), np.asarray(jw.zero_point))
    assert tq["layers.0"]["attn"]["q_proj"]["w"].meta.group_size == 320
    assert tq["layers.0"]["mlp"]["down_proj"]["w"].meta.group_size == 128


@pytest.mark.parametrize("kwargs", [
    # QuaRot's config forms (ported now): alone with static-capable inputs,
    # after another pre-pass, and with an online rotation.
    dict(weights=QWeightArgs(dtype="int8", group_size=-1),
         input_activations=QActivationArgs(dtype="uint8"),
         preprocessors=[{"preprocessing_type": "rotate"}]),
    dict(weights=QWeightArgs(dtype="uint4", group_size=128),
         preprocessors=[SmoothQuantConfig(), {"preprocessing_type": "rotate", "mode": "random"}]),
    dict(weights=QWeightArgs(dtype="uint4", group_size=128),
         preprocessors=[{"preprocessing_type": "rotate", "rotate_down": True}]),
])
def test_off_slice_config_raises_not_implemented(kwargs):
    """QuaRot is ported: each form resolves to the pre-pass configs the JAX
    package resolves, with the same fields, and each builds its pass."""
    qconfig = QConfig(**kwargs)
    jqconfig = oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
        preprocessors=[p if isinstance(p, dict) else oqt.SmoothQuantConfig()
                       for p in kwargs["preprocessors"]])
    ours, theirs = qconfig.preprocessors, jqconfig.preprocessors
    assert [type(p).__name__ for p in ours] == [type(p).__name__ for p in theirs]
    for mine, jax_cfg in zip(ours, theirs):
        fields = {f.name: getattr(mine, f.name) for f in dataclasses.fields(mine)}
        assert fields == {k: getattr(jax_cfg, k) for k in fields}
        assert (type(mine.build_pass(qconfig)).__name__
                == type(jax_cfg.build_pass(jqconfig)).__name__)


@pytest.mark.parametrize("kwargs", [dict(algorithm="gptq"), dict(algorithm="hqq"),
                                    dict(mse=True)])
def test_off_slice_weight_args_raise_not_implemented(kwargs):
    """GPTQ, HQQ and the MSE search are ported now: the weight args resolve as
    the JAX package's do (HQQ, which needs its strategy spelled out there,
    refuses an inferred one, as there)."""
    jkw = dict(kwargs)
    if "algorithm" in jkw:
        jkw["algorithm"] = {"gptq": oqt.GPTQConfig, "hqq": oqt.HqqConfig}[jkw["algorithm"]]()
    for strategy in (None, "group"):
        outcomes = []
        for cls, kw in ((QWeightArgs, kwargs), (oqt.QWeightArgs, jkw)):
            try:
                w = cls(dtype="uint4", group_size=128, strategy=strategy, **kw)
                outcomes.append((w.strategy.value, w.mse, type(w.algorithm).__name__.lower()))
            except ValueError:
                outcomes.append("ValueError")
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("gs,strategy", [(None, "tensor"), (-1, "channel"), (64, "group")])
def test_weight_args_infer_strategy_like_jax(gs, strategy):
    assert QWeightArgs(dtype="int8", group_size=gs).strategy.value == strategy
    assert oqt.QWeightArgs(dtype="int8", group_size=gs).strategy.value == strategy
    with pytest.raises(ValueError):
        QWeightArgs(dtype="int8", group_size=-2)
