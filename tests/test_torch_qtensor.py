"""The PyTorch port's QTensor packing and scale layouts against the JAX package:
packed bytes, logical scales and the baked (G_pad/2, 2, N) kernel scales are
equal, and fusion concatenates alike."""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.engine import prepare_kernel_scales as jax_prepare
from onnx_quantize_tpu.nn.fuse import fuse_sites as jax_fuse_sites
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.nn.qtensor import pack_layout as jax_pack_layout
from onnx_quantize_tpu.ops.reference import dequantize_weight as jax_dequantize_weight
from onnx_quantize_tpu_torch.core import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.nn.fuse import can_fuse, fuse_sites
from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor, pack_layout, unpack_k_pairs
from onnx_quantize_tpu_torch.ops.reference import dequantize_weight, weight_qparams_2d

torch.set_num_threads(1)

# (dtype, strategy, group_size, symmetric, K, N): K=320 with gs=64 has an odd
# group count, so the packed layout carries one zero pad group.
CASES = [
    ("uint4", "group", 64, False, 320, 48),
    ("uint4", "group", 128, False, 640, 40),
    ("int4", "group", 64, True, 320, 24),
    ("uint4", "channel", -1, False, 130, 16),
    ("int4", "tensor", -1, True, 97, 8),
    ("int8", "channel", -1, True, 96, 32),
    ("uint8", "group", 32, False, 96, 32),
]


def _both(dtype, strategy, gs, sym, K, N, seed=0):
    w = (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32)
    jargs = dict(quant_type=JQuantType(dtype), strategy=JStrategy(strategy), group_size=gs,
                 symmetric=sym, reduce_range=False)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, sym, False)
    jqt = jax_make_qtensor(q, s, z, **jargs)
    tqt = make_qtensor(torch.tensor(q), torch.tensor(s), torch.tensor(z),
                       quant_type=QuantType(dtype),
                       strategy=QuantizationStrategy(strategy), group_size=gs, symmetric=sym,
                       reduce_range=False)
    return jqt, tqt


@pytest.mark.parametrize("dtype,strategy,gs,sym,K,N", CASES)
def test_packed_bytes_and_scales_equal(dtype, strategy, gs, sym, K, N):
    jqt, tqt = _both(dtype, strategy, gs, sym, K, N)
    assert tqt.meta.packed == jqt.meta.packed
    assert tqt.meta.pack_group == jqt.meta.pack_group
    assert tqt.meta.shape == tuple(jqt.meta.shape)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(tqt.zero_point.numpy(), np.asarray(jqt.zero_point))


@pytest.mark.parametrize("dtype,strategy,gs,sym,K,N", CASES)
def test_baked_kernel_scales_equal(dtype, strategy, gs, sym, K, N):
    jqt, tqt = _both(dtype, strategy, gs, sym, K, N)
    jbaked = jax_prepare({"w": jqt})["w"]
    tbaked = prepare_kernel_scales({"w": tqt})["w"]
    np.testing.assert_array_equal(tbaked.scale.numpy(), np.asarray(jbaked.scale))
    np.testing.assert_array_equal(tbaked.zero_point.numpy(), np.asarray(jbaked.zero_point))
    if tqt.meta.packed and strategy == "group":
        G_pad = 2 * tqt.data.shape[0] // tqt.meta.pack_group
        assert tuple(tbaked.scale.shape) == (G_pad // 2, 2, N)
    # Either layout dequantizes to the same weight, equal to the JAX oracle's.
    want = np.asarray(jax_dequantize_weight(jqt))
    np.testing.assert_array_equal(dequantize_weight(tqt).numpy(), want)
    np.testing.assert_array_equal(dequantize_weight(tbaked).numpy(), want)
    s, _ = weight_qparams_2d(tbaked)
    assert tuple(s.shape) == tuple(np.asarray(jqt.scale).shape)


@pytest.mark.parametrize("K,strategy,gs", [(320, "group", 64), (640, "group", 128),
                                           (130, "channel", -1), (97, "tensor", -1)])
def test_pack_layout_and_unpack_roundtrip(K, strategy, gs):
    assert pack_layout(K, QuantizationStrategy(strategy), gs) == jax_pack_layout(
        K, JStrategy(strategy), gs)
    for dtype, lo, hi in (("uint4", 0, 16), ("int4", -8, 8)):
        q = np.random.default_rng(K).integers(lo, hi, size=(K, 6))
        q = q.astype(np.int8 if lo < 0 else np.uint8)
        n_scales = 6 * (K // gs) if strategy == "group" else 1
        qt = make_qtensor(torch.from_numpy(q), torch.ones(n_scales), torch.zeros(n_scales),
                          quant_type=QuantType(dtype), strategy=QuantizationStrategy(strategy),
                          group_size=gs, symmetric=False, reduce_range=False)
        back = unpack_k_pairs(qt.data, K, signed=lo < 0, pack_group=qt.meta.pack_group)
        np.testing.assert_array_equal(back.numpy(), q)


def test_fused_sites_equal_jax_fusion():
    sites = [_both("uint4", "group", 64, False, 320, n, seed=n) for n in (128, 64, 64)]
    jfused, jsizes = jax_fuse_sites([{"w": j} for j, _ in sites])
    tparams = [{"w": t} for _, t in sites]
    assert can_fuse(tparams)
    tfused, tsizes = fuse_sites(tparams)
    assert tsizes == jsizes == [128, 64, 64]
    assert tfused.meta.shape == tuple(jfused.meta.shape)
    for attr in ("data", "scale", "zero_point"):
        np.testing.assert_array_equal(getattr(tfused, attr).numpy(),
                                      np.asarray(getattr(jfused, attr)))
    assert not can_fuse([{"w": sites[0][1]}, {"w": sites[1][1], "b": torch.zeros(64)}])
    mixed = _both("int4", "group", 64, True, 320, 64)[1]
    assert not can_fuse([{"w": sites[0][1]}, {"w": mixed}])


def test_bridge_carries_qtensors_and_bf16():
    import jax.numpy as jnp

    jqt, _ = _both("uint4", "group", 64, False, 320, 48)
    tree = {"a": {"w": jqt}, "b": {"w": jnp.asarray(np.arange(6, dtype=np.float32)).astype(
        jnp.bfloat16)}}
    out = from_jax_params(tree, device="cpu")
    assert out["a"]["w"].meta.pack_group == 64
    np.testing.assert_array_equal(out["a"]["w"].data.numpy(), np.asarray(jqt.data))
    assert out["b"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["b"]["w"].float().numpy(), np.arange(6))


def test_bridge_carries_activation_specs_and_static_qparams():
    """An A8 tree crosses with its metadata equal field by field, a static
    site with its activation qparams, and QTensor.to moves them all."""
    import dataclasses

    import jax.numpy as jnp
    from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
    from onnx_quantize_tpu.nn.qtensor import QBias as JQBias
    from onnx_quantize_tpu.ops import convert_to_w4a8 as jax_convert

    jqt, _ = _both("uint4", "group", 64, False, 320, 48)
    j8, _ = _both("int8", "channel", -1, True, 96, 32)
    a8 = jax_convert({"a": {"w": jqt}, "h": {"w": j8}})
    static = JActQuantSpec(mode="static", dtype="uint8")
    jst = dataclasses.replace(
        j8, meta=dataclasses.replace(j8.meta, input_quant=static, output_quant=static),
        input_scale=jnp.float32(0.02), input_zero_point=jnp.float32(128.0),
        output_scale=jnp.float32(0.5), output_zero_point=jnp.float32(3.0))
    out = from_jax_params({**a8, "s": {"w": jst}}, device="cpu")
    for key in ("a", "h", "s"):
        jmeta = (a8.get(key) or {"w": jst})["w"].meta
        tmeta = out[key]["w"].meta
        for field in dataclasses.fields(jmeta):
            want = getattr(jmeta, field.name)
            got = getattr(tmeta, field.name)
            if field.name in ("input_quant", "output_quant"):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == (tuple(want) if field.name == "shape" else want)
    assert out["a"]["w"].meta.input_quant.mode == "dynamic"
    assert out["a"]["w"].input_scale is None
    moved = out["s"]["w"].to("meta")
    assert moved.input_scale.device.type == moved.output_zero_point.device.type == "meta"
    assert out["s"]["w"].input_scale.item() == np.float32(0.02)
    assert out["s"]["w"].output_zero_point.item() == 3.0
    qbias = JQBias(data=jnp.zeros(4, jnp.int32), scale=jnp.float32(1), zero_point=jnp.int32(0),
                   quant_type="int32")
    with pytest.raises(NotImplementedError, match="QBias"):
        from_jax_params({"b": qbias}, device="cpu")


def test_fusion_keeps_activation_specs():
    """Fusing A8 sites keeps the spec (as the reference's fusion does); sites
    with different specs do not fuse."""
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8

    sites = [_both("uint4", "group", 64, False, 320, n, seed=n)[1] for n in (64, 32)]
    a8 = [convert_to_w4a8({"w": t})["w"] for t in sites]
    assert can_fuse([{"w": w} for w in a8])
    fused, sizes = fuse_sites([{"w": w} for w in a8])
    assert sizes == [64, 32] and fused.meta.input_quant == a8[0].meta.input_quant
    assert not can_fuse([{"w": a8[0]}, {"w": sites[1]}])
