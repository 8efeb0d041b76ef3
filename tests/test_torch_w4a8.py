"""The W4A8 slice on the CPU against the JAX package: the int8 activation
quantizer (bit-equal), the W4A8 kernel's plain version against the Pallas
kernel in interpret mode and the jnp oracle, the activation-QDQ oracle,
``convert_to_w4a8``'s eligibility and the kernel each config selects. The
Hopper kernels themselves are tested in test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops import convert_to_w4a8 as jax_convert
from onnx_quantize_tpu.ops import reference as jref
from onnx_quantize_tpu.ops.kernels.matmul_w4a8 import quantize_activation_int8 as jax_quantize
from onnx_quantize_tpu.ops.kernels.matmul_w4a8 import w4a8_matmul as jax_w4a8
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec
from onnx_quantize_tpu_torch.ops import convert_to_w4a8, quantized_matmul
from onnx_quantize_tpu_torch.ops import reference as tref
from onnx_quantize_tpu_torch.ops.kernels import (
    matmul_w4,
    matmul_w4a8,
    matmul_w8,
    matmul_w8a8,
    select_kernel,
)

torch.set_num_threads(1)

DYN_INT8 = dict(mode="dynamic", dtype="int8", symmetric=True)
# The plain version and the Pallas kernel form the same exact int32 partials
# and differ only in the float32 order of the group sums: 1e-5 of max|y|.
REL_TOL = 1e-5


def _jax_qt(dtype, strategy, gs, sym, K, N, seed=0, input_quant=None, zp_float=False):
    w = (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, sym, False)
    if zp_float:  # an HQQ-style float zero point
        z = np.asarray(z, np.float32) + 0.25
    kw = {} if input_quant is None else dict(input_quant=JActQuantSpec(**input_quant))
    return jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy(strategy),
                            group_size=gs, symmetric=sym, reduce_range=False, **kw)


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,scale", [((6, 64), 1.0), ((2, 16, 320), 37.5), ((3, 7), 1e-3),
                                         ((4, 8), 0.0)])
def test_activation_quantizer_is_bit_equal_to_jax(dtype, shape, scale):
    x = (scale * _x(shape, seed=len(shape))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jax_quantize(jx)
    tq, ts = matmul_w4a8.quantize_activation_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)  # the float32 scale, bit for bit
    if scale == 0.0:
        assert ts.item() == 1.0


# JAX's own W4A8 cases (tests/ops/test_w4a8.py), plus the Gemma body's g128
# with a pad group and a ragged N.
W4A8_CASES = [(dt, K, gs, 128, True) for dt in ("uint4", "int4")
              for K, gs in ((64, 16), (96, 32))]
W4A8_CASES += [("uint4", 640, 128, 128, True), ("uint4", 320, 64, 200, False)]


@pytest.mark.parametrize("dtype,K,gs,N,with_kernel", W4A8_CASES)
def test_w4a8_plain_matches_jax_kernel_and_oracle(dtype, K, gs, N, with_kernel):
    jqt = _jax_qt(dtype, "group", gs, False, K, N, input_quant=DYN_INT8)
    tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
    x = _x((6, K))
    got = matmul_w4a8.w4a8_dequant_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == (6, N)
    # JAX's own bar against its oracle (tests/ops/test_w4a8.py).
    np.testing.assert_allclose(got, np.asarray(jref.quantized_matmul_jnp(x, jqt)),
                               rtol=2e-4, atol=2e-4)
    if with_kernel:
        _close(got, jax_w4a8(x, jqt, interpret=True))
    # The baked kernel scales give the same result.
    baked = prepare_kernel_scales({"w": tqt})["w"]
    np.testing.assert_array_equal(
        matmul_w4a8.w4a8_dequant_matmul(torch.from_numpy(x), baked).numpy(), got)


# Activation specs of the QDQ oracle: dynamic (the reference's
# DynamicQuantizeLinear and the A8 spec) and static, symmetric or not,
# reduced range or not.
SPECS = [
    dict(mode="dynamic", dtype="uint8"),
    dict(mode="dynamic", dtype="uint8", symmetric=True),
    dict(mode="dynamic", dtype="int8", symmetric=True),
    dict(mode="dynamic", dtype="int8", symmetric=True, reduce_range=True),
    dict(mode="static", dtype="uint8"),
    dict(mode="static", dtype="int8", symmetric=True),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_activation_qdq_oracle_matches_jax(spec):
    """Fake quantization of x (prologue) and of y (epilogue, after the bias)
    equals the JAX oracle's; the full site within 1e-5 of max|y|."""
    jspec, tspec = JActQuantSpec(**spec), ActQuantSpec(**spec)
    x = _x((5, 96), seed=3)
    y = 3.0 * _x((5, 128), seed=4)
    statics = {}
    if spec["mode"] == "static":
        zp = 0.0 if spec.get("symmetric") else 117.0
        statics = dict(scale=np.float32(0.021), zp=np.float32(zp))
        want = jref.static_fake_quant(x, statics["scale"], statics["zp"], jspec)
        got = tref.static_fake_quant(torch.from_numpy(x), torch.tensor(statics["scale"]),
                                     torch.tensor(statics["zp"]), tspec)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        js, jz = jref.dynamic_quantize_params(jnp.asarray(x), jspec)
        ts, tz = tref.dynamic_quantize_params(torch.from_numpy(x), tspec)
        assert ts.item() == float(js) and tz.item() == float(jz)
    jqt = _jax_qt("int8", "channel", -1, True, 96, 128)
    jqt = dataclasses.replace(
        jqt, meta=dataclasses.replace(jqt.meta, input_quant=jspec, output_quant=jspec),
        **({} if not statics else dict(
            input_scale=jnp.asarray(statics["scale"]), input_zero_point=jnp.asarray(
                statics["zp"]), output_scale=jnp.asarray(statics["scale"] * 8),
            output_zero_point=jnp.asarray(statics["zp"]))))
    tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
    assert tqt.meta.input_quant == tqt.meta.output_quant == tspec
    np.testing.assert_array_equal(tref.qdq_prologue(torch.from_numpy(x), tqt).numpy(),
                                  np.asarray(jref.qdq_prologue(jnp.asarray(x), jqt)))
    bias = np.linspace(-1, 1, 128).astype(np.float32)
    np.testing.assert_array_equal(
        tref.qdq_epilogue(torch.from_numpy(y), tqt, torch.from_numpy(bias)).numpy(),
        np.asarray(jref.qdq_epilogue(jnp.asarray(y), jqt, jnp.asarray(bias))))
    # The whole site: the oracle and the dispatch (W8A8 or W8 behind the
    # prologue) both hold to JAX's oracle.
    want = jref.quantized_matmul_jnp(x, jqt, bias)
    _close(tref._qdq_matmul(torch.from_numpy(x), tqt, torch.from_numpy(bias)).numpy(), want)
    _close(quantized_matmul(torch.from_numpy(x), tqt, torch.from_numpy(bias)).numpy(), want)


def _port_qt(dtype, strategy, gs, sym, K=96, N=128, input_quant=None, zp_float=False,
             reduce_range_spec=False, bake=False):
    spec = None if input_quant is None else dict(input_quant, reduce_range=reduce_range_spec)
    qt = from_jax_params({"w": _jax_qt(dtype, strategy, gs, sym, K, N, input_quant=spec,
                                       zp_float=zp_float)}, device="cpu")["w"]
    return prepare_kernel_scales({"w": qt})["w"] if bake else qt


DYN_UINT8 = dict(mode="dynamic", dtype="uint8")
# (description, QTensor arguments, the kernel module that must take the site)
SELECT_CASES = [
    ("w4a8", dict(dtype="uint4", strategy="group", gs=32, sym=False, input_quant=DYN_INT8),
     matmul_w4a8),
    ("w4a8-baked", dict(dtype="uint4", strategy="group", gs=32, sym=False,
                        input_quant=DYN_INT8, bake=True), matmul_w4a8),
    ("w4a8-int4-channel", dict(dtype="int4", strategy="channel", gs=-1, sym=True,
                               input_quant=DYN_INT8), matmul_w4a8),
    ("w8a8-int8", dict(dtype="int8", strategy="channel", gs=-1, sym=True, input_quant=DYN_INT8),
     matmul_w8a8),
    ("w8a8-uint8-sym", dict(dtype="uint8", strategy="channel", gs=-1, sym=True,
                            input_quant=DYN_INT8), matmul_w8a8),
    ("w8a8-group", dict(dtype="int8", strategy="group", gs=32, sym=True, input_quant=DYN_INT8),
     matmul_w8a8),
    ("w4-weight-only", dict(dtype="uint4", strategy="group", gs=32, sym=False), matmul_w4),
    # As in the JAX package, a float (HQQ) zero point never takes W4A8: the
    # site runs W4 behind the activation QDQ, baked scales or not.
    ("w4-hqq-float-zp", dict(dtype="uint4", strategy="group", gs=32, sym=False,
                             input_quant=DYN_INT8, zp_float=True), matmul_w4),
    ("w4-a8-reduce-range", dict(dtype="uint4", strategy="group", gs=32, sym=False,
                                input_quant=DYN_INT8, reduce_range_spec=True), matmul_w4),
    ("w8-weight-only", dict(dtype="int8", strategy="channel", gs=-1, sym=True), matmul_w8),
    ("w8-asym-a8", dict(dtype="int8", strategy="channel", gs=-1, sym=False,
                        input_quant=DYN_INT8), matmul_w8),
    ("w8-dynamic-uint8", dict(dtype="int8", strategy="channel", gs=-1, sym=False,
                              input_quant=DYN_UINT8), matmul_w8),
]


@pytest.mark.parametrize("name,kwargs,module", SELECT_CASES, ids=[c[0] for c in SELECT_CASES])
def test_select_kernel_picks_each_config(name, kwargs, module):
    """The A8 kernels register before the weight-only ones: every A8 site they
    cover goes to them, everything else to W4 or W8 (behind the QDQ prologue),
    and every route computes the JAX oracle's result."""
    qt = _port_qt(**kwargs)
    x = torch.from_numpy(_x((4, 96), seed=5))
    entry = select_kernel(x, qt, None)
    assert entry is not None and entry.__module__ == module.__name__
    counts = [m.launches for m in (matmul_w4a8, matmul_w8a8, matmul_w4, matmul_w8)]
    got = quantized_matmul(x, qt).numpy()
    assert [m.launches for m in (matmul_w4a8, matmul_w8a8, matmul_w4, matmul_w8)] == counts
    _close(got, tref._qdq_matmul(x, qt).numpy())


# (QTensor arguments): packed with integer or float zero points, 8-bit
# symmetric and asymmetric, and a site whose input quantization is set.
CONVERT_CASES = [
    dict(dtype="uint4", strategy="group", gs=32, sym=False),
    dict(dtype="int4", strategy="group", gs=32, sym=True),
    dict(dtype="uint4", strategy="group", gs=32, sym=False, zp_float=True),
    dict(dtype="int8", strategy="channel", gs=-1, sym=True),
    dict(dtype="uint8", strategy="channel", gs=-1, sym=True),
    dict(dtype="int8", strategy="channel", gs=-1, sym=False),
    dict(dtype="uint8", strategy="group", gs=32, sym=False),
    dict(dtype="int8", strategy="channel", gs=-1, sym=True, input_quant=DYN_UINT8),
]


@pytest.mark.parametrize("kwargs", CONVERT_CASES, ids=lambda k: "-".join(map(str, k.values())))
def test_convert_to_w4a8_matches_jax_eligibility(kwargs):
    jqt = _jax_qt(K=96, N=128, **kwargs)
    want = jax_convert({"s": {"w": jqt}})["s"]["w"]
    got = convert_to_w4a8(from_jax_params({"s": {"w": jqt}}, device="cpu"))["s"]["w"]
    assert got.meta == from_jax_params({"w": want}, device="cpu")["w"].meta
    expected = not kwargs.get("zp_float") and "input_quant" not in kwargs and (
        kwargs["dtype"].endswith("4") or kwargs["sym"])
    assert (got.meta.input_quant == ActQuantSpec(**DYN_INT8)) == expected
