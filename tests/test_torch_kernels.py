"""The W4/W8 kernels' plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) and its jnp oracle, in float32, and the dispatch
rules. The Hopper kernels themselves are tested in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.engine import prepare_kernel_scales as jax_prepare
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.matmul_w4 import w4_dequant_matmul as jax_w4
from onnx_quantize_tpu.ops.kernels.matmul_w8 import w8_dequant_matmul as jax_w8
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.nn.qtensor import QTensor, QTensorMeta
from onnx_quantize_tpu_torch.ops import quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8, pad_to_multiple
from onnx_quantize_tpu_torch.ops.reference import _qdq_matmul

torch.set_num_threads(1)

# Float32 inputs: the plain versions and the JAX kernels both fold the affine
# into per-group partial dots, the oracle dequantizes first; the sums differ
# only in rounding order, far inside 1e-5 of the output's largest magnitude.
REL_TOL = 1e-5


def _make(dtype, strategy, gs, sym, K, N, seed=0, bake=True):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, sym, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy(strategy),
                           group_size=gs, symmetric=sym, reduce_range=False)
    if bake:
        jqt = jax_prepare({"w": jqt})["w"]
    return jqt, from_jax_params({"w": jqt}, device="cpu")["w"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())


# (dtype, strategy, group_size, symmetric, K, N, x shape, also JAX kernel)
W4_CASES = [
    ("uint4", "group", 64, False, 320, 256, (5,), True),  # 5 groups + 1 pad group
    ("uint4", "group", 128, False, 640, 128, (2, 16), True),  # the Gemma body
    ("int4", "group", 64, True, 128, 256, (3,), True),
    ("uint4", "channel", -1, False, 130, 128, (4,), True),
    ("uint4", "group", 64, False, 320, 200, (7,), False),  # ragged N (JAX needs N % 128)
]
W8_CASES = [
    ("int8", "channel", -1, True, 640, 256, (2, 16), True),  # the Gemma lm_head
    ("uint8", "channel", -1, False, 96, 128, (5,), True),
    ("uint8", "group", 32, False, 96, 128, (5,), True),
    ("int8", "tensor", -1, False, 96, 128, (3,), True),
    # uint8 symmetric keeps zp = 128: the JAX kernel's symmetric path drops
    # the zero point there, so only the oracle is a reference.
    ("uint8", "channel", -1, True, 96, 128, (4,), False),
    ("int8", "channel", -1, True, 96, 200, (6,), False),  # ragged N
]


@pytest.mark.parametrize("dtype,strategy,gs,sym,K,N,xshape,with_kernel", W4_CASES)
def test_w4_plain_matches_jax_kernel_and_oracle(dtype, strategy, gs, sym, K, N, xshape,
                                                 with_kernel):
    jqt, tqt = _make(dtype, strategy, gs, sym, K, N)
    x = np.random.default_rng(1).standard_normal(xshape + (K,)).astype(np.float32)
    got = matmul_w4.w4_dequant_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == xshape + (N,)
    _close(got, quantized_matmul_jnp(jnp.asarray(x), jqt))
    if with_kernel:
        _close(got, jax_w4(jnp.asarray(x), jqt, interpret=True))


@pytest.mark.parametrize("dtype,strategy,gs,sym,K,N,xshape,with_kernel", W8_CASES)
def test_w8_plain_matches_jax_kernel_and_oracle(dtype, strategy, gs, sym, K, N, xshape,
                                                 with_kernel):
    jqt, tqt = _make(dtype, strategy, gs, sym, K, N)
    x = np.random.default_rng(2).standard_normal(xshape + (K,)).astype(np.float32)
    got = matmul_w8.w8_dequant_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == xshape + (N,)
    _close(got, quantized_matmul_jnp(jnp.asarray(x), jqt))
    if with_kernel:
        _close(got, jax_w8(jnp.asarray(x), jqt, interpret=True))


@pytest.mark.parametrize("case", [W4_CASES[0], W8_CASES[0], W8_CASES[1]])
def test_dispatch_on_cpu_runs_plain_versions_without_launches(case):
    dtype, strategy, gs, sym, K, N, xshape, _ = case
    jqt, tqt = _make(dtype, strategy, gs, sym, K, N, bake=False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(xshape + (K,)).astype(
        np.float32))
    counts = matmul_w4.launches, matmul_w8.launches
    bias = torch.linspace(-1, 1, N)
    got = quantized_matmul(x, tqt, bias).numpy()
    assert (matmul_w4.launches, matmul_w8.launches) == counts
    _close(got, _qdq_matmul(x, tqt, bias).numpy())
    _close(got, np.asarray(quantized_matmul_jnp(jnp.asarray(x.numpy()), jqt)) + bias.numpy())


def test_uncovered_config_raises_off_cpu():
    """A config no kernel covers (int32 weight codes: W8 takes 8-bit weights
    only): the CPU runs the plain QDQ reference, any other device raises."""
    from onnx_quantize_tpu_torch.ops.kernels import select_kernel

    meta = QTensorMeta(quant_type="int32", strategy="channel", group_size=-1, symmetric=True,
                       reduce_range=False, shape=(8, 4))
    qt = QTensor(torch.arange(-16, 16, dtype=torch.int32).reshape(8, 4), torch.full((4,), 0.01),
                 torch.zeros(4, dtype=torch.int32), meta)
    assert select_kernel(torch.ones((2, 8)), qt, None) is None
    x = torch.linspace(-1, 1, 16).reshape(2, 8)
    assert torch.equal(quantized_matmul(x, qt), _qdq_matmul(x, qt))
    meta_qt = qt.to("meta")
    with pytest.raises(NotImplementedError, match="No Hopper kernel"):
        quantized_matmul(torch.ones((2, 8), device="meta"), meta_qt)


def test_wrappers_reject_bad_operands():
    _, tqt = _make("uint4", "group", 64, False, 320, 128)
    s, z = matmul_w4.expand_w4_scales(tqt)
    x = torch.zeros((2, 384))
    with pytest.raises(TypeError):
        matmul_w4.w4_matmul(x.half(), tqt.data, s, z, gs=64, signed=False)
    with pytest.raises(ValueError):
        matmul_w4.w4_matmul(x[:, :320], tqt.data, s, z, gs=64, signed=False)
    with pytest.raises(ValueError):
        matmul_w4.w4_matmul(x, tqt.data, s[:2], z, gs=64, signed=False)
    with pytest.raises(ValueError):
        matmul_w4.w4_matmul(torch.zeros((384, 2)).T, tqt.data, s, z, gs=64, signed=False)
    _, hqt = _make("int8", "channel", -1, True, 96, 128)
    bk, rows, zps = matmul_w8.w8_scale_rows(hqt)
    assert (bk, zps) == (96, None)
    with pytest.raises(ValueError):
        matmul_w8.w8_matmul(torch.zeros((2, 95)), hqt.data, rows, None, bk=bk)
    with pytest.raises(ValueError):
        matmul_w8.w8_matmul(torch.zeros((2, 96)), hqt.data, rows, None, bk=64)


def test_pad_to_multiple():
    t = torch.arange(6.0).reshape(2, 3)
    assert pad_to_multiple(t, 1, 4).tolist() == [[0, 1, 2, 0], [3, 4, 5, 0]]
    assert pad_to_multiple(t, 0, 3).shape == (3, 3)
    assert pad_to_multiple(t, -1, 3) is t
