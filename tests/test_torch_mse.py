"""The MSE range search of the port against the JAX package's, on the same
numpy weights: the searched ranges, the qparams and RTN's codes with
``mse=True``, for each strategy.

Tolerances: the ranges, qparams and codes are exact (the chosen shrink
factor is the same float32 number times the same min/max); fake_quantize is
exact. The port sums the candidates' errors in float64 where JAX sums in
float32, which could only flip a choice between two candidates whose errors
tie to float32's last bits: the seeded weights have no such tie.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core import numerics as jnum
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu_torch.algorithms import rtn_quantize
from onnx_quantize_tpu_torch.core import numerics as tnum
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy

torch.set_num_threads(1)

# (dtype, strategy, group_size, symmetric, reduce_range)
MSE_CASES = [
    ("int8", "tensor", -1, False, False),
    ("int8", "channel", -1, True, False),
    ("uint8", "channel", -1, False, False),
    ("uint4", "group", 32, False, False),
    ("int4", "group", 16, True, False),
    ("uint4", "channel", -1, False, True),
]


def _weights(K, N, seed):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    w[:, 0] = 0.0  # a degenerate channel: every candidate's error is 0
    w[5, 1] = 2.0  # an outlier the search clips
    return w


@pytest.mark.parametrize("dtype,strategy,gs,sym,reduce", MSE_CASES)
def test_min_max_mse_matches_jax(dtype, strategy, gs, sym, reduce):
    w = _weights(128, 48, seed=3)
    jpre = np.asarray(jnum.preprocess_array(w, JStrategy(strategy), gs))
    tpre = tnum.preprocess_array(torch.from_numpy(w), QuantizationStrategy(strategy), gs)
    np.testing.assert_array_equal(tpre.numpy(), jpre)
    jmin, jmax = jnum.compute_min_max_mse(jpre, JQuantType(dtype), JStrategy(strategy), gs,
                                          sym, reduce)
    tmin, tmax = tnum.compute_min_max_mse(tpre, QuantType(dtype), QuantizationStrategy(strategy),
                                          gs, sym, reduce)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    if dtype.endswith("4"):  # at 4 bits the search moves some row's range
        pmin, pmax = tnum.compute_min_max(tpre, QuantizationStrategy(strategy), gs)
        assert not (torch.equal(pmin, tmin) and torch.equal(pmax, tmax))
    js, jz = jnum.compute_qparams_from_array(jpre, JQuantType(dtype), JStrategy(strategy), gs,
                                             sym, reduce, clip_ratio=0.9, mse=True)
    ts, tz = tnum.compute_qparams_from_array(tpre, QuantType(dtype),
                                             QuantizationStrategy(strategy), gs, sym, reduce,
                                             clip_ratio=0.9, mse=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("dtype,strategy,gs,sym,reduce", MSE_CASES)
def test_rtn_with_mse_bit_equal(dtype, strategy, gs, sym, reduce):
    w = _weights(96, 40, seed=4)
    jq, js, jz = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, sym, reduce, mse=True)
    tq, ts, tz = rtn_quantize(torch.from_numpy(w), QuantType(dtype),
                              QuantizationStrategy(strategy), gs, sym, reduce, mse=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_fake_quantize_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    s = (0.05 + rng.random((16, 1))).astype(np.float32)
    z = rng.integers(0, 256, (16, 1)).astype(np.float32)
    want = jnum.fake_quantize(x, s, z, JQuantType.QUInt8, False, False)
    got = tnum.fake_quantize(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(z),
                             QuantType.QUInt8, False, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mse_search_patience_counts_cumulatively():
    """The early stop masks every update once ``patience`` candidates have
    improved no row, counted over the whole search, as the reference's host
    loop counts them (a later improvement does not reset the count)."""
    w = _weights(64, 8, seed=6)
    pre = torch.from_numpy(w.T.copy())
    for patience in (1, 2, 5):
        jmin, jmax = jnum.compute_min_max_mse(pre.numpy(), JQuantType.QInt4,
                                              JStrategy.CHANNEL, -1, True, False,
                                              patience=patience)
        tmin, tmax = tnum.compute_min_max_mse(pre, QuantType.QInt4, QuantizationStrategy.CHANNEL,
                                              -1, True, False, patience=patience)
        np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
        np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))


def test_true_div_is_one_division():
    """``true_div`` rounds once, as numpy's float32 division does."""
    a = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    for b in (15, 255, 127, 7):
        np.testing.assert_array_equal(tnum.true_div(torch.from_numpy(a), b).numpy(),
                                      a / np.float32(b))


@pytest.mark.parametrize("k,N", [(8, 6), (32, 64), (128, 256)])
def test_port_search_matches_jax_jit_gptq_search(k, N):
    """The JAX package's jit GPTQ sweep searches with its own copy, which
    resets the patience count on an improvement (ROADMAP.md, Queue C); the
    port keeps the cumulative count. On seeded slices of outlier-heavy
    columns both give the same ranges."""
    import jax.numpy as jnp

    from onnx_quantize_tpu.algorithms.gptq import _mse_min_max_cols

    rng = np.random.default_rng(k + N)
    for trial in range(10):
        w = (rng.standard_normal((k, N)) * rng.uniform(0.2, 3, (1, N))).astype(np.float32)
        w[rng.integers(0, k), :] *= rng.uniform(2, 8)
        for qt in ("int4", "uint8"):
            jmin, jmax = _mse_min_max_cols(jnp.asarray(w), JQuantType(qt), False, False)
            tmin, tmax = tnum.compute_min_max_mse(torch.from_numpy(w.T.copy()), QuantType(qt),
                                                  QuantizationStrategy.CHANNEL, -1, False, False)
            np.testing.assert_array_equal(tmin.numpy().ravel(), np.asarray(jmin))
            np.testing.assert_array_equal(tmax.numpy().ravel(), np.asarray(jmax))
