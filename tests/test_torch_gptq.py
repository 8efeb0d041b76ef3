"""GPTQ in the port against the JAX package, on the same numpy inputs.

Two layers, since GPTQ's error feedback compounds (one code flipped at a
rounding tie changes every later column):

* with JAX's own Hessian inverse fed in, the port's sweep gives JAX's host
  sweep (``_gptq_sweep_host``) exactly: the same codes and zero points, the
  group scales within 1e-6 relative (the block's tail update is a float32
  matmul, summed in another order);
* end to end, with its own Hessian and Cholesky factors, at most 0.5% of the
  codes differ from the JAX package's (jit) result, and the reconstruction
  error ``||X W - X dq(W)||`` stays within 1% of JAX's.
"""

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms import gptq as jgptq
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.core.numerics import dequantize as jax_dequantize
from onnx_quantize_tpu_torch.algorithms import gptq as tgptq
from onnx_quantize_tpu_torch.algorithms import rtn_quantize
from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy

torch.set_num_threads(1)

CODE_SHARE = 0.005  # differing codes allowed end to end
RECON_RTOL = 0.01  # reconstruction error against JAX's


def _problem(K, N, S=256, seed=0):
    """Correlated inputs (rank 8 plus noise) and a weight, with one dead
    input channel."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((S, 8)).astype(np.float32)
    mix = rng.standard_normal((8, K)).astype(np.float32)
    x = base @ mix + 0.1 * rng.standard_normal((S, K)).astype(np.float32)
    x[:, 3] = 0.0
    w = rng.standard_normal((K, N)).astype(np.float32)
    return w, x


def test_accumulate_hessian_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 4, 8)).astype(np.float32)
    jh, jn = jgptq.accumulate_hessian(x[:6], np.zeros((8, 8), np.float32), 0)
    jh, jn = jgptq.accumulate_hessian(x[6:], jh, jn)
    th, tn = tgptq.accumulate_hessian(torch.from_numpy(x[:6]), torch.zeros((8, 8)), 0)
    th, tn = tgptq.accumulate_hessian(torch.from_numpy(x[6:]), th, tn)
    assert tn == jn == 16
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-5, atol=1e-6)


def _jax_presweep(w, x, strategy, gs, actorder, mse, qt=JQuantType.QInt8, percdamp=0.01):
    """The JAX package's steps before the sweep: Hessian, initial qparams,
    dead channels, the (group-aligned) permutation, the Cholesky factor."""
    W = w.copy()
    K, _ = W.shape
    H, _ = jgptq.accumulate_hessian(x, np.zeros((K, K), np.float32), 0)
    use_group = strategy == "group"
    if strategy == "tensor":
        from onnx_quantize_tpu.core.numerics import compute_qparams_from_array

        s, z = compute_qparams_from_array(W.T, qt, JStrategy.TENSOR, -1, False, False, mse=mse,
                                          zp_dtype=np.float32)
        scale, zp = np.float32(np.asarray(s)), np.float32(np.asarray(z))
    else:
        scale, zp = jgptq._channelwise_qparams(W.T, qt, False, False, 1.0, mse, np.float32, None)
    dead = np.diag(H) == 0
    H[dead, dead] = 1.0
    W[dead, :] = 0.0
    if actorder:
        perm, _ = tgptq._group_aligned_perm(np.diag(H).copy(), K, gs, use_group)
        W = W[perm, :]
        H = H[perm, :][:, perm]
    Hinv = jgptq._cholesky_inverse_sweep(H, percdamp)
    return W, Hinv, scale, zp


# (strategy, K, group size): per channel, groups aligned with the K, a
# ragged last group; per tensor.
SWEEP_CASES = [("channel", 40, -1), ("group", 48, 8), ("group", 44, 8), ("tensor", 40, -1)]


@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("strategy,K,gs", SWEEP_CASES)
def test_sweep_bit_equal_to_jax_host_sweep(strategy, K, gs, actorder, mse):
    w, x = _problem(K, 12, seed=K)
    W, Hinv, scale, zp = _jax_presweep(w, x, strategy, gs, actorder, mse)
    qmin, qmax = JQuantType.QInt8.qrange(False, False)
    use_group = strategy == "group"
    common = dict(qmin=qmin, qmax=qmax, block_size=16, group_size=gs, use_group=use_group,
                  sym=False, rr=False, clip_ratio=1.0, mse=mse)
    _, jq, js, jz = jgptq._gptq_sweep_host(W, Hinv, scale, zp, quant_type=JQuantType.QInt8,
                                           scale_dtype=np.float32, zp_dtype=None, **common)
    tq, ts, tz = tgptq._gptq_sweep(torch.from_numpy(W.copy()), torch.from_numpy(Hinv.copy()),
                                   torch.tensor(np.asarray(scale)), torch.tensor(np.asarray(zp)),
                                   quant_type=QuantType.QInt8, **common)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
    np.testing.assert_array_equal(tz.numpy(), jz)
    assert len(np.unique(jq)) > 8  # a real spread of codes


def _recon_err(x, w, q, s, z, strategy, gs, dequant):
    dq = np.asarray(dequant(q, s, z, preprocess=True, strategy=strategy, group_size=gs))
    return float(np.linalg.norm(x @ w - x @ dq))


@pytest.mark.parametrize("dtype", ["uint4", "int8"])
@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("strategy,gs", [("channel", -1), ("group", 32), ("group", 24)])
def test_gptq_quantize_end_to_end_close_to_jax(strategy, gs, actorder, dtype):
    K, N = 96, 32
    w, x = _problem(K, N, S=384, seed=7)
    jq, js, jz = jgptq.gptq_quantize(w, x, JQuantType(dtype), JStrategy(strategy), gs,
                                     block_size=32, actorder=actorder)
    tq, ts, tz = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(x), QuantType(dtype),
                                     QuantizationStrategy(strategy), gs, block_size=32,
                                     actorder=actorder)
    assert tq.dtype == (torch.uint8 if dtype.startswith("u") else torch.int8)
    assert tq.shape == w.shape and ts.shape == js.shape and tz.shape == jz.shape
    assert float(np.mean(tq.numpy() != np.asarray(jq))) <= CODE_SHARE
    jerr = _recon_err(x, w, jq, js, jz, JStrategy(strategy), gs, jax_dequantize)
    from onnx_quantize_tpu_torch.core.numerics import dequantize

    terr = _recon_err(torch.from_numpy(x).numpy(), w, tq, ts, tz, QuantizationStrategy(strategy),
                      gs, lambda *a, **k: dequantize(*a, **k).numpy())
    assert abs(terr - jerr) <= RECON_RTOL * jerr
    # GPTQ beats RTN on the correlated inputs.
    rq, rs, rz = rtn_quantize(torch.from_numpy(w), QuantType(dtype),
                              QuantizationStrategy(strategy), gs, False, False)
    rerr = _recon_err(x, w, rq, rs, rz, QuantizationStrategy(strategy), gs,
                      lambda *a, **k: dequantize(*a, **k).numpy())
    assert terr < rerr


def test_degenerate_hessian_falls_back_to_rtn():
    """A failed factorisation (here an indefinite damped Hessian) gives an
    identity Hinv: the sweep is RTN, in both packages."""
    w, x = _problem(32, 8, seed=3)
    H, _ = jgptq.accumulate_hessian(x, np.zeros((32, 32), np.float32), 0)
    assert jgptq._cholesky_inverse_sweep(H, -2.0) is None
    assert tgptq._cholesky_inverse_sweep(torch.from_numpy(H), -2.0) is None
    assert tgptq._cholesky_inverse_sweep(torch.from_numpy(H), 0.01) is not None
    jq, _, _ = jgptq.gptq_quantize(w, x, JQuantType.QInt8, JStrategy.CHANNEL, -1, percdamp=-2.0)
    tq, ts, tz = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(x), QuantType.QInt8,
                                     QuantizationStrategy.CHANNEL, -1, percdamp=-2.0)
    # RTN with the full weight's qparams; the dead channel's row is zero, so
    # it takes the zero point.
    rq, rs, rz = jax_rtn(w, JQuantType.QInt8, JStrategy.CHANNEL, -1, False, False)
    want = np.asarray(rq).copy()
    want[3] = np.asarray(rz)
    np.testing.assert_array_equal(tq.numpy(), want)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(rz))
