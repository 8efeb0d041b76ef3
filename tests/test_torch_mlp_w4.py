"""The fused W4 MLP on the CPU against the JAX package: its plain version and
oracle against JAX's ``mlp_w4_reference`` and ``mlp_w4_fused`` (interpret
mode) on the cases of ``tests/ops/test_mlp_w4.py``, the eligibility
predicate, the model hook, and engine decode with ``mlp_megakernel=True``
giving JAX's tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jax_rtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jax_fuse
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu.ops.kernels.mlp_w4 import mlp_w4_eligible as jax_eligible
from onnx_quantize_tpu.ops.kernels.mlp_w4 import mlp_w4_fused as jax_fused
from onnx_quantize_tpu.ops.kernels.mlp_w4 import mlp_w4_reference as jax_reference
from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.ops.kernels import mlp_w4

torch.set_num_threads(1)

# JAX's own bar for its fused kernel against its oracle (rtol 2e-4, atol
# 2e-5): float32 sums in another order, the dequant affine on the partial
# dots in the fused form and on the weights in the oracle.
RTOL, ATOL = 2e-4, 2e-5


def _pair(rng, K=128, inter=256, gs=64, dtype=JQuantType.QUInt4, strategy=JStrategy.GROUP):
    """A (gate_up, down) pair of packed-W4 QTensors in JAX, as its tests build them."""
    def qt(w):
        q, s, z = jax_rtn(w, dtype, strategy, gs, dtype.is_signed, False)
        return jax_make_qtensor(q, s, z, quant_type=dtype, strategy=strategy, group_size=gs,
                                symmetric=dtype.is_signed, reduce_range=False)

    wg = (0.1 * rng.standard_normal((K, 2 * inter))).astype(np.float32)
    wd = (0.1 * rng.standard_normal((inter, K))).astype(np.float32)
    return qt(wg), qt(wd)


# (K, inter, gs, dtype, M): JAX's fused-vs-oracle cases, its ragged gate-up
# group padding (K = 192: 3 groups padded to 4) and ragged down K (inter =
# 192), and channel scales (one virtual group pair).
MLP_CASES = ([(128, 256, 64, dt, M) for dt in (JQuantType.QUInt4, JQuantType.QInt4)
              for M in (1, 8, 32)]
             + [(192, 256, 64, JQuantType.QUInt4, 4), (128, 192, 64, JQuantType.QUInt4, 4)])


@pytest.mark.parametrize("K,inter,gs,dtype,M", MLP_CASES,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_plain_matches_jax_fused_and_oracle(rng, K, inter, gs, dtype, M):
    jgu, jdn = _pair(rng, K, inter, gs, dtype)
    x = rng.standard_normal((M, K)).astype(np.float32)
    want_fused = np.asarray(jax_fused(jnp.asarray(x), jgu, jdn, interpret=True))
    want_ref = np.asarray(jax_reference(jnp.asarray(x), jgu, jdn))
    tree = from_jax_params({"gu": jgu, "dn": jdn}, device="cpu")
    tx = torch.from_numpy(x)
    launched = mlp_w4.launches
    got = mlp_w4.mlp_w4_fused(tx, tree["gu"], tree["dn"]).numpy()
    assert mlp_w4.launches == launched  # CPU tensors: the plain version
    assert got.shape == (M, K)
    np.testing.assert_allclose(got, want_fused, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mlp_w4.mlp_w4_reference(tx, tree["gu"], tree["dn"]).numpy(),
                               want_ref, rtol=RTOL, atol=ATOL)
    # The engine's baked scale layout gives the same result.
    baked = prepare_kernel_scales(tree)
    np.testing.assert_array_equal(mlp_w4.mlp_w4_fused(tx, baked["gu"], baked["dn"]).numpy(), got)


def test_channel_scales_and_batched_input(rng):
    jgu, jdn = _pair(rng, 128, 256, -1, strategy=JStrategy.CHANNEL)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    tree = from_jax_params({"gu": jgu, "dn": jdn}, device="cpu")
    got = mlp_w4.mlp_w4_fused(torch.from_numpy(x), tree["gu"], tree["dn"]).numpy()
    assert got.shape == (2, 3, 128)
    np.testing.assert_allclose(got, np.asarray(jax_reference(jnp.asarray(x), jgu, jdn)),
                               rtol=RTOL, atol=ATOL)


def test_bf16_input_rounds_act_like_jax(rng):
    """A bf16 stream: act is rounded to bf16 between the two products, as the
    reference's kernel does (1e-2 of max|y|: bf16 rounding of x and act)."""
    jgu, jdn = _pair(rng)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_fused(xb, jgu, jdn, interpret=True))
    tree = from_jax_params({"gu": jgu, "dn": jdn}, device="cpu")
    got = mlp_w4.mlp_w4_fused(torch.from_numpy(x).to(torch.bfloat16), tree["gu"],
                              tree["dn"]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


def _eligibility_cases(rng):
    jgu, jdn = _pair(rng)
    wd8 = (0.1 * rng.standard_normal((256, 128))).astype(np.float32)
    q, s, z = jax_rtn(wd8, JQuantType.QInt8, JStrategy.CHANNEL, -1, True, False)
    j8 = jax_make_qtensor(q, s, z, quant_type=JQuantType.QInt8, strategy=JStrategy.CHANNEL,
                          group_size=-1, symmetric=True, reduce_range=False)
    _, jbad = _pair(rng, K=128, inter=128, gs=64)
    # Gemma-3-270M's widths (K = 640 pads to 768): the VMEM estimate caps M
    # at 165 there.
    jgu270, jdn270 = _pair(rng, K=640, inter=2048, gs=128)
    return [(jgu, jdn, M) for M in (1, 32, 256, 257, 512)] + [
        (jgu, j8, 32), (jgu, jbad, 32)] + [(jgu270, jdn270, M) for M in (32, 165, 166, 256)]


def test_eligibility_matches_jax(rng):
    cases = _eligibility_cases(rng)
    got = [mlp_w4.mlp_w4_eligible(*from_jax_params({"a": a, "b": b}, device="cpu").values(), M)
           for a, b, M in cases]
    assert got == [jax_eligible(a, b, M) for a, b, M in cases]
    assert got[:5] == [True, True, True, False, False] and got[-4:] == [True, True, False, False]


def test_wrapper_rejects_bad_operands(rng):
    tree = from_jax_params(dict(zip(("gu", "dn"), _pair(rng))), device="cpu")
    ops, kw = mlp_w4.mlp_w4_operands(torch.zeros((2, 128)), tree["gu"], tree["dn"])
    x2d, wg, sg, zg, wd, sd, zd = ops
    with pytest.raises(TypeError):
        mlp_w4.mlp_w4(x2d.half(), *ops[1:], **kw)
    with pytest.raises(ValueError):
        mlp_w4.mlp_w4(x2d[:, :64], *ops[1:], **kw)
    with pytest.raises(ValueError):
        mlp_w4.mlp_w4(x2d, wg, sg[..., :8], zg, wd, sd, zd, **kw)
    with pytest.raises(ValueError):
        mlp_w4.mlp_w4(*ops, **{**kw, "gs_d": 48})
    assert mlp_w4.mlp_w4(*ops, **kw).shape == (2, 128)


TINY = dict(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
            head_dim=64, vocab_size=512)


def _w4_tree(pkg, model, params):
    q, _ = pkg.quantize(model, params, pkg.QConfig(
        weights=pkg.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    q, _ = pkg.quantize(model, q, pkg.QConfig(
        weights=pkg.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    return q


def test_engine_decode_with_megakernel_matches_jax(monkeypatch):
    """The W4 tree (g64 body, int8 head, fused) through both engines with
    ``mlp_megakernel=True``: prefill logits and greedy tokens equal JAX's,
    every layer's MLP takes the hook at prefill (M = 16) and at each decode
    step, and with the default "auto" none does."""
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    jp = jax_fuse(_w4_tree(joqt, jmodel, params))
    tp = fuse_gemma3_projections(_w4_tree(toqt, tmodel, from_jax_params(params, device="cpu")))
    ids = np.random.default_rng(1).integers(1, TINY["vocab_size"], (2, 8)).astype(np.int32)
    lengths = np.full((2,), 8, np.int32)
    calls = []
    fused = mlp_w4.mlp_w4_fused

    def counting(x, *args):
        calls.append(x.shape[:-1])
        return fused(x, *args)

    monkeypatch.setattr(mlp_w4, "mlp_w4_fused", counting)

    def run(eng, steps=4):
        cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
        first = np.asarray(np.argmax(np.asarray(logits), -1), np.int32)
        _, gen = eng.decode_multi(cache, first, steps=steps)
        return np.asarray(logits), np.asarray(gen)

    jlogits, jgen = run(JEngine(jmodel, jp, max_batch=2, max_seq=32, mlp_megakernel=True))
    tlogits, tgen = run(InferenceEngine(tmodel, tp, max_batch=2, max_seq=32,
                                        mlp_megakernel=True))
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tgen, jgen)
    assert len(calls) == TINY["num_layers"] * (1 + 4)
    assert calls[0] == (2, 8) and calls[-1] == (2, 1)
    calls.clear()
    run(InferenceEngine(tmodel, tp, max_batch=2, max_seq=32))
    assert calls == []
