"""The W8A8 kernel's plain version, the activation config rules, and the A8
slice as a whole on the CPU against the JAX package: a tiny Gemma-3 in W4A8
(logits and greedy engine tokens) and BASELINE's configuration 2 (int8
per-channel weights, dynamic uint8 asymmetric inputs)."""

import jax
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
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jax_make_qtensor
from onnx_quantize_tpu import ops as jax_ops
from onnx_quantize_tpu.ops import convert_to_w4a8 as jax_convert
from onnx_quantize_tpu.ops.kernels.matmul_w8a8 import w8a8_matmul as jax_w8a8
from onnx_quantize_tpu.ops.reference import quantized_matmul_jnp
from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.ops import convert_to_w4a8, quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import (
    matmul_w4a8,
    matmul_w8,
    matmul_w8a8,
    select_kernel,
)

torch.set_num_threads(1)

# The plain version and the Pallas kernel form the same exact int32 tile
# dots and differ only in the float32 order of the tile sums: 1e-5 of max|y|.
REL_TOL = 1e-5


def _close(got, want, rel=REL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


# JAX's own W8A8 cases (tests/ops/test_w8a8.py), plus the Gemma lm_head's K
# and a tile past the plain version's 1024-row exact chunk.
W8A8_CASES = [(dt, strat, gs, K, 128) for dt in ("int8", "uint8")
              for strat, gs, K in (("channel", -1, 64), ("channel", -1, 100),
                                   ("group", 16, 64))]
W8A8_CASES += [("int8", "channel", -1, 640, 256), ("int8", "channel", -1, 1100, 128)]


@pytest.mark.parametrize("dtype,strategy,gs,K,N", W8A8_CASES)
def test_w8a8_plain_matches_jax_kernel_and_oracle(dtype, strategy, gs, K, N):
    w = (0.1 * np.random.default_rng(0).standard_normal((K, N))).astype(np.float32)
    q, s, z = jax_rtn(w, JQuantType(dtype), JStrategy(strategy), gs, True, False)
    jqt = jax_make_qtensor(q, s, z, quant_type=JQuantType(dtype), strategy=JStrategy(strategy),
                           group_size=gs, symmetric=True, reduce_range=False,
                           input_quant=JActQuantSpec(mode="dynamic", dtype="int8",
                                                     symmetric=True))
    tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
    assert select_kernel(torch.zeros(1, K), tqt, None).__module__ == matmul_w8a8.__name__
    x = np.random.default_rng(1).standard_normal((6, K)).astype(np.float32)
    got = matmul_w8a8.w8a8_dequant_matmul(torch.from_numpy(x), tqt).numpy()
    assert got.shape == (6, N)
    np.testing.assert_allclose(got, np.asarray(quantized_matmul_jnp(x, jqt)), rtol=2e-4,
                               atol=2e-4)
    _close(got, jax_w8a8(x, jqt, interpret=True))


def test_wrappers_reject_bad_operands():
    x_q = torch.zeros((2, 64), dtype=torch.int8)
    sx = torch.tensor(0.5)
    data = torch.zeros((32, 16), dtype=torch.uint8)
    scales = torch.ones((1, 2, 16))
    with pytest.raises(TypeError):
        matmul_w4a8.w4a8_matmul(x_q.float(), sx, data, scales, scales, gs=32, signed=False)
    with pytest.raises(TypeError):
        matmul_w4a8.w4a8_matmul(x_q, sx.double(), data, scales, scales, gs=32, signed=False)
    with pytest.raises(ValueError):
        matmul_w4a8.w4a8_matmul(x_q[:, :48], sx, data, scales, scales, gs=32, signed=False)
    with pytest.raises(ValueError):
        matmul_w4a8.w4a8_matmul(x_q, sx, data, scales[..., :8], scales, gs=32, signed=False)
    rows = torch.ones((1, 16))
    w8 = torch.zeros((64, 16), dtype=torch.int8)
    assert matmul_w8a8.w8a8_matmul(x_q, sx, w8, rows, bk=64).shape == (2, 16)
    with pytest.raises(TypeError):
        matmul_w8a8.w8a8_matmul(x_q, sx, w8.float(), rows, bk=64)
    with pytest.raises(ValueError):
        matmul_w8a8.w8a8_matmul(x_q, sx, w8, rows, bk=48)
    with pytest.raises(ValueError):
        matmul_w8a8.w8a8_matmul(x_q, sx, w8[:, :8], rows, bk=64)


# QActivationArgs keyword sets: the reference's validators decide each.
ACT_ARGS = [
    dict(), dict(strategy="tensor"), dict(strategy="channel"), dict(group_size=-1),
    dict(group_size=128), dict(group_size=-2), dict(dtype="int4"), dict(dtype="uint4"),
    dict(dtype="int8", is_static=False), dict(dtype="uint8", is_static=False),
    dict(dtype="uint8", is_static=False, symmetric=True, reduce_range=True),
    dict(dtype="uint8"),
]


def _kind(exc: Exception) -> str:
    """pydantic raises its ValidationError, a ValueError, where the port's
    dataclasses raise ValueError."""
    return "ValueError" if isinstance(exc, ValueError) else type(exc).__name__


def _outcome(cls, kwargs):
    try:
        a = cls(**kwargs)
    except Exception as exc:  # noqa: BLE001 - the exception type is the result
        return _kind(exc)
    return (a.dtype.value, a.strategy.value, a.is_static, a.symmetric, a.reduce_range)


@pytest.mark.parametrize("kwargs", ACT_ARGS,
                         ids=lambda k: "-".join(map(str, k.values())) or "default")
def test_activation_args_validate_like_jax(kwargs):
    assert _outcome(toqt.QActivationArgs, kwargs) == _outcome(joqt.QActivationArgs, kwargs)


# (weights, input activations, output activations): the config-level rules.
DYN = dict(dtype="uint8", is_static=False)
CONFIG_CASES = [
    (dict(dtype="int8", group_size=-1), DYN, None),  # configuration 2
    (dict(dtype="int8", group_size=-1), DYN, DYN),
    (dict(dtype="int8", group_size=-1), None, DYN),
    (dict(dtype="uint4", group_size=-1), DYN, None),  # 4-bit weights with activations
    (dict(dtype="int8", group_size=32), DYN, None),  # group weights with activations
    (dict(dtype="int8", group_size=-1), DYN, dict(dtype="uint8")),  # static and dynamic
    (None, DYN, None),  # activations without weights
]


@pytest.mark.parametrize("weights,inputs,outputs", CONFIG_CASES)
def test_config_rules_match_jax(weights, inputs, outputs):
    def build(pkg):
        try:
            pkg.QConfig(weights=None if weights is None else pkg.QWeightArgs(**weights),
                        input_activations=None if inputs is None else pkg.QActivationArgs(
                            **inputs),
                        output_activations=None if outputs is None else pkg.QActivationArgs(
                            **outputs))
        except Exception as exc:  # noqa: BLE001 - the exception type is the result
            return _kind(exc)
        return "ok"

    assert build(toqt) == build(joqt)


def test_static_activations_wait_for_calibration():
    """The reference accepts static activations (and calibrates them); the
    port raises, naming the ROADMAP entry."""
    static = toqt.QActivationArgs(dtype="uint8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toqt.QConfig(weights=toqt.QWeightArgs(dtype="int8", group_size=-1),
                     input_activations=static)


TINY = dict(hidden_size=320, intermediate_size=512, num_layers=3, sliding_pattern=3,
            num_heads=2, num_kv_heads=1, head_dim=64, sliding_window=8, vocab_size=512)
BODY = dict(dtype="uint4", group_size=64)
HEAD = dict(dtype="int8", group_size=-1, symmetric=True)
B, S, STEPS = 4, 32, 8
LENGTHS = np.array([12, 9, 15, 6], np.int32)  # every slot active


def _quantize(pkg, model, params, convert):
    params, _ = pkg.quantize(model, params, pkg.QConfig(
        weights=pkg.QWeightArgs(**BODY), ignore=["lm_head"]))
    params, _ = pkg.quantize(model, params, pkg.QConfig(
        weights=pkg.QWeightArgs(**HEAD), ignore=[r"^layers\."]))
    return convert(params)


@pytest.fixture(scope="module")
def a8_models():
    """The bench-style W4A8 tree in both packages: W4 g64 body, int8 head,
    fused, then the whole tree converted to dynamic int8 activations. The
    port quantizes the bridged float weights itself."""
    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(0))
    jp = jax_convert(jax_fuse(_quantize(joqt, jmodel, params, lambda p: p)))
    tp = _quantize(toqt, tmodel, from_jax_params(params, device="cpu"),
                   lambda p: convert_to_w4a8(fuse_gemma3_projections(p)))
    return jmodel, jp, tmodel, tp


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, int(LENGTHS.max())), np.int32)
    for i, n in enumerate(LENGTHS):
        ids[i, :n] = rng.integers(0, TINY["vocab_size"], n)
    return ids


def test_a8_tree_matches_jax(a8_models):
    _, jp, _, tp = a8_models
    for layer_site in (("layers.0", "attn", "_fused_qkv"), ("layers.2", "mlp", "down_proj"),
                       ("lm_head",)):
        jqt, tqt = jp, tp
        for key in layer_site:
            jqt, tqt = jqt[key], tqt[key]
        jqt, tqt = jqt["w"], tqt["w"]
        assert tqt.meta == from_jax_params({"w": jqt}, device="cpu")["w"].meta
        assert tqt.meta.input_quant.mode == "dynamic" and tqt.meta.input_quant.dtype == "int8"
        np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    x = torch.zeros((1, TINY["hidden_size"]))
    assert select_kernel(x, tp["layers.0"]["attn"]["_fused_qkv"]["w"], None).__module__ == (
        matmul_w4a8.__name__)
    assert select_kernel(x, tp["lm_head"]["w"], None).__module__ == matmul_w8a8.__name__


def _record_jax_sites(monkeypatch, run):
    """Run ``run()`` and return every (x, QTensor, bias) the JAX package's
    oracle saw, with its output."""
    seen = []

    def record(x, qt, bias=None):
        y = quantized_matmul_jnp(x, qt, bias)
        seen.append((np.array(x), qt, bias, np.asarray(y)))  # a writable copy
        return y

    monkeypatch.setattr(jax_ops, "quantized_matmul_jnp", record)
    run()
    return seen


def _sites_match(seen, kernels):
    """Each site's JAX input through the port's dispatch: the activation codes
    are bit-equal, so the outputs differ in float32 summation order only."""
    for x, jqt, bias, want in seen:
        tqt = from_jax_params({"w": jqt}, device="cpu")["w"]
        tx = torch.from_numpy(x)
        assert select_kernel(tx, tqt, bias).__module__ in kernels
        got = quantized_matmul(tx, tqt).numpy()
        spec = tqt.meta.output_quant
        if spec.mode == "none":
            _close(got, want)
            continue
        # A dynamic output quantizer rounds y, which differs in its last
        # bits: where it lands on a .5 tie the code moves by one step, in a
        # few elements of a site at most.
        qmin, qmax = spec.quant_type.qrange(spec.symmetric, spec.reduce_range)
        step = (max(want.max(), 0.0) - min(want.min(), 0.0)) / (qmax - qmin)
        diff = np.abs(got - want)
        assert diff.max() <= 1.01 * step
        assert (diff > REL_TOL * np.abs(want).max()).mean() <= 1e-3


# Why this bound: the per-tensor int8 quantizer is discontinuous. The two
# packages' site inputs differ in the last float32 bits (summation order),
# and where one lands on a .5 tie its code moves by one step (one code of
# 19,200 at the fifth of 13 sites here); that step passes through the later
# layers and moves the logits of the rows it touches by about 1% of the
# largest logit. So every logit is held within 5% of the largest, and the
# median difference, set by the rows no flip reached, within REL_TOL.
FLIP_TOL = 5e-2


def _close_but_flips(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    peak = np.abs(np.asarray(want)).max()
    assert diff.max() <= FLIP_TOL * peak
    assert np.median(diff) <= REL_TOL * peak


def test_a8_sites_match_jax(a8_models, monkeypatch):
    """Every W4A8 and W8A8 site of the tiny model's forward, fed the JAX
    package's own site input, within 1e-5 of max|y| of the JAX oracle."""
    jmodel, jp, _, _ = a8_models
    ids = _ids(seed=3)
    seen = _record_jax_sites(monkeypatch, lambda: jmodel(jp, ids))
    assert len(seen) == 4 * TINY["num_layers"] + 1
    _sites_match(seen, {matmul_w4a8.__name__, matmul_w8a8.__name__})


def test_a8_logits_match_jax(a8_models):
    jmodel, jp, tmodel, tp = a8_models
    ids = _ids(seed=3)
    want = jmodel(jp, ids)
    got = tmodel(tp, torch.from_numpy(ids).long())
    assert got.shape == (B, int(LENGTHS.max()), TINY["vocab_size"])
    _close_but_flips(got.numpy(), want)


def test_a8_engine_matches_jax(a8_models):
    """Prefill logits and greedy tokens of the A8 engine with every slot
    active: the per-tensor activation scale couples the rows of a batch, as
    in the reference, so an inactive slot's rows take part in the scale."""
    jmodel, jp, tmodel, tp = a8_models
    jeng = JEngine(jmodel, jp, max_batch=B, max_seq=S, kv_quant=True)
    teng = InferenceEngine(tmodel, tp, max_batch=B, max_seq=S, kv_quant=True)
    ids = _ids()
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, LENGTHS)
    tcache, tlogits = teng.prefill(teng.new_cache(), ids, LENGTHS)
    _close_but_flips(tlogits.numpy(), jlogits)
    first = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    jcache, jtoks = jeng.decode_multi(jcache, first, STEPS)
    tcache, ttoks = teng.decode_multi(tcache, first, STEPS)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcache["lengths"].numpy(), np.asarray(jcache["lengths"]))
    prompts = [[5, 9, 200, 7], list(range(30, 41))]
    assert teng.generate(prompts, max_new_tokens=4) == jeng.generate(prompts, max_new_tokens=4)


@pytest.mark.parametrize("outputs", [False, True])
def test_config2_dynamic_uint8_inputs_match_jax(outputs, monkeypatch):
    """BASELINE's configuration 2 (and with dynamic outputs as well): int8
    per-channel weights, dynamic uint8 asymmetric activations, on the W8
    kernel's plain version behind the QDQ prologue. Each site on the JAX
    package's own inputs within 1e-5 of max|y|; the logits within the
    tie-flip bound."""
    def config(pkg):
        act = pkg.QActivationArgs(dtype="uint8", is_static=False)
        return pkg.QConfig(weights=pkg.QWeightArgs(dtype="int8", group_size=-1),
                           input_activations=act, output_activations=act if outputs else None)

    jmodel = JGemma3(JGemma3Config.tiny(**TINY))
    tmodel = Gemma3(Gemma3Config.tiny(**TINY))
    params = jmodel.init(jax.random.key(1))
    jp, _ = joqt.quantize(jmodel, params, config(joqt))
    tp, _ = toqt.quantize(tmodel, from_jax_params(params, device="cpu"), config(toqt))
    site = tp["layers.0"]["attn"]["q_proj"]["w"]
    assert site.meta == from_jax_params(
        {"w": jp["layers.0"]["attn"]["q_proj"]["w"]}, device="cpu")["w"].meta
    np.testing.assert_array_equal(site.data.numpy(),
                                  np.asarray(jp["layers.0"]["attn"]["q_proj"]["w"].data))
    ids = _ids(seed=4)
    seen = _record_jax_sites(monkeypatch, lambda: jmodel(jp, ids))
    assert len(seen) == 7 * TINY["num_layers"] + 1
    _sites_match(seen, {matmul_w8.__name__})
    _close_but_flips(tmodel(tp, torch.from_numpy(ids).long()).numpy(), jmodel(jp, ids))
