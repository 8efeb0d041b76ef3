"""QuaRot's residual-stream rotation (R1) in the port, held to the JAX package.

Counterpart of ``tests/prepasses/test_rotate.py``, its MoE case included
(the router, every expert and the shared pair fold). The fold must be exact in float32 (JAX's
own tolerance: 2e-4 abs, 1e-4 rel), refuse architectures whose post-norms
cannot absorb it, and cut low-bit quantization error on outlier channels.
Cross-package: the rotation matrices are bit-equal to JAX's (both drawn by
numpy from the same seed), and the RTN codes of a rotated tiny Llama equal
JAX's but for ties moved by a float64 last bit (the fold's float64 matmul sums
in torch's order, then rounds to float32): counted, and at most 1 in 10^4.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.llama import tiny_llama_config as jtiny_llama_config
from onnx_quantize_tpu.models.moe import tiny_moe_config as jtiny_moe_config
from onnx_quantize_tpu.prepasses import rotate as jrotate
from onnx_quantize_tpu.utils import copy_tree as jcopy_tree
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config
from onnx_quantize_tpu_torch.plan import QuantPlan
from onnx_quantize_tpu_torch.prepasses import rotate
from onnx_quantize_tpu_torch.prepasses.rotate import (
    random_orthogonal,
    randomized_hadamard,
    rotate_residual_stream,
)
from onnx_quantize_tpu_torch.utils import copy_tree

from .torch_helpers import TwoMatMul

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4  # tests/prepasses/test_rotate.py:51
SITES = [("attn", "q_proj"), ("attn", "k_proj"), ("attn", "v_proj"), ("attn", "o_proj"),
         ("mlp", "gate_proj"), ("mlp", "up_proj"), ("mlp", "down_proj")]


def _ids(batch=2, seq=16, vocab=256):
    return np.random.default_rng(0).integers(1, vocab, size=(batch, seq)).astype(np.int32)


def _run(model, params, ids):
    return model(params, torch.from_numpy(ids).long()).numpy()


def _llama(seed, **kw):
    """The port's tiny Llama on JAX's init params (CPU), and the JAX pair."""
    jmodel = JGemma3(jtiny_llama_config(**kw))
    jparams = jmodel.init(jax.random.key(seed))
    return Gemma3(tiny_llama_config(**kw)), from_jax_params(jparams, device="cpu"), jmodel, jparams


def _mse(a, b):
    return float(np.mean((a - b) ** 2))


@pytest.mark.parametrize("n", [64, 96, 80, 33])
@pytest.mark.parametrize("name", ["randomized_hadamard", "random_orthogonal"])
def test_rotations_are_orthogonal_and_bit_equal_to_jax(n, name):
    r = getattr(rotate, name)(n, np.random.default_rng(3))
    np.testing.assert_allclose(r @ r.T, np.eye(n), atol=1e-10)
    np.testing.assert_array_equal(r, getattr(jrotate, name)(n, np.random.default_rng(3)))


@pytest.mark.parametrize("mode", ["hadamard", "random"])
def test_rotation_preserves_fp_logits(mode):
    """A pure reparameterization: same logits, Llama conventions (plain-w
    norms, GQA) with attention biases (head space, unfolded)."""
    model, params, jmodel, jparams = _llama(0, num_layers=2, attn_bias=True)
    ids = _ids()
    ref = _run(model, params, ids)
    builder = randomized_hadamard if mode == "hadamard" else random_orthogonal
    rot = builder(model.cfg.hidden_size, np.random.default_rng(7))
    rotated = copy_tree(params)
    gains = rotate_residual_stream(model, rotated, rot)
    out = _run(model, rotated, ids)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    assert ("lm_head",) in gains and ("layers.0", "attn", "q_proj") in gains
    # JAX's fold of the same params: the same rotated weights within float32's
    # last bit, and the same logits.
    jrotated = copy_tree(jparams)
    jrotate.rotate_residual_stream(jmodel, jrotated, rot)
    for i in range(2):
        for m, p in SITES:
            np.testing.assert_allclose(rotated[f"layers.{i}"][m][p]["w"].numpy(),
                                       np.asarray(jrotated[f"layers.{i}"][m][p]["w"]),
                                       rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jmodel(jrotated, ids)), atol=1e-5, rtol=0)


def test_tied_head_is_rotated_once():
    """The tied lm_head views the embedding: every fold rebinds, so the head
    folds the pre-fold embedding (``R^T E^T``, the norm gain 1) and the
    logits stay exact."""
    model = Gemma3(tiny_llama_config(num_layers=1))
    params = model.init(torch.Generator().manual_seed(0))
    assert params["lm_head"]["w"].data_ptr() == params["embed"]["w"].data_ptr()
    embed_before = params["embed"]["w"].clone()
    ids = _ids()
    ref = _run(model, params, ids)
    rot = randomized_hadamard(model.cfg.hidden_size, np.random.default_rng(1))
    rotate_residual_stream(model, params, rot)
    once = (torch.from_numpy(rot).T @ embed_before.T.double()).float()
    np.testing.assert_array_equal(params["lm_head"]["w"].numpy(), once.numpy())
    np.testing.assert_allclose(_run(model, params, ids), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("online", [False, True], ids=["R1", "R1+R2/R3/R4"])
def test_rotate_config_keeps_fp_logits(online):
    """``RotateConfig`` builds its pass, and the pass leaves the float model's
    logits within JAX's tolerance, for R1 alone and with the online rotations
    (stamped on the model)."""
    model, params, _, _ = _llama(2, num_layers=2)
    ids = _ids()
    ref = _run(model, params, ids)
    extra = dict(rotate_qk=True, rotate_v=True, rotate_down=True, online_block=64) if online \
        else {}
    cfg = oqt.RotateConfig(seed=5, **extra)
    qconfig = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8"), preprocessors=[cfg])
    rotated = copy_tree(params)
    assert cfg.build_pass(qconfig)(model, rotated, QuantPlan(), qconfig) is True
    np.testing.assert_allclose(_run(model, rotated, ids), ref, atol=ATOL, rtol=RTOL)
    assert (model.layers[0].attn.qk_rot is not None) == online
    assert (model.layers[1].mlp.down_rot is not None) == online


def test_rotation_rejects_sandwich_norms():
    model = Gemma3(Gemma3Config.tiny())  # Gemma's default: sandwich norms
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="sandwich"):
        rotate_residual_stream(model, params, randomized_hadamard(
            model.cfg.hidden_size, np.random.default_rng(0)))


def test_rotation_rejects_non_decoder():
    with pytest.raises(ValueError, match="Gemma3-family"):
        rotate_residual_stream(TwoMatMul(), {}, np.eye(16))


def test_rotation_rejects_prescale():
    """Rotation must run before SmoothQuant (a prescale does not commute)."""
    model = Gemma3(tiny_llama_config(num_layers=1))
    params = model.init(torch.Generator().manual_seed(0))
    params["layers.0"]["attn"]["q_proj"]["prescale"] = torch.ones(model.cfg.hidden_size)
    with pytest.raises(ValueError, match="before SmoothQuant"):
        rotate_residual_stream(model, params, randomized_hadamard(
            model.cfg.hidden_size, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="before SmoothQuant"):
        oqt.quantize(model, model.init(torch.Generator().manual_seed(0)), oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8"), calibration_data=_ids(),
            preprocessors=[oqt.SmoothQuantConfig(), oqt.RotateConfig()], ignore=["lm_head"]))


def _hot(params, cfg, hot):
    """A few stream channels of every stream-writing projection (and the
    embedding) carry 30x the energy."""
    for leaf in [params["embed"]] + [params[f"layers.{i}"][m][p]
                                     for i in range(cfg.num_layers)
                                     for m, p in (("attn", "o_proj"), ("mlp", "down_proj"))]:
        w = leaf["w"].clone()
        w[:, hot] *= 30.0
        leaf["w"] = w
    return params


def test_rotation_reduces_quantized_error_on_outliers():
    """Outlier input channels blow up per-channel int4 scales; the rotation
    spreads them. The quantized-output error must drop by more than half."""
    model, params, _, _ = _llama(3, num_layers=2)
    params = _hot(params, model.cfg, [3, 17, 40])
    ids = _ids()
    ref = _run(model, params, ids)
    qc = dict(weights=oqt.QWeightArgs(dtype="int4"), ignore=["lm_head", "embed"])
    qp_plain, _ = oqt.quantize(model, params, oqt.QConfig(**qc))
    qp_rot, _ = oqt.quantize(model, params, oqt.QConfig(
        preprocessors=[oqt.RotateConfig(seed=5)], **qc))
    err_plain, err_rot = _mse(_run(model, qp_plain, ids), ref), _mse(_run(model, qp_rot, ids), ref)
    assert err_rot < 0.5 * err_plain, (err_rot, err_plain)


def test_rotate_pass_updates_captured_inputs():
    """With static input activations the pass moves captured inputs to the
    rotated basis (post-calibration runs on the rotated model); the pipeline
    stays close to fp, and the calibrated input scales are JAX's."""
    model, params, jmodel, jparams = _llama(4, num_layers=1)
    ids = _ids(batch=4, seq=8)
    ref = _run(model, params, ids)
    kw = dict(calibration_data=ids, ignore=["lm_head", "embed"])
    qparams, plan = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8"),
        input_activations=oqt.QActivationArgs(dtype="int8"),
        preprocessors=[oqt.RotateConfig()], **kw))
    out = _run(model, qparams, ids)
    assert np.isfinite(out).all()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.8
    _, jplan = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="int8"),
        input_activations=joqt.QActivationArgs(dtype="int8"),
        preprocessors=[joqt.RotateConfig()], **kw))
    for entry in plan:
        np.testing.assert_allclose(entry.input_scale.numpy(),
                                   np.asarray(jplan[entry.name].input_scale), rtol=1e-5)


def test_rotate_composes_with_awq():
    """rotate -> AWQ: AWQ reads the rotated captured inputs and stays about as
    accurate as rotate-only RTN (random weights: a wash, not a gain)."""
    model, params, _, _ = _llama(5, num_layers=2)
    ids = _ids(batch=4, seq=8)
    ref = _run(model, params, ids)
    common = dict(weights=oqt.QWeightArgs(dtype="uint4", group_size=16), calibration_data=ids,
                  ignore=["lm_head", "embed"])
    qp_rot, _ = oqt.quantize(model, params, oqt.QConfig(
        preprocessors=[oqt.RotateConfig()], **common))
    qp_both, _ = oqt.quantize(model, params, oqt.QConfig(
        preprocessors=[oqt.RotateConfig(), oqt.AwqConfig()], **common))
    assert _mse(_run(model, qp_both, ids), ref) <= 1.5 * _mse(_run(model, qp_rot, ids), ref)


def test_rotate_composes_with_gptq():
    """rotate -> GPTQ: post-calibration captures the rotated model's inputs,
    so GPTQ's Hessian is built in the rotated basis; GPTQ still beats
    rotate-only RTN."""
    model, params, _, _ = _llama(6, num_layers=2)
    ids = _ids(batch=4, seq=8)
    ref = _run(model, params, ids)
    common = dict(calibration_data=ids, ignore=["lm_head", "embed"],
                  preprocessors=[oqt.RotateConfig()])
    qp_rtn, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16), **common))
    qp_gptq, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16, algorithm=oqt.GPTQConfig()),
        **common))
    err_rtn, err_gptq = _mse(_run(model, qp_rtn, ids), ref), _mse(_run(model, qp_gptq, ids), ref)
    assert err_gptq <= 1.05 * err_rtn, (err_gptq, err_rtn)


def test_rotation_recovers_activation_quant_error():
    """Outlier stream channels make per-tensor static int8 activation scales
    poor; rotating the stream spreads them before the activation quantizer."""
    model, params, _, _ = _llama(7, num_layers=2)
    params = _hot(params, model.cfg, [3, 17, 40])
    ids = _ids(batch=4, seq=8)
    ref = _run(model, params, ids)
    common = dict(weights=oqt.QWeightArgs(dtype="int8"),
                  input_activations=oqt.QActivationArgs(dtype="int8"), calibration_data=ids,
                  ignore=["lm_head", "embed"])
    qp_plain, _ = oqt.quantize(model, params, oqt.QConfig(**common))
    qp_rot, _ = oqt.quantize(model, params, oqt.QConfig(
        preprocessors=[oqt.RotateConfig(seed=9)], **common))
    err_plain, err_rot = _mse(_run(model, qp_plain, ids), ref), _mse(_run(model, qp_rot, ids), ref)
    assert err_rot < 0.5 * err_plain, (err_rot, err_plain)


@pytest.mark.parametrize("online", [False, True], ids=["R1", "R1+R2/R3/R4"])
def test_rtn_codes_of_rotated_llama_equal_jax(online):
    """RTN uint4 g16 of the same tiny Llama rotated in each package: the codes
    agree but for ties a float64 last bit moved (counted, at most 1e-4 of the
    codes); scales within 1e-6 relative; the quantized logits within 1e-4."""
    model, params, jmodel, jparams = _llama(8, num_layers=2)
    extra = dict(rotate_qk=True, rotate_v=True, rotate_down=True, online_block=64) if online \
        else {}
    kw = dict(ignore=["lm_head"])
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[oqt.RotateConfig(seed=5, **extra)], **kw))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[joqt.RotateConfig(seed=5, **extra)], **kw))
    moved = total = 0
    for i in range(2):
        for m, p in SITES:
            ours, theirs = q[f"layers.{i}"][m][p]["w"], jq[f"layers.{i}"][m][p]["w"]
            a, b = ours.data.numpy(), np.asarray(theirs.data)
            moved += int(np.sum((a & 0x0F) != (b & 0x0F)) + np.sum((a >> 4) != (b >> 4)))
            total += 2 * a.size
            np.testing.assert_allclose(ours.scale.numpy(), np.asarray(theirs.scale), rtol=1e-6)
    assert moved <= 1e-4 * total, (moved, total)
    ids = _ids()
    np.testing.assert_allclose(_run(model, q, ids), np.asarray(jmodel(jq, ids)), atol=1e-4,
                               rtol=0)


def test_rotation_preserves_fp_logits_moe():
    """MoE: the router's logits change basis with the stream, so the routing
    and the logits stay (tests/prepasses/test_rotate.py:56); the folded
    weights equal JAX's fold of the same params within float32 rounding."""
    kw = dict(num_layers=2, shared_expert_size=48)
    jmodel = JGemma3(jtiny_moe_config(**kw))
    jparams = jmodel.init(jax.random.key(1))
    model, params = Gemma3(tiny_moe_config(**kw)), from_jax_params(jparams, device="cpu")
    ids = _ids()
    ref = _run(model, params, ids)
    rot = randomized_hadamard(model.cfg.hidden_size, np.random.default_rng(2))
    rotated = copy_tree(params)
    gains = rotate_residual_stream(model, rotated, rot)
    np.testing.assert_allclose(_run(model, rotated, ids), ref, atol=ATOL, rtol=RTOL)
    mlp = ("layers.0", "mlp")
    assert {mlp + ("router",), mlp + ("shared_gate",), mlp + ("experts.3", "up_proj"),
            mlp + ("shared", "gate_proj")} <= set(gains)
    jrotated = jcopy_tree(jparams)
    jrotate.rotate_residual_stream(jmodel, jrotated, rot)
    for path in (("router",), ("experts.2", "down_proj"), ("shared", "down_proj"),
                 ("shared_gate",)):
        got = rotated["layers.1"]["mlp"]
        want = jrotated["layers.1"]["mlp"]
        for key in path:
            got, want = got[key], want[key]
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6)
