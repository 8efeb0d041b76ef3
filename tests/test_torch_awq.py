"""AWQ in the port against the JAX package, on the same numpy params and
calibration inputs (the JAX helpers' two-site model, bridged).

Tolerances: the chosen grid ratio equals JAX's (else the two candidates'
losses agree within 1e-6 relative: the losses are float32 matmuls summed in
another order); the prescale, the rescaled weight and the rescaled captured
inputs within 1e-6 relative; the clip ratio equal. The pre-pass leaves the
float output within 5e-5, as the JAX package's own test holds it.
"""

import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as toqt
from onnx_quantize_tpu.calibration import calibrate_model as jax_calibrate
from onnx_quantize_tpu.plan import build_plan as jax_build_plan
from onnx_quantize_tpu.plan import stamp_qconfig as jax_stamp
from onnx_quantize_tpu_torch.calibration import calibrate_model
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.plan import build_plan, stamp_qconfig

from .helpers import TwoMatMul as JTwoMatMul
from .torch_helpers import TwoMatMul

torch.set_num_threads(1)

RTOL = 1e-6
LOSS_RTOL = 1e-6


def _config(pkg, x, clip_search, w=None):
    return pkg.QConfig(weights=pkg.QWeightArgs(**(w or dict(dtype="uint4", group_size=8))),
                       preprocessors=[pkg.AwqConfig(clip_search=clip_search)],
                       calibration_data=x)


def _setup(seed, clip_search, w=None):
    """Both packages' model, params, calibrated and stamped plan, config."""
    rng = np.random.default_rng(seed)
    jmodel = JTwoMatMul()
    jp = jmodel.random_params(rng)
    w1 = np.asarray(jp["fc1"]["w"]).copy()
    w1[::2] *= 8.0  # input channels of very different weight magnitude
    jp["fc1"]["w"] = w1
    x = rng.standard_normal((32, 16)).astype(np.float32)
    x[:, 1] *= 6.0  # a salient activation channel
    out = []
    for pkg, model, params, plan_fns in (
            (joqt, jmodel, jp, (jax_build_plan, jax_calibrate, jax_stamp)),
            (toqt, TwoMatMul(), from_jax_params(jp, device="cpu"),
             (build_plan, calibrate_model, stamp_qconfig))):
        build, calibrate, stamp = plan_fns
        qc = _config(pkg, x, clip_search, w)
        plan = build(model.linear_sites(), qc)
        calibrate(model, params, plan, qc)
        stamp(plan, qc)
        out.append((model, params, plan, qc))
    return out, x


@pytest.mark.parametrize("w", [dict(dtype="uint4", group_size=8),
                               dict(dtype="int4", group_size=-1, symmetric=True),
                               dict(dtype="uint8", group_size=None)],
                         ids=["uint4-g8", "int4-channel", "uint8-tensor"])
def test_awq_scale_search_matches_jax(w):
    (j, t), x = _setup(0, clip_search=False, w=w)
    (jmodel, jp, jplan, jqc), (tmodel, tp, tplan, tqc) = j, t
    y0 = tmodel(tp, torch.from_numpy(x))
    grids = {e.name: toqt.AwqConfig().build_pass(tqc).scale_grid(
        tp[e.name]["w"], e.captured_input, e.qconfig.weights) for e in tplan}
    assert jqc.preprocessors[0].build_pass(jqc)(jmodel, jp, jplan, jqc)
    assert tqc.preprocessors[0].build_pass(tqc)(tmodel, tp, tplan, tqc)
    for name, (scales, losses) in grids.items():
        jpre = np.asarray(jp[name]["prescale"])
        # The ratio JAX chose: its candidate is the one its prescale inverts.
        j_idx = int(np.argmin(np.abs(scales.numpy() * jpre[None, :] - 1.0).max(axis=1)))
        t_idx = int(torch.argmin(losses))
        if t_idx != j_idx:
            np.testing.assert_allclose(losses[t_idx].item(), losses[j_idx].item(),
                                       rtol=LOSS_RTOL)
        np.testing.assert_allclose(tp[name]["prescale"].numpy(), jpre, rtol=RTOL)
        assert tp[name]["w"].dtype == torch.float32
        np.testing.assert_allclose(tp[name]["w"].numpy(), np.asarray(jp[name]["w"]), rtol=RTOL)
        np.testing.assert_allclose(tplan[name].captured_input.numpy(),
                                   np.asarray(jplan[name].captured_input), rtol=RTOL,
                                   atol=1e-6)
    np.testing.assert_allclose(tmodel(tp, torch.from_numpy(x)).numpy(), y0.numpy(), atol=5e-5)


def test_awq_clip_search_matches_jax_and_stays_per_site():
    """The clip search writes each site's own ratio into its own stamped
    qconfig: after the search the two sites keep different ratios (one
    shared stamped config would hold the last site's for both)."""
    (j, t), _ = _setup(1, clip_search=True)
    (jmodel, jp, jplan, jqc), (tmodel, tp, tplan, tqc) = j, t
    entries = list(tplan)
    assert entries[0].qconfig is not entries[1].qconfig
    assert entries[0].qconfig.weights is not entries[1].qconfig.weights
    jqc.preprocessors[0].build_pass(jqc)(jmodel, jp, jplan, jqc)
    tqc.preprocessors[0].build_pass(tqc)(tmodel, tp, tplan, tqc)
    ratios = {e.name: e.qconfig.weights.clip_ratio for e in tplan}
    assert ratios == {e.name: e.qconfig_dict["weights"]["clip_ratio"] for e in jplan}
    assert ratios["fc1"] != ratios["fc2"]
    assert tqc.weights.clip_ratio == 1.0  # the caller's config is untouched


def test_awq_quantize_end_to_end_matches_jax():
    """quantize() with AWQ (calibrate, stamp, the pass, re-calibrate, RTN of
    the rescaled weights at the searched clip ratio) in both packages: the
    same codes; outputs within 1e-5 of the largest."""
    rng = np.random.default_rng(2)
    jmodel = JTwoMatMul()
    jp = jmodel.random_params(rng)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    jq, jplan = joqt.quantize(jmodel, jp, _config(joqt, x, True))
    tq, tplan = toqt.quantize(TwoMatMul(), from_jax_params(jp, device="cpu"),
                              _config(toqt, x, True))
    for name in ("fc1", "fc2"):
        np.testing.assert_array_equal(tq[name]["w"].data.numpy(), np.asarray(jq[name]["w"].data))
        np.testing.assert_allclose(tq[name]["w"].scale.numpy(), np.asarray(jq[name]["w"].scale),
                                   rtol=RTOL)
        assert tplan[name].captured_input is None  # freed once consumed
    want = np.asarray(jmodel(jq, x))
    got = TwoMatMul()(tq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_prescaled_sites_stay_unfused_and_off_the_fused_mlp(monkeypatch):
    """AWQ's per-site prescales stop the q/k/v and gate/up fusions, and the
    fused-MLP hook leaves a prescaled down_proj to the unfused path (the
    kernel has no hook for it), here with gate/up fused (RTN) and only
    down_proj through AWQ; the engine's logits equal the model's."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.models.gemma3 import (
        Gemma3,
        Gemma3Config,
        fuse_gemma3_projections,
    )
    from onnx_quantize_tpu_torch.ops.kernels import mlp_w4

    model = Gemma3(Gemma3Config.tiny(hidden_size=128, intermediate_size=256, head_dim=64))
    params = model.init(torch.Generator().manual_seed(0))
    ids = np.random.default_rng(1).integers(1, 250, (4, 16))
    w4 = toqt.QWeightArgs(dtype="uint4", group_size=64)
    awq, _ = toqt.quantize(model, params, toqt.QConfig(
        weights=w4, preprocessors=[toqt.AwqConfig()], ignore=["lm_head"], calibration_data=ids))
    fused = fuse_gemma3_projections(awq)
    for layer in ("layers.0", "layers.1"):
        assert "_fused_qkv" not in fused[layer]["attn"]
        assert "_fused_gate_up" not in fused[layer]["mlp"]
    q, _ = toqt.quantize(model, params, toqt.QConfig(
        weights=w4, preprocessors=[toqt.AwqConfig()], calibration_data=ids,
        ignore=["lm_head", "attn", "gate_proj", "up_proj"]))
    q, _ = toqt.quantize(model, q, toqt.QConfig(weights=w4, ignore=["lm_head", "down_proj"]))
    fused = fuse_gemma3_projections(q)
    assert "_fused_gate_up" in fused["layers.0"]["mlp"]
    assert "prescale" in fused["layers.0"]["mlp"]["down_proj"]

    def decode_calls(tree):
        calls = []
        monkeypatch.setattr(mlp_w4, "mlp_w4_fused", lambda x, *a: calls.append(x) or
                            torch.zeros(*x.shape[:-1], 128))
        eng = InferenceEngine(model, tree, max_batch=4, max_seq=32, mlp_megakernel=True)
        cache, logits = eng.prefill(eng.new_cache(), ids, np.full((4,), 16, np.int32))
        eng.decode(cache, torch.argmax(logits, -1))
        return calls, logits

    calls, logits = decode_calls(fused)
    assert not calls
    want = model(q, torch.from_numpy(ids))[:, -1]
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * want.abs().max().item())
    # The same tree without down_proj's prescale does take the hook.
    for layer in ("layers.0", "layers.1"):
        del fused[layer]["mlp"]["down_proj"]["prescale"]
    assert decode_calls(fused)[0]
