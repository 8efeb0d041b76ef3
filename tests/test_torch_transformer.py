"""The port's TransformerLM against the JAX package, float and quantized.

Counterpart of ``tests/models/test_transformer.py``: the GPT-style LM has 13
sites a 2-layer model (12 biased Gemm sites, the bias-free MatMul lm_head);
the float logits equal JAX's within 1e-5 of the largest on JAX's params
(bridged). BASELINE config 2 (int8 per-channel weights, dynamic uint8 inputs,
lm_head ignored) and config 3 (static uint8 inputs and outputs, percentile
0.995 calibration), the latter in the JAX test's QDQ form and in the QLINEAR
form, quantized by both packages from the same params (random biases, so the
QBias codes count): the plans agree, every QTensor and QBias integer leaf is
equal (QLINEAR's int32 bias codes follow the calibrated input scale, which
the percentile places within one histogram bin of JAX's, so they are equal
where the scales are). JAX's quantized tree,
bridged, runs every site on JAX's own site inputs to JAX's outputs (within
1e-5 of the largest, but for an output code at a rounding tie, one code step
off), and the whole model within 1e-3 of the largest |logit| on average:
an activation code that flips at a tie between the two float orders moves
single logits further (~1e-2 of the largest, ROADMAP's compounding hazard),
so only the QLINEAR arm, integer from site to site, is held to 1e-5 at
every logit. The port's own tree meets the JAX file's ``rel < 0.1`` bar
against the float model. On each quantized
tree ``select_kernel`` names a Hopper kernel for every site (W8 for config 2
and config 3's QDQ form, Q8 for QLINEAR), so no site raises on CUDA.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.nn.module import Context as JContext
from onnx_quantize_tpu.models.transformer import TransformerConfig as JConfig
from onnx_quantize_tpu.models.transformer import TransformerLM as JTransformerLM
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor
from onnx_quantize_tpu_torch.ops import quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import matmul_q8, matmul_w8, select_kernel
from onnx_quantize_tpu_torch.utils import tree_get

LOGIT_TOL = 1e-3  # of the largest |logit|


@pytest.fixture(scope="module")
def lm():
    jmodel = JTransformerLM(JConfig())
    jparams = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    # Random biases (init is zeros), so the Gemm bias and its QBias codes count.
    for i in range(jmodel.cfg.num_layers):
        block = jparams[f"h.{i}"]
        for site in (block["attn"]["q_proj"], block["attn"]["k_proj"], block["attn"]["v_proj"],
                     block["attn"]["o_proj"], block["fc_in"], block["fc_out"]):
            site["b"] = jax.numpy.asarray(
                0.05 * rng.standard_normal(site["b"].shape).astype(np.float32))
    model = TransformerLM(TransformerConfig())
    return jmodel, jparams, model, from_jax_params(jparams, device="cpu")


def run(model, params, ids):
    with torch.no_grad():
        return model(params, torch.from_numpy(ids)).numpy()


def test_sites_and_float_logits(lm):
    jmodel, jparams, model, params = lm
    sites = model.linear_sites()
    assert [s.name for s in sites] == [s.name for s in jmodel.linear_sites()]
    assert len(sites) == 13
    assert sum(s.op_type == "Gemm" for s in sites) == 12
    assert {s.name: s.op_type for s in sites}["lm_head"] == "MatMul"
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    want = np.asarray(jmodel(jparams, ids))
    got = run(model, params, ids)
    assert got.shape == (2, 16, 512)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def config(name: str, ids):
    if name == "config2":
        return dict(weights=dict(dtype="int8", group_size=-1),
                    input_activations=dict(dtype="uint8", is_static=False), ignore=["lm_head"])
    static = dict(dtype="uint8")
    return dict(weights=dict(dtype="int8", group_size=-1), input_activations=static,
                output_activations=static,
                calibration_params=dict(method="percentile", percentile=0.995, num_samples=8,
                                        batch_size=4),
                calibration_data=ids, ignore=["lm_head"],
                format="qlinear" if name == "config3_qlinear" else "qdq")


def build(pkg, kw):
    kw = dict(kw)
    kw["weights"] = pkg.QWeightArgs(**kw["weights"])
    for key in ("input_activations", "output_activations"):
        if key in kw:
            kw[key] = pkg.QActivationArgs(**kw[key])
    if "calibration_params" in kw:
        kw["calibration_params"] = pkg.CalibrationParams(**kw["calibration_params"])
    return pkg.QConfig(**kw)


@pytest.mark.parametrize("name, kernel", [("config2", matmul_w8), ("config3", matmul_w8),
                                          ("config3_qlinear", matmul_q8)])
def test_baseline_configs_equal_jax(lm, name, kernel):
    jmodel, jparams, model, params = lm
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 512, (8, 16)).astype(np.int32)
    kw = config(name, ids)
    jq, jplan = joqt.quantize(jmodel, jparams, build(joqt, kw))
    q, plan = oqt.quantize(model, params, build(oqt, kw))
    assert [e.name for e in plan] == [e.name for e in jplan]
    assert len(plan) == 12
    for entry, jentry in zip(plan, jplan):
        assert entry.group_size == jentry.group_size
        if name != "config2":
            # A percentile from a histogram of float-noisy site inputs: within
            # one of its bins (the calibrators' own tests hold the rule bit-equal).
            for kind in ("input", "output"):
                np.testing.assert_allclose(getattr(entry, f"{kind}_scale").numpy(),
                                           np.asarray(getattr(jentry, f"{kind}_scale")),
                                           rtol=1e-3)
                assert int(getattr(entry, f"{kind}_zero_point")) == int(
                    getattr(jentry, f"{kind}_zero_point"))
        site, jsite = tree_get(q, entry.site.param_path), tree_get(jq, entry.site.param_path)
        w, jw = site["w"], jsite["w"]
        assert isinstance(w, QTensor)
        np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(w.zero_point.numpy(), np.asarray(jw.zero_point))
        np.testing.assert_allclose(w.scale.numpy(), np.asarray(jw.scale), rtol=1e-6)
        b, jb = site["b"], jsite["b"]
        assert isinstance(b, QBias) and type(jb).__name__ == "QBias"
        b_q, jb_q = b.data.numpy().astype(np.int64), np.asarray(jb.data).astype(np.int64)
        if name == "config3_qlinear":
            # int32 codes of b / (input scale * weight scale): equal on equal
            # scales, else within the scales' relative difference.
            rel = abs(float(entry.input_scale) / float(jentry.input_scale) - 1.0)
            assert np.all(np.abs(b_q - jb_q) <= np.ceil(np.abs(jb_q) * rel) + (rel > 0))
            if rel == 0.0:
                np.testing.assert_array_equal(b_q, jb_q)
        else:  # RTN codes in the weight dtype, from the bias alone
            np.testing.assert_array_equal(b_q, jb_q)
        # The route: a Hopper kernel takes the site, so it never raises on CUDA.
        x = torch.zeros((1, w.meta.shape[0]))
        assert select_kernel(x, w, b) is {matmul_w8: matmul_w8._w8_kernel_entry,
                                          matmul_q8: matmul_q8._q8_kernel_entry}[kernel]
    assert not isinstance(q["lm_head"]["w"], QTensor)

    # JAX's tree on the port: each site on JAX's own site inputs, then the model.
    ctx = JContext(taps={}, tap_inputs=True, tap_outputs=True)
    want = np.asarray(jmodel(jq, ids, ctx=ctx))
    bridged = from_jax_params(jq, device="cpu")
    for entry in jplan:
        site = tree_get(bridged, entry.site.param_path)
        x = torch.from_numpy(np.array(ctx.taps[entry.name]["input"]))
        y = np.asarray(ctx.taps[entry.name]["output"])
        with torch.no_grad():
            err = np.abs(quantized_matmul(x, site["w"], site["b"]).numpy() - y)
        off = err > 1e-5 * np.abs(y).max()
        assert off.mean() <= 1e-3, (entry.name, off.sum())
        if off.any():  # one output code step at a rounding tie
            step = float(site["w"].output_scale)
            assert err.max() <= 1.001 * step, (entry.name, err.max(), step)
    got = run(model, bridged, ids)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).mean() <= LOGIT_TOL * scale
    if kernel is matmul_q8:
        assert np.abs(got - want).max() <= 1e-5 * scale
    fp = run(model, params, ids)
    own = run(model, q, ids)
    rel = np.mean(np.abs(own - fp)) / np.mean(np.abs(fp))
    assert rel < 0.1, rel
