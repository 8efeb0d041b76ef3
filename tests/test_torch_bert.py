"""The port's BERT classifier against the JAX package's integration pins.

Counterpart of ``tests/integration/test_bert_classifier.py``: the synthetic
SST-2 task is the same numpy draw byte for byte; the float logits equal
JAX's within 1e-5 of the largest on JAX's params (bridged), padded
sentences included; for three configs of the grid (W8 and W4 weight-only,
static int8 inputs and outputs) both packages quantize JAX's trained params
to the same integer leaves and JAX's tree runs every site on JAX's own site
inputs to JAX's outputs on the port; one Adam step of the port's
trainer from JAX's init on JAX's first batch equals optax's step; the port's
own trainer reaches the fixture's accuracy band; and on JAX's trained params
(bridged) the port's float accuracy and all twelve quantized configs of the
JAX grid land on the JAX file's pins within its ``ATOL`` 0.008 (about three
of 512 sentences; ``tests/integration/test_bert_classifier.py:31-33``). The
calibration data is the JAX file's dict of ``input_ids``/``attention_mask``.
Every quantized site of the twelve trees has a Hopper kernel
(``select_kernel``), so none raises on CUDA.
"""

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.bert import BertClassifier as JBertClassifier
from onnx_quantize_tpu.models.bert import BertConfig as JBertConfig
from onnx_quantize_tpu.models.bert import _token_sentiment as jtoken_sentiment
from onnx_quantize_tpu.models.bert import synthetic_sst2 as jsynthetic_sst2
from onnx_quantize_tpu.models.bert import train_classifier as jtrain_classifier
from onnx_quantize_tpu.nn.module import Context as JContext
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.bert import (
    BertClassifier,
    BertConfig,
    _token_sentiment,
    _train_steps,
    accuracy,
    synthetic_sst2,
    train_classifier,
)
from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor
from onnx_quantize_tpu_torch.ops import quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import select_kernel
from onnx_quantize_tpu_torch.utils import tree_get

ATOL = 0.008  # tests/integration/test_bert_classifier.py:31
FP32_ACCURACY = 0.92578125  # :33

# name -> (QConfig keyword factory, pin): the JAX file's grid and pins
# (:45-59 weights only, :82-94 weights + inputs, :113-125 weights + inputs +
# outputs).


def _wo(**w):
    return lambda calib: dict(weights=oqt.QWeightArgs(**w))


def _act(w, a, sym, static, pre=None, outputs=False):
    def make(calib):
        kw = dict(weights=oqt.QWeightArgs(dtype=w, symmetric=sym, group_size=-1),
                  input_activations=oqt.QActivationArgs(dtype=a, is_static=static),
                  calibration_data=calib)
        if outputs:
            kw["output_activations"] = oqt.QActivationArgs(dtype=a, is_static=static)
        if pre == "sq":
            kw["preprocessors"] = [oqt.SmoothQuantConfig(alpha=0.5)]
        elif pre == "awq_clip":
            kw["preprocessors"] = [oqt.AwqConfig(clip_search=True)]
        elif pre == "awq":
            kw["preprocessors"] = [oqt.AwqConfig()]
        return kw
    return make


GRID = {
    "uint8_channel": (_wo(dtype="uint8", symmetric=False, group_size=-1), 0.92578125),
    "uint4_g128_rtn": (_wo(dtype="uint4", strategy="group", group_size=128), 0.921875),
    "uint4_g128_hqq": (_wo(dtype="uint4", strategy="group", group_size=128,
                           algorithm=oqt.HqqConfig(early_stop=False)), 0.921875),
    "int8_channel_awq": (lambda calib: dict(weights=oqt.QWeightArgs(dtype="int8", group_size=-1),
                                            preprocessors=[oqt.AwqConfig()],
                                            calibration_data=calib), 0.92578125),
    "w_uint8_a_uint8_dynamic": (_act("uint8", "uint8", False, False), 0.92578125),
    "w_uint8_a_uint8_static_sq": (_act("uint8", "uint8", False, True, "sq"), 0.92578125),
    "w_uint8_a_uint8_static_awq_clip": (_act("uint8", "uint8", False, True, "awq_clip"),
                                        0.92578125),
    "w_int8_a_int8_static_sym": (_act("int8", "int8", True, True), 0.92578125),
    "wio_uint8_dynamic": (_act("uint8", "uint8", False, False, outputs=True), 0.927734375),
    "wio_uint8_static_sq": (_act("uint8", "uint8", False, True, "sq", True), 0.92578125),
    "wio_uint8_static_awq": (_act("uint8", "uint8", False, True, "awq", True), 0.92578125),
    "wio_int8_static_sym": (_act("int8", "int8", True, True, outputs=True), 0.92578125),
}


@pytest.fixture(scope="module")
def jax_bert():
    """JAX's trained classifier (the JAX file's fixture)."""
    jmodel = JBertClassifier(JBertConfig())
    return jmodel, jtrain_classifier(jmodel)


@pytest.fixture(scope="module")
def bert(jax_bert):
    """JAX's trained classifier, bridged."""
    _, jparams = jax_bert
    model = BertClassifier(BertConfig())
    cfg = model.cfg
    eval_set = synthetic_sst2(512, cfg, seed=99)
    calib_ids, calib_mask, _ = synthetic_sst2(128, cfg, seed=41)
    calib = {"input_ids": calib_ids, "attention_mask": calib_mask}
    return model, from_jax_params(jparams, device="cpu"), eval_set, calib


def run(model, params, ids, mask, ctx=None):
    with torch.no_grad():
        return model(params, torch.from_numpy(ids), torch.from_numpy(mask), ctx=ctx).numpy()


def random_init(jmodel, seed: int) -> dict:
    """JAX's init with every bias, LayerNorm gain and LayerNorm shift drawn
    at random (init makes them 0 or 1), so the Gemm biases, the LayerNorms'
    eps and order, and the pooler all move the logits."""
    jparams = jmodel.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def draw(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                draw(leaf)
            elif leaf.ndim == 1:
                base = 1.0 if key == "w" else 0.0
                tree[key] = jax.numpy.asarray(
                    (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32))

    draw(jparams)
    return jparams


@pytest.mark.parametrize("which", ["random_init", "trained"])
def test_float_logits_equal_jax(jax_bert, which):
    """The float classifier's logits on 64 synthetic sentences (padded, so the
    mask counts) equal JAX's within 1e-5 of the largest."""
    jmodel, trained = jax_bert
    jparams = random_init(jmodel, 5) if which == "random_init" else trained
    ids, mask, _ = synthetic_sst2(64, BertConfig(), seed=7)
    assert (mask == 0).any() and (mask == 1).any()
    want = np.asarray(jmodel(jparams, ids, mask))
    got = run(BertClassifier(BertConfig()), from_jax_params(jparams, device="cpu"), ids, mask)
    assert got.shape == want.shape == (64, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# The grid configs held leaf by leaf and site by site: W8 and W4 weight-only
# and the static int8 inputs and outputs (its weights are int8 symmetric).
SITE_GRID = {
    "uint8_channel": dict(weights=dict(dtype="uint8", symmetric=False, group_size=-1)),
    "uint4_g128_rtn": dict(weights=dict(dtype="uint4", strategy="group", group_size=128)),
    "wio_int8_static_sym": dict(weights=dict(dtype="int8", symmetric=True, group_size=-1),
                                input_activations=dict(dtype="int8", is_static=True),
                                output_activations=dict(dtype="int8", is_static=True)),
}


def build(pkg, kw, calib):
    kw = dict(kw)
    kw["weights"] = pkg.QWeightArgs(**kw["weights"])
    for key in ("input_activations", "output_activations"):
        if key in kw:
            kw[key] = pkg.QActivationArgs(**kw[key])
            kw["calibration_data"] = calib
    return pkg.QConfig(**kw)


@pytest.mark.parametrize("name", list(SITE_GRID))
def test_quantized_trees_and_sites_equal_jax(jax_bert, bert, name):
    """Both packages quantize JAX's trained params alike: the plans agree,
    every QTensor's and QBias's integer leaves are equal and the calibrated
    scales agree within float noise (rtol 1e-4, the site inputs' last bits).
    JAX's tree, bridged, runs each site on JAX's own site inputs to JAX's
    outputs within 1e-5 of the largest (but for an output code at a rounding
    tie, one code step off), and the whole classifier to JAX's logits:
    weight-only within 1e-5 of the largest at every logit, with activation
    QDQ within 1e-3 of it on average (a code flipped at a tie moves single
    logits further)."""
    jmodel, jparams = jax_bert
    model, params, _, calib = bert
    kw = SITE_GRID[name]
    jq, jplan = joqt.quantize(jmodel, jparams, build(joqt, kw, calib))
    q, plan = oqt.quantize(model, params, build(oqt, kw, calib))
    assert [e.name for e in plan] == [e.name for e in jplan]
    assert len(plan) == 6 * model.cfg.num_layers + 2
    static = "input_activations" in kw
    for entry, jentry in zip(plan, jplan):
        assert entry.group_size == jentry.group_size
        if static:
            for kind in ("input", "output"):
                np.testing.assert_allclose(getattr(entry, f"{kind}_scale").numpy(),
                                           np.asarray(getattr(jentry, f"{kind}_scale")),
                                           rtol=1e-4)
                assert int(getattr(entry, f"{kind}_zero_point")) == int(
                    getattr(jentry, f"{kind}_zero_point"))
        site, jsite = tree_get(q, entry.site.param_path), tree_get(jq, entry.site.param_path)
        w, jw = site["w"], jsite["w"]
        assert isinstance(w, QTensor)
        np.testing.assert_array_equal(w.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(w.zero_point.numpy(), np.asarray(jw.zero_point))
        np.testing.assert_allclose(w.scale.numpy(), np.asarray(jw.scale), rtol=1e-6)
        b, jb = site["b"], jsite["b"]
        if isinstance(b, QBias):
            assert type(jb).__name__ == "QBias"
            np.testing.assert_array_equal(b.data.numpy(), np.asarray(jb.data))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))

    ids, mask, _ = synthetic_sst2(64, BertConfig(), seed=7)
    ctx = JContext(taps={}, tap_inputs=True, tap_outputs=True)
    want = np.asarray(jmodel(jq, ids, mask, ctx=ctx))
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
            assert static, (entry.name, err.max())
            step = float(site["w"].output_scale)
            assert err.max() <= 1.001 * step, (entry.name, err.max(), step)
    got = run(model, bridged, ids, mask)
    scale = np.abs(want).max()
    if static:
        assert np.abs(got - want).mean() <= 1e-3 * scale
    else:
        assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("n, seed", [(8, 17), (64, 23), (512, 99), (128, 41)])
def test_synthetic_sst2_equals_jax(n, seed):
    ours = synthetic_sst2(n, BertConfig(), seed=seed)
    theirs = jsynthetic_sst2(n, JBertConfig(), seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for vocab in (512, 30522):
        assert _token_sentiment(vocab).tobytes() == jtoken_sentiment(vocab).tobytes()


def test_one_adam_step_equals_optax():
    """From JAX's init (seed 23) on its first batch of 64: the port's step
    equals ``train_classifier(steps=1)`` of the JAX package within 1e-5 on
    all but 1e-4 of the elements, and within 1e-4 on every one. Adam's
    first update is ``lr * g / (|g| + eps)``: where |g| is within a few eps,
    the two frameworks' last-bit gradient differences move it by up to ~1e-4
    (three of 600k elements here). The k_proj biases are held apart: their
    gradient is zero in exact arithmetic (a bias on every key shifts a softmax
    row by a constant), so both sides hold rounding noise there, which the
    step scales to at most lr either way."""
    jmodel = JBertClassifier(JBertConfig())
    init = from_jax_params(jmodel.init(jax.random.key(23)), device="cpu")
    want = from_jax_params(jtrain_classifier(jmodel, steps=1), device="cpu")
    ids, mask, labels = synthetic_sst2(64, BertConfig(), seed=23)
    got = _train_steps(BertClassifier(BertConfig()), init, ids, mask, labels, steps=1,
                       batch_size=64, lr=3e-4)
    moved = 0
    for i in range(2):
        for key in ("q_proj", "v_proj", "o_proj"):
            moved += int((got[f"layer.{i}"]["attn"][key]["w"]
                          != init[f"layer.{i}"]["attn"][key]["w"]).sum())
    assert moved > 0

    counts = [0, 0]  # elements off 1e-5, elements compared

    def compare(a, b, c, path=()):
        if isinstance(a, dict):
            for k in a:
                compare(a[k], b[k], c[k], path + (k,))
            return
        if path[-2:] == ("k_proj", "b"):
            assert (a - c).abs().max() <= 3e-4 * 1.01 and (b - c).abs().max() <= 3e-4 * 1.01
            return
        err = (a - b).abs()
        assert err.max().item() <= 1e-4, path
        counts[0] += int((err > 1e-5).sum())
        counts[1] += err.numel()

    compare(got, want, init)
    assert counts[0] <= 1e-4 * counts[1], counts


def test_port_trainer_reaches_the_fixture_band():
    model = BertClassifier(BertConfig())
    params = train_classifier(model, device="cpu")
    ids, mask, labels = synthetic_sst2(512, model.cfg, seed=99)
    assert 0.90 <= accuracy(model, params, ids, mask, labels) <= 0.95


def test_fp32_accuracy_pin(bert):
    model, params, (ids, mask, labels), _ = bert
    assert accuracy(model, params, ids, mask, labels) == pytest.approx(FP32_ACCURACY, abs=ATOL)


@pytest.mark.parametrize("name", list(GRID))
def test_quantized_accuracy_pins(bert, name):
    model, params, (ids, mask, labels), calib = bert
    make, pin = GRID[name]
    qparams, plan = oqt.quantize(model, params, oqt.QConfig(**make(calib)))
    assert len(plan) == 6 * model.cfg.num_layers + 2
    for entry in plan:  # every site has a Hopper kernel
        site = tree_get(qparams, entry.site.param_path)
        assert isinstance(site["w"], QTensor)
        x = torch.zeros((1, site["w"].meta.shape[0]))
        assert select_kernel(x, site["w"], site.get("b")) is not None, entry.name
    acc = accuracy(model, qparams, ids, mask, labels)
    assert acc == pytest.approx(pin, abs=ATOL), f"{name}: accuracy {acc:.4f}, pin {pin}"
