"""The MoE family in the port (``models/moe.py``, ``Gemma3MoEMLP``), held to
the JAX package.

Counterpart of ``tests/models/test_moe.py``, every case but
``test_speculative_decoding_with_moe_target`` (which
``tests/test_torch_speculative.py`` holds), plus: routing ties, the three
layouts and the ragged prefill against JAX's own, the layouts' refusals, the
engine against JAX's ``InferenceEngine``, ``prepare_kernel_scales`` over
stacked leaves, and the bridge of JAX's stacked and fused trees.

The same numpy inputs and JAX's own params (bridged with
``from_jax_params``) go through both packages on the CPU. Tolerances: float32
outputs within 1e-5 abs of JAX's (both sum in float32 in another order;
logits here are below 1), quantized codes and routing choices equal, greedy
tokens equal; where the port is compared with itself across layouts the
JAX test's own tolerance stands beside the case.
"""

import dataclasses
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.engine import InferenceEngine as JEngine
from onnx_quantize_tpu.engine.engine import prepare_kernel_scales as jprepare
from onnx_quantize_tpu.models import moe as jmoe
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.nn.module import Context as JContext
from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models import gemma3, moe
from onnx_quantize_tpu_torch.models.gemma3 import (
    Gemma3,
    Gemma3MoEMLP,
    fuse_gemma3_projections,
    top_k_lower_index,
)
from onnx_quantize_tpu_torch.models.moe import (
    _concat_k_sites,
    fuse_moe_experts,
    stack_moe_experts,
    tiny_moe_config,
)
from onnx_quantize_tpu_torch.nn.module import Context
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QTensor
from onnx_quantize_tpu_torch.ops.kernels import mlp_w4
from onnx_quantize_tpu_torch.utils import tree_map

torch.set_num_threads(1)

ATOL = 1e-5
IGNORE = [r"\.router$", r"\.shared_gate$"]


def _pair(seed=0, **kw):
    """(port model, bridged params, JAX model, JAX params) on JAX's init."""
    jmodel = JGemma3(jmoe.tiny_moe_config(**kw))
    jparams = jmodel.init(jax.random.key(seed))
    return Gemma3(tiny_moe_config(**kw)), from_jax_params(jparams, device="cpu"), jmodel, jparams


def _ids(rng, batch=2, seq=8, vocab=256):
    return rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)


def _run(model, params, ids):
    return model(params, torch.from_numpy(ids).long()).numpy()


def _w4(**extra):
    return dict(weights=dict(dtype="uint4", group_size=16), ignore=IGNORE, **extra)


def _quantize_both(model, params, jmodel, jparams, weights, ignore=IGNORE, **kw):
    """The same QConfig through both packages (``kw`` already built per package
    by the caller when it holds objects)."""
    q, _ = oqt.quantize(model, params, oqt.QConfig(weights=oqt.QWeightArgs(**weights),
                                                   ignore=ignore, **kw))
    jq, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(weights=joqt.QWeightArgs(**weights),
                                                        ignore=ignore, **kw))
    return q, jq


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _assert_bit_equal(a, b):
    """Equal trees, key by key (JAX's tree maps sort dict keys), bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for key in a:
            _assert_bit_equal(a[key], b[key])
        return
    assert type(a) is type(b)
    if isinstance(a, QTensor):
        assert a.meta == b.meta
        for f in ("data", "scale", "zero_point", "input_scale", "input_zero_point"):
            s, t = getattr(a, f), getattr(b, f)
            assert (s is None) == (t is None)
            if s is not None:
                assert s.dtype == t.dtype and torch.equal(s, t), f
    elif a is not None:
        assert torch.equal(a, b)


def _moe_oracle(cfg, router_w, experts_fn, x):
    """Per-token routing oracle: gather, compute, weighted sum (numpy)."""
    logits = x @ router_w
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    flat_x, flat_p, flat_o = (x.reshape(-1, x.shape[-1]), probs.reshape(-1, cfg.num_experts),
                              out.reshape(-1, x.shape[-1]))
    for t in range(flat_x.shape[0]):
        top = np.argsort(-flat_p[t], kind="stable")[: cfg.num_experts_per_tok]
        w = flat_p[t, top]
        if cfg.norm_topk_prob:
            w = w / w.sum()
        for e, we in zip(top, w):
            flat_o[t] += we * experts_fn(int(e), flat_x[t:t + 1])[0]
    return out


# -- routing -----------------------------------------------------------------------

@pytest.mark.parametrize("norm", [True, False], ids=["norm_topk", "no_norm_topk"])
def test_combine_matches_per_token_oracle_and_jax(norm):
    """The dense-masked MLP equals the per-token oracle (JAX's test) and JAX's
    MLP on the same params and input; with ``norm_topk_prob=False`` (Qwen)
    the combine weights are the raw softmax probabilities."""
    model, params, jmodel, jparams = _pair(norm_topk_prob=norm)
    mlp, jmlp = model.layers[0].mlp, jmodel.blocks[0].mlp
    mp, jmp = params["layers.0"]["mlp"], jparams["layers.0"]["mlp"]
    x = np.random.default_rng(0).standard_normal((2, 5, model.cfg.hidden_size)).astype(np.float32)

    def expert_fn(e, xe):
        return mlp.experts[e](mp[f"experts.{e}"], torch.from_numpy(xe)).numpy()

    got = mlp(mp, torch.from_numpy(x)).numpy()
    want = _moe_oracle(model.cfg, mp["router"]["w"].numpy(), expert_fn, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jmlp(jmp, jnp.asarray(x))), atol=ATOL, rtol=0)


def test_shared_expert_sigmoid_gate():
    """out = routed experts + sigmoid(x @ w_gate) * shared(x), as in JAX."""
    model, params, jmodel, jparams = _pair(shared_expert_size=48)
    mlp, mp = model.layers[0].mlp, params["layers.0"]["mlp"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, model.cfg.hidden_size)).astype(np.float32))
    got = mlp(mp, x)
    routed = Gemma3(tiny_moe_config()).layers[0].mlp(
        {k: v for k, v in mp.items() if k not in ("shared", "shared_gate")}, x)
    gate = torch.sigmoid(x @ mp["shared_gate"]["w"])
    want = routed + gate * mlp.shared(mp["shared"], x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    jgot = jmodel.blocks[0].mlp(jparams["layers.0"]["mlp"], jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_top_k_lower_index_is_jax_top_k(k):
    """Values from a small set tie often: indices and values equal to
    ``jax.lax.top_k``'s (descending, the lower index first on ties)."""
    vals = np.random.default_rng(k).integers(0, 5, (64, 12)).astype(np.float32)
    got_v, got_i = top_k_lower_index(torch.from_numpy(vals), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(vals), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("tie", ["zero_router", "duplicate_columns"])
def test_routing_ties_match_jax(tie):
    """Exactly tied router logits (a zero router: all tied; experts 1 and 3
    given expert 0's column): the port picks JAX's experts in JAX's order,
    with JAX's weights and combine weights."""
    model, params, jmodel, jparams = _pair(num_experts=6, num_experts_per_tok=3)
    w = np.asarray(jparams["layers.0"]["mlp"]["router"]["w"]).copy()
    if tie == "zero_router":
        w[:] = 0.0
    else:
        w[:, 1] = w[:, 0]
        w[:, 3] = w[:, 0]
    jmp = {**jparams["layers.0"]["mlp"], "router": {"w": jnp.asarray(w)}}
    mp = {**params["layers.0"]["mlp"], "router": {"w": torch.from_numpy(w)}}
    x = np.random.default_rng(2).standard_normal((4, 6, model.cfg.hidden_size)).astype(
        np.float32)
    mlp, jmlp = model.layers[0].mlp, jmodel.blocks[0].mlp
    top_p, top_i = mlp._routing(mp, torch.from_numpy(x))
    jtop_p, jtop_i = jmlp._routing(jmp, jnp.asarray(x), None)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6, rtol=0)
    combine = mlp._combine_weights(top_p, top_i, 6).numpy()
    jcombine = np.asarray(jmlp._combine_weights(jtop_p, jtop_i, 6))
    np.testing.assert_allclose(combine, jcombine, atol=1e-6, rtol=0)
    if tie == "zero_router":
        assert (top_i.numpy() == [0, 1, 2]).all()
    np.testing.assert_allclose(mlp(mp, torch.from_numpy(x)).numpy(),
                               np.asarray(jmlp(jmp, jnp.asarray(x))), atol=ATOL, rtol=0)


# -- structure ---------------------------------------------------------------------

def test_sites_discovered_in_jax_order():
    model, params, jmodel, jparams = _pair(shared_expert_size=48)
    names = [s.name for s in model.linear_sites()]
    assert names == [s.name for s in jmodel.linear_sites()]
    for e in range(model.cfg.num_experts):
        for proj in ("gate_proj", "up_proj", "down_proj"):
            assert f"layers.0.mlp.experts.{e}.{proj}" in names
    assert {"layers.0.mlp.router", "layers.0.mlp.shared.gate_proj",
            "layers.0.mlp.shared_gate"} <= set(names)
    init = model.init(torch.Generator().manual_seed(0))
    assert _leaves_paths(init) == _leaves_paths(params)


def _leaves_paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaves_paths(v, path + (k,))]
    return [(path, tuple(tree.shape))]


@pytest.mark.parametrize("name", ["QWEN15_MOE_A27B", "MIXTRAL_8X7B"])
def test_published_configs_equal_jax(name):
    assert dataclasses.asdict(getattr(moe, name)) == dataclasses.asdict(getattr(jmoe, name))


@pytest.mark.parametrize("loader", ["load_qwen_moe_hf", "load_mixtral_hf"])
def test_hf_loaders_wait_for_import_hf(loader, tmp_path):
    """The loaders read through ``models/import_hf.py`` (ported): a directory
    with no shard raises the JAX loader's error (``tests/test_torch_moe_hf.py``
    holds them to HF's logits)."""
    with pytest.raises(FileNotFoundError, match="No .safetensors"):
        getattr(moe, loader)(Gemma3(tiny_moe_config()), str(tmp_path), device="cpu")


# -- quantization and the engine layouts ----------------------------------------------

@pytest.mark.parametrize("dtype,group", [("uint4", 16), ("int8", -1)])
def test_quantized_close_to_fp(dtype, group):
    model, params, jmodel, jparams = _pair()
    weights = dict(dtype=dtype, group_size=group if group > 0 else None,
                   strategy=None if group > 0 else "channel")
    q, jq = _quantize_both(model, params, jmodel, jparams, weights, ignore=[r"\.router$"])
    ids = _ids(np.random.default_rng(3))
    fp, got = _run(model, params, ids), _run(model, q, ids)
    assert np.isfinite(got).all()
    rel = np.abs(got - fp).mean() / (np.abs(fp).mean() + 1e-9)
    assert rel < (0.5 if dtype == "uint4" else 0.1)
    _assert_bit_equal(q, from_jax_params(jq, device="cpu"))
    np.testing.assert_allclose(got, np.asarray(jmodel(jq, ids)), atol=ATOL, rtol=0)


def _w4_pair(**kw):
    model, params, jmodel, jparams = _pair(**kw)
    q, jq = _quantize_both(model, params, jmodel, jparams, dict(dtype="uint4", group_size=16))
    return model, q, jmodel, jq


def test_fuse_and_stack_are_exact():
    """Fusing gate/up in every expert and the shared expert, then stacking:
    the same outputs (the stack bit for bit), and JAX's stacked tree's."""
    model, q, jmodel, jq = _w4_pair(shared_expert_size=48)
    ids = _ids(np.random.default_rng(4))
    base = _run(model, q, ids)
    fused = fuse_gemma3_projections(q)
    assert "_fused_gate_up" in fused["layers.0"]["mlp"]["experts.0"]
    assert "_fused_gate_up" in fused["layers.0"]["mlp"]["shared"]
    stacked = stack_moe_experts(fused)
    mlp = stacked["layers.0"]["mlp"]
    assert "_stacked_experts" in mlp and "experts.0" not in mlp
    gu = mlp["_stacked_experts"]["gate_up"]["w"]
    assert gu.data.shape[0] == model.cfg.num_experts and gu.meta.shape == (64, 192)
    # The fused gate|up matmul sums in another BLAS blocking than the two
    # halves on the CPU (float32 last bits); stacking changes no arithmetic.
    np.testing.assert_allclose(_run(model, fused, ids), base, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_run(model, stacked, ids), _run(model, fused, ids))
    np.testing.assert_allclose(base, np.asarray(jmodel(jmoe.stack_moe_experts(jfuse(jq)), ids)),
                               atol=ATOL, rtol=0)


def test_stack_unfused_fp():
    """Stacking also serves unfused float experts (gate/up/down entries)."""
    model, params, jmodel, jparams = _pair()
    ids = _ids(np.random.default_rng(5))
    stacked = stack_moe_experts(params)
    assert set(stacked["layers.0"]["mlp"]["_stacked_experts"]) == {"gate", "up", "down"}
    np.testing.assert_allclose(_run(model, stacked, ids), _run(model, params, ids), atol=1e-6)
    _assert_bit_equal(stacked, from_jax_params(jmoe.stack_moe_experts(jparams), device="cpu"))


def test_fused_experts_layout_matches_loop():
    """One fat-N gate_up and one deep-K down with the combine folded into the
    accumulator: the loop's output within float32 reduction order (1e-5, the
    JAX test's), and JAX's fused layout on the same tree."""
    model, q, jmodel, jq = _w4_pair(shared_expert_size=48)
    gfused = fuse_gemma3_projections(q)
    ids = _ids(np.random.default_rng(6))
    base = _run(model, gfused, ids)
    efused = fuse_moe_experts(gfused)
    mlp = efused["layers.0"]["mlp"]
    assert "_fused_experts" in mlp and "experts.0" not in mlp
    cfg = model.cfg
    inter = cfg.moe_intermediate_size
    assert mlp["_fused_experts"]["gate_up"]["w"].meta.shape == (
        cfg.hidden_size, cfg.num_experts * 2 * inter)
    assert mlp["_fused_experts"]["down"]["w"].meta.shape == (
        cfg.num_experts * inter, cfg.hidden_size)
    out = _run(model, efused, ids)
    np.testing.assert_allclose(out, base, atol=1e-5, rtol=1e-5)
    jtree = jmoe.fuse_moe_experts(jfuse(jq))
    _assert_bit_equal(efused, from_jax_params(jtree, device="cpu"))
    np.testing.assert_allclose(out, np.asarray(jmodel(jtree, ids)), atol=ATOL, rtol=0)


def test_fused_experts_fp():
    model, params, jmodel, jparams = _pair()
    ids = _ids(np.random.default_rng(7))
    efused = fuse_moe_experts(fuse_gemma3_projections(params))
    assert "_fused_experts" in efused["layers.0"]["mlp"]
    np.testing.assert_allclose(_run(model, efused, ids), _run(model, params, ids), atol=1e-5,
                               rtol=1e-5)


def test_fuse_experts_skipped_with_prescale():
    """AWQ's prescales make the experts' gate/up unfusable: the transform
    keeps the loop layout instead of mis-fusing, as JAX's does."""
    model, params, jmodel, jparams = _pair()
    data = _ids(np.random.default_rng(8), batch=4, seq=8)
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        preprocessors=[oqt.AwqConfig()], ignore=[r"\.router$"], calibration_data=data,
        calibration_params=oqt.CalibrationParams(num_samples=4, batch_size=2)))
    assert "prescale" in q["layers.0"]["mlp"]["experts.0"]["gate_proj"]
    efused = fuse_moe_experts(fuse_gemma3_projections(q))
    mlp = efused["layers.0"]["mlp"]
    assert "_fused_experts" not in mlp and "experts.0" in mlp
    ids = _ids(np.random.default_rng(9))
    np.testing.assert_array_equal(_run(model, efused, ids), _run(model, q, ids))


@pytest.mark.parametrize("gs,fused", [(32, False), (16, True)], ids=["g32_odd", "g16_even"])
def test_fuse_keeps_loop_on_odd_group_count(gs, fused):
    """moe_intermediate_size 96 at g32 is 3 groups a down_proj: the pair
    packing cannot concatenate along K, so every layer keeps the loop layout
    (JAX too); at g16 (6 groups) every layer fuses."""
    model, params, jmodel, jparams = _pair()
    q, jq = _quantize_both(model, params, jmodel, jparams, dict(dtype="uint4", group_size=gs))
    tree, jtree = fuse_moe_experts(fuse_gemma3_projections(q)), jmoe.fuse_moe_experts(jfuse(jq))
    for i in range(model.cfg.num_layers):
        mlp, jmlp = tree[f"layers.{i}"]["mlp"], jtree[f"layers.{i}"]["mlp"]
        assert ("_fused_experts" in mlp) is fused and ("_fused_experts" in jmlp) is fused
    with pytest.raises(ValueError, match="even multiple") if not fused else nullcontext():
        _concat_k_sites([fuse_gemma3_projections(q)["layers.0"]["mlp"][f"experts.{e}"][
            "down_proj"] for e in range(4)])


def _down_sites(q):
    return [q["layers.0"]["mlp"][f"experts.{e}"]["down_proj"] for e in range(4)]


@pytest.mark.parametrize("refusal", ["bias", "channel", "output_quant", "dynamic_input",
                                     "static_scales_differ", "mismatch"])
def test_concat_k_refusals(refusal):
    """Each of ``_concat_k_sites``' refusals raises (so ``fuse_moe_experts``
    keeps that layer's loop), as JAX's does."""
    model, params, *_ = _pair()
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16), ignore=IGNORE))
    sites = [dict(s) for s in _down_sites(q)]
    w = sites[0]["w"]
    if refusal == "bias":
        sites[0]["b"] = torch.zeros(64)
        match = "bare weights"
    elif refusal == "channel":
        qc, _ = oqt.quantize(model, params, oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", strategy="channel"), ignore=IGNORE))
        sites = [dict(s) for s in _down_sites(qc)]
        match = "GROUP strategy"
    elif refusal in ("output_quant", "dynamic_input"):
        field = "output_quant" if refusal == "output_quant" else "input_quant"
        mode = "static" if refusal == "output_quant" else "dynamic"
        for s in sites:
            s["w"] = dataclasses.replace(s["w"], meta=dataclasses.replace(
                s["w"].meta, **{field: ActQuantSpec(mode=mode)}))
        match = "output quantization" if refusal == "output_quant" else "dynamic input"
    elif refusal == "static_scales_differ":
        for i, s in enumerate(sites):
            s["w"] = dataclasses.replace(s["w"], input_scale=torch.tensor(0.1 + 0.01 * i))
        match = "static input scales differ"
    else:
        sites[1]["w"] = dataclasses.replace(sites[1]["w"], meta=dataclasses.replace(
            w.meta, symmetric=not w.meta.symmetric))
        match = "quantized identically"
    with pytest.raises(ValueError, match=match):
        _concat_k_sites(sites)


@pytest.mark.parametrize("layout,weights", [
    ("stack", dict(dtype="uint4", group_size=16)), ("fuse", dict(dtype="uint4", group_size=16)),
    ("stack", dict(dtype="int8", strategy="tensor"))],
    ids=["stack_w4", "fuse_w4", "stack_int8_tensor"])
def test_ragged_prefill_matches_loop(layout, weights):
    """The sorted grouped matmuls (forced on) match the dense-masked loop from
    the stacked and from the fused layout (the JAX test's 2e-5), and JAX's
    ragged path on the same tree (per-tensor scales: dequantized expert by
    expert); one host fetch a layer a forward."""
    model, params, jmodel, jparams = _pair()
    q, jq = _quantize_both(model, params, jmodel, jparams, weights)
    gfused, jgfused = fuse_gemma3_projections(q), jfuse(jq)
    ids = _ids(np.random.default_rng(10), batch=4, seq=16)
    base = _run(model, gfused, ids)
    transform = stack_moe_experts if layout == "stack" else fuse_moe_experts
    jtransform = jmoe.stack_moe_experts if layout == "stack" else jmoe.fuse_moe_experts
    for blocks in (model.layers, jmodel.blocks):
        for block in blocks:
            block.mlp.use_ragged_prefill = True
    try:
        out = _run(model, transform(gfused), ids)
        jout = np.asarray(jmodel(jtransform(jgfused), ids))
    finally:
        for block in jmodel.blocks:
            block.mlp.use_ragged_prefill = "auto"
    np.testing.assert_allclose(out, base, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    assert [b.mlp.host_fetches for b in model.layers] == [1, 1]


def test_ragged_auto_gate():
    """"auto" is off on the CPU at any M (JAX's is off any TPU); on CUDA it
    takes a forward of more than one token a row from ``RAGGED_MIN_M`` rows
    on (stacked and fused sources apart), never a decode step (one token a
    row) at any batch; True forces it, False and an activation-quantized
    layout refuse it."""
    model, params, *_ = _pair()
    mlp = model.layers[0].mlp
    layout = {"gate_up": {"w": params["layers.0"]["mlp"]["experts.0"]["gate_proj"]["w"]}}
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    d = model.cfg.hidden_size
    for fused in (False, True):
        least = gemma3.RAGGED_MIN_M["fused" if fused else "stacked"]
        assert not mlp._ragged_ok(layout, (1 << 10, 1 << 10, d), cpu, fused_source=fused)
        assert mlp._ragged_ok(layout, (1, least, d), cuda, fused_source=fused)
        assert mlp._ragged_ok(layout, (least // 2, 2, d), cuda, fused_source=fused)
        assert not mlp._ragged_ok(layout, (1, least - 1, d), cuda, fused_source=fused)
        assert not mlp._ragged_ok(layout, (1 << 12, 1, d), cuda, fused_source=fused)
    mlp.use_ragged_prefill = True
    assert mlp._ragged_ok(layout, (1, 1, d), cpu, fused_source=True)
    mlp.use_ragged_prefill = False
    assert not mlp._ragged_ok(layout, (1, 1 << 20, d), cuda)
    assert not mlp._ragged_ok(None, (1, 1 << 20, d), cuda)


def test_serve_chunk_turns_auto_ragged_off():
    """``serve_chunk``'s admissions run with every "auto" MoE layer's ragged
    prefill off (the round has no host sync), a forced True kept; "auto" is
    back after the round."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.engine.sampling import SamplingParams, batch_sampling_arrays

    model, params, *_ = _pair()
    engine = InferenceEngine(model, params, max_batch=2, max_seq=16)
    model.layers[1].mlp.use_ragged_prefill = True
    seen = []
    forward = model.hidden_states

    def spy(*args, **kwargs):
        seen.append([b.mlp.use_ragged_prefill for b in model.layers])
        return forward(*args, **kwargs)

    model.hidden_states = spy
    try:
        arrays, variant = batch_sampling_arrays([SamplingParams()] * 2)
        engine.serve_chunk(engine.new_cache(), np.zeros(2, np.int32), 2, eos=np.full(2, -1),
                           sampling_arrays=arrays, variant=variant, active=np.zeros(2, bool),
                           budgets=np.full(2, 4), admit_ids=_ids(np.random.default_rng(13), 2, 8),
                           admit_lengths=np.full(2, 8), admit_mask=np.ones(2, bool))
    finally:
        del model.hidden_states
    assert seen[0] == [False, True]
    assert [b.mlp.use_ragged_prefill for b in model.layers] == ["auto", True]


def test_ragged_falls_back_on_act_quant():
    """Static int8 activations: the layout is not ragged-compatible, and forcing
    the ragged path keeps the dense-masked one (equal outputs)."""
    model, params, *_ = _pair()
    data = _ids(np.random.default_rng(11), batch=4, seq=8)
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", strategy="channel"),
        input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
        calibration_data=data,
        calibration_params=oqt.CalibrationParams(num_samples=4, batch_size=2),
        ignore=[r"\.router$"]))
    stacked = stack_moe_experts(fuse_gemma3_projections(q))
    assert not Gemma3MoEMLP._ragged_compatible(stacked["layers.0"]["mlp"]["_stacked_experts"])
    ids = _ids(np.random.default_rng(12), batch=4, seq=16)
    base = _run(model, stacked, ids)
    for block in model.layers:
        block.mlp.use_ragged_prefill = True
    np.testing.assert_array_equal(_run(model, stacked, ids), base)
    assert all(b.mlp.host_fetches == 0 for b in model.layers)


def test_stack_rejects_mismatched_quantization():
    model, params, *_ = _pair()
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16),
        ignore=[r"\.router$", r"experts\.[123]\."]))  # one expert quantized
    with pytest.raises(ValueError, match="quantized identically|mix quantized"):
        stack_moe_experts(q)


def test_prepare_kernel_scales_then_stack_gives_jax_leaves():
    """Bake, then stack (the engine order): JAX's leaves bit for bit, each
    expert's view in the baked (G_pad/2, 2, N) layout; baking a stacked tree
    (stacked before or after baking) changes no stacked leaf; the model over
    either tree gives the loop's logits."""
    model, q, jmodel, jq = _w4_pair(shared_expert_size=48)
    baked = prepare_kernel_scales(fuse_gemma3_projections(q))
    stacked = stack_moe_experts(baked)
    jstacked = from_jax_params(jmoe.stack_moe_experts(jprepare(jfuse(jq))), device="cpu")
    # JAX's meta has no float_zero_point: the bridge reads it off the zero
    # point's dtype, which baking makes float32 for integer zero points too.
    jstacked = tree_map(lambda leaf: dataclasses.replace(leaf, meta=dataclasses.replace(
        leaf.meta, float_zero_point=False)) if isinstance(leaf, QTensor) else leaf, jstacked)
    _assert_bit_equal(stacked, jstacked)
    gu = stacked["layers.0"]["mlp"]["_stacked_experts"]["gate_up"]["w"]
    assert gu.scale.shape == (4, 2, 2, 192)
    assert gemma3._expert_slice({"w": gu}, 2)["w"].scale.shape == (2, 2, 192)
    unbaked_stack = stack_moe_experts(fuse_gemma3_projections(q))
    for tree in (stacked, unbaked_stack):
        again = prepare_kernel_scales(tree)
        for i in range(model.cfg.num_layers):
            _assert_bit_equal(again[f"layers.{i}"]["mlp"]["_stacked_experts"],
                              tree[f"layers.{i}"]["mlp"]["_stacked_experts"])
    _assert_bit_equal(prepare_kernel_scales(stacked), stacked)
    ids = _ids(np.random.default_rng(13))
    want = _run(model, fuse_gemma3_projections(q), ids)
    np.testing.assert_allclose(_run(model, stacked, ids), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_run(model, unbaked_stack, ids), want, atol=1e-6, rtol=0)


def test_from_jax_params_bridges_stacked_and_fused_trees():
    """JAX's stacked and fused trees of a W4 model bridge into the port's own
    transforms of the bridged tree, leaf for leaf."""
    model, q, jmodel, jq = _w4_pair(shared_expert_size=48)
    gf, jgf = fuse_gemma3_projections(q), jfuse(jq)
    for ours, theirs in ((stack_moe_experts, jmoe.stack_moe_experts),
                         (fuse_moe_experts, jmoe.fuse_moe_experts)):
        _assert_bit_equal(from_jax_params(theirs(jgf), device="cpu"), ours(gf))


# -- calibration and algorithms ----------------------------------------------------

def test_expert_taps_see_only_routed_tokens():
    """The dense-masked loop zeroes unrouted rows before an expert's sites:
    its tapped input is exactly its routed rows (what GPTQ's Hessian and
    SmoothQuant's maxima read), and equals JAX's tap."""
    model, params, jmodel, jparams = _pair()
    ids = _ids(np.random.default_rng(14), batch=1, seq=6)
    ctx = Context(taps={}, tap_inputs=True)
    model(params, torch.from_numpy(ids).long(), ctx=ctx)
    jctx = JContext(taps={}, tap_inputs=True)
    jmodel(jparams, ids, ctx=jctx)
    mlp, mp = model.layers[0].mlp, params["layers.0"]["mlp"]
    top_p, top_i = mlp._routing(mp, ctx.taps["layers.0.mlp.router"]["input"])
    combine = mlp._combine_weights(top_p, top_i, model.cfg.num_experts).numpy()
    for e in range(model.cfg.num_experts):
        name = f"layers.0.mlp.experts.{e}.gate_proj"
        tap = ctx.taps[name]["input"].numpy()
        unrouted = combine[..., e] == 0
        assert (tap[unrouted] == 0).all(), f"expert {e} gate tap leaks unrouted tokens"
        if (~unrouted).any():
            assert np.abs(tap[~unrouted]).max() > 0
        np.testing.assert_allclose(tap, np.asarray(jctx.taps[name]["input"]), atol=ATOL, rtol=0)


def test_gptq_on_moe_experts():
    """GPTQ over the experts (each Hessian over its routed rows only): finite,
    no worse than 1.5x RTN's output error (JAX's bar), and its codes JAX's
    but for float32 ties (at most 1%)."""
    model, params, jmodel, jparams = _pair()
    data = _ids(np.random.default_rng(15), batch=4, seq=8)
    ids = _ids(np.random.default_rng(16))
    fp = _run(model, params, ids)

    def run(pkg, mdl, prm, algorithm):
        q, _ = pkg.quantize(mdl, prm, pkg.QConfig(
            weights=pkg.QWeightArgs(dtype="uint4", group_size=16, algorithm=algorithm),
            ignore=[r"\.router$"], calibration_data=data,
            calibration_params=pkg.CalibrationParams(num_samples=4, batch_size=2)))
        return q

    q_gptq = run(oqt, model, params, oqt.GPTQConfig(block_size=16))
    q_rtn = run(oqt, model, params, None)
    err_gptq = float(np.abs(_run(model, q_gptq, ids) - fp).mean())
    err_rtn = float(np.abs(_run(model, q_rtn, ids) - fp).mean())
    assert np.isfinite(err_gptq) and err_gptq < 1.5 * err_rtn
    jq = from_jax_params(run(joqt, jmodel, jparams, joqt.GPTQConfig(block_size=16)),
                         device="cpu")
    same = total = 0
    for x, y in zip(_leaves(q_gptq), _leaves(jq), strict=True):
        if isinstance(x, QTensor):
            same += int((x.data == y.data).sum())
            total += x.data.numel()
    assert same >= 0.99 * total


@pytest.mark.parametrize("fmt", ["qdq", "qlinear"])
def test_calibrated_static_activations(fmt):
    """Static uint8 activations calibrated over the MoE model (each expert's
    range from its routed rows): JAX's calibrated scales, and for QLINEAR
    (the Q8 kernel's sites, its plain version here) JAX's logits."""
    model, params, jmodel, jparams = _pair()
    data = _ids(np.random.default_rng(17), batch=4, seq=8)

    def run(pkg, mdl, prm):
        static = pkg.QActivationArgs(dtype="uint8", is_static=True)
        kw = dict(output_activations=static, format="qlinear") if fmt == "qlinear" else {}
        return pkg.quantize(mdl, prm, pkg.QConfig(
            weights=pkg.QWeightArgs(dtype="int8", strategy="channel",
                                    symmetric=fmt == "qlinear"),
            input_activations=static, calibration_data=data,
            calibration_params=pkg.CalibrationParams(num_samples=4, batch_size=2),
            ignore=[r"\.router$"], **kw))

    (q, plan), (jq, jplan) = run(oqt, model, params), run(joqt, jmodel, jparams)
    jscales = {e.name: e.input_scale for e in jplan}
    for entry in plan:
        np.testing.assert_allclose(entry.input_scale.numpy(), np.asarray(jscales[entry.name]),
                                   rtol=1e-5, atol=0)
    ids = _ids(np.random.default_rng(18))
    out = _run(model, q, ids)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jmodel(jq, ids)), atol=1e-4, rtol=0)


# -- the engine --------------------------------------------------------------------

@pytest.mark.parametrize("layout,kv_quant", [("stack", False), ("fuse", True)])
def test_moe_engine_prefill_decode_matches_jax(layout, kv_quant):
    """Prefill and greedy decode of an MoE engine over the stacked (float
    cache) and the fused (int8 cache) W4 tree against JAX's engine on the
    same tree: last-token logits within 1e-5 (float cache) or 1e-3 (int8: a
    cross-framework last bit can move one K/V code), greedy tokens equal; the
    float-cache prefill also equals the no-cache forward (JAX's test)."""
    model, q, jmodel, jq = _w4_pair(shared_expert_size=48)
    transform = stack_moe_experts if layout == "stack" else fuse_moe_experts
    jtransform = jmoe.stack_moe_experts if layout == "stack" else jmoe.fuse_moe_experts
    tree, jtree = transform(fuse_gemma3_projections(q)), jtransform(jfuse(jq))
    ids = _ids(np.random.default_rng(19), batch=2, seq=8)
    lengths = np.array([8, 5], np.int32)
    eng = InferenceEngine(model, tree, max_batch=2, max_seq=32, kv_quant=kv_quant)
    cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
    cache, gen = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
    jeng = JEngine(jmodel, jtree, max_batch=2, max_seq=32, kv_quant=kv_quant)
    jcache, jlogits = jeng.prefill(jeng.new_cache(), ids, lengths)
    jcache, jgen = jeng.decode_multi(jcache, np.asarray(np.argmax(jlogits, -1), np.int32),
                                     steps=6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-3 if kv_quant else ATOL, rtol=0)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    if not kv_quant:
        full = _run(model, tree, ids[:1])[:, -1]
        np.testing.assert_allclose(logits[:1].numpy(), full, atol=2e-4, rtol=1e-4)


def test_moe_score_nll_matches_jax():
    """Decode-path scoring over the stacked W4 tree and a float cache: JAX's
    NLL sums within 1e-4 (a sum of 11 float32 log-probabilities), equal counts."""
    model, q, jmodel, jq = _w4_pair()
    tree = stack_moe_experts(fuse_gemma3_projections(q))
    jtree = jmoe.stack_moe_experts(jfuse(jq))
    rows = np.random.default_rng(20).integers(0, 256, (3, 12)).astype(np.int32)
    nll, cnt = InferenceEngine(model, tree, max_batch=2, max_seq=32).score_nll(rows)
    jnll, jcnt = JEngine(jmodel, jtree, max_batch=2, max_seq=32).score_nll(rows)
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    np.testing.assert_allclose(nll, np.asarray(jnll), atol=1e-4, rtol=0)


def test_moe_serving_matches_generate():
    """The continuous-batching scheduler over the fused W4 tree: every
    request's greedy tokens equal ``generate``'s for it alone."""
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler

    model, q, *_ = _w4_pair(shared_expert_size=48)
    tree = fuse_moe_experts(fuse_gemma3_projections(q))
    prompts = [[5, 9, 17, 3], [11, 2], [40, 41, 42, 43, 44, 45], [7]]
    eng = InferenceEngine(model, tree, max_batch=2, max_seq=32, kv_quant=True)
    sched = ContinuousBatchingScheduler(eng, chunk=3, pipeline=1)
    handles = [sched.submit(p, max_new_tokens=5) for p in prompts]
    sched.run()
    for p, h in zip(prompts, handles):
        alone = InferenceEngine(model, tree, max_batch=1, max_seq=32, kv_quant=True)
        assert h.output == alone.generate([p], max_new_tokens=5)[0]


def test_megakernel_never_takes_an_moe_mlp(monkeypatch):
    """``mlp_megakernel=True`` over an MoE model whose experts are GeGLU W4
    pairs (the fused MLP's own form): no MoE layout reaches the fused MLP."""
    cfg = dataclasses.replace(tiny_moe_config(shared_expert_size=48),
                              mlp_activation="gelu_tanh")
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=IGNORE))
    gf = fuse_gemma3_projections(q)

    def refuse(*args, **kw):
        raise AssertionError("the fused MLP took an MoE MLP")

    monkeypatch.setattr(mlp_w4, "mlp_w4_fused", refuse)
    for tree in (gf, stack_moe_experts(gf), fuse_moe_experts(gf)):
        eng = InferenceEngine(model, tree, max_batch=2, max_seq=32, kv_quant=True,
                              mlp_megakernel=True)
        assert len(eng.generate([[1, 2, 3], [4]], max_new_tokens=3)[0]) == 3
    assert not any(e.use_megakernel for b in model.layers for e in b.mlp.experts)
