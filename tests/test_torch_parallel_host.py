"""The host-side machinery of the port's ``parallel/`` package, held to the
JAX package's with no world of ranks: ``site_kind``, the fused column
permutation, ``localize_meta``'s refusals, ``localize_params``,
``build_param_specs``, ``shard_params``' slices and its row-alignment
warning, the engine's bake-after-slicing (D4), ``tp_localize``'s refusals,
``zigzag_permutation``, the pipeline's stage split and the CP refusals.

A rank's place in a mesh is all the slicing reads, so a stand-in with
``shape`` and ``coords`` plays the mesh here. Tolerance: none, every
compared tensor is bit-equal to JAX's.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu as joqt
from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jrtn
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JConfig
from onnx_quantize_tpu.models.gemma3 import fuse_gemma3_projections as jfuse
from onnx_quantize_tpu.models.moe import tiny_moe_config as jtiny_moe
from onnx_quantize_tpu.nn.qtensor import QBias as JQBias
from onnx_quantize_tpu.nn.qtensor import QTensor as JQTensor
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jmake_qtensor
from onnx_quantize_tpu.parallel import cp as jcp
from onnx_quantize_tpu.parallel import pp as jpp
from onnx_quantize_tpu.parallel import sharding as jsharding
from onnx_quantize_tpu.parallel import tp as jtp
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QTensor
from onnx_quantize_tpu_torch.parallel import cp, pp, sharding, tp
from onnx_quantize_tpu_torch.parallel.mesh import P

torch.set_num_threads(1)

TP_FRIENDLY = dict(vocab_size=512, hidden_size=128, intermediate_size=512, num_layers=2,
                   num_heads=8, num_kv_heads=2, head_dim=64, sliding_window=16,
                   sliding_pattern=2)
QT_FIELDS = ("data", "scale", "zero_point", "input_scale", "input_zero_point", "output_scale",
             "output_zero_point")


def stand_in_mesh(**coords):
    """What slicing reads of a mesh: axis sizes and this rank's coordinates."""
    shape = {k: v[1] for k, v in coords.items()}
    return types.SimpleNamespace(shape=shape, coords={k: v[0] for k, v in coords.items()})


@pytest.fixture(scope="module")
def tiny_tree():
    """The dry run's tp-friendly config, uint4 g16 everywhere, and its fused tree."""
    cfg = JConfig.tiny(**TP_FRIENDLY)
    model = JGemma3(cfg)
    params = model.init(jax.random.key(0))
    q, _ = joqt.quantize(model, params,
                         joqt.QConfig(weights=joqt.QWeightArgs(dtype="uint4", group_size=16)))
    return model, q, jfuse(q)


def jax_qt(K, N, gs=16, qt_type=JQuantType.QUInt4, seed=0):
    w = (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32)
    strategy = JStrategy.GROUP if gs > 0 else JStrategy.CHANNEL
    q, s, zp = jrtn(w, qt_type, strategy, gs, False, False)
    return jmake_qtensor(q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
                         symmetric=False, reduce_range=False)


def assert_leaves_equal(ours, theirs, path=()):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            assert_leaves_equal(ours[k], theirs[k], path + (k,))
        return
    if isinstance(theirs, JQTensor):
        assert isinstance(ours, QTensor), path
        assert tuple(ours.meta.shape) == tuple(theirs.meta.shape), path
        for f in QT_FIELDS:
            assert_leaves_equal(getattr(ours, f), getattr(theirs, f), path + (f,))
        return
    if theirs is None:
        assert ours is None, path
        return
    a, b = np.asarray(theirs), ours.cpu().numpy()
    assert a.shape == b.shape and a.tobytes() == b.tobytes(), path


def spec(x):
    return None if x is None else tuple(x)


def assert_specs_equal(ours, theirs, path=()):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            assert_specs_equal(ours[k], theirs[k], path + (k,))
    elif isinstance(theirs, JQTensor):
        for f in QT_FIELDS:
            assert spec(getattr(ours, f)) == spec(getattr(theirs, f)), path + (f,)
    elif isinstance(theirs, JQBias):
        for f in ("data", "scale", "zero_point"):
            assert spec(getattr(ours, f)) == spec(getattr(theirs, f)), path + (f,)
    else:
        assert spec(ours) == spec(theirs), path


RULES = [(r"\.attn\.q_proj$", "column"), (r"\.attn\.o_proj$", "row"), (r"^lm_head$", "column")]


@pytest.mark.parametrize("name", ["layers.0.attn.q_proj", "layers.3.attn.o_proj", "lm_head",
                                  "layers.0.mlp.down_proj", "embed"])
def test_site_kind_matches_jax(name):
    assert tp.site_kind(name, RULES) == jtp.site_kind(name, RULES)


@pytest.mark.parametrize("tp_size,segments", [
    (2, ((512, "column"), (128, "column"), (128, "column"))),
    (4, ((512, "column"), (128, "replicate"), (128, "replicate"))),
    (2, ((64, "column"), (64, "column"))),
])
def test_fused_column_perm_matches_jax(tp_size, segments):
    perm, width = tp._fused_column_perm(tp_size, segments)
    jperm, jwidth = jtp._fused_column_perm(tp_size, segments)
    assert width == jwidth
    np.testing.assert_array_equal(perm, jperm)


def test_fused_column_perm_refusals():
    for segments, match in ((((6, "column"),), "not divisible"), (((4, "row"),), "not supported")):
        with pytest.raises(ValueError, match=match):
            jtp._fused_column_perm(4, segments)
        with pytest.raises(ValueError, match=match):
            tp._fused_column_perm(4, segments)


@pytest.mark.parametrize("case", ["column_n", "row_k", "row_channel_packed", "row_odd_groups"])
def test_localize_meta_refusals_match_jax(case):
    K, N, gs, kind, size = {"column_n": (64, 36, 16, "column", 8),
                            "row_k": (72, 64, 8, "row", 16),
                            "row_channel_packed": (64, 64, -1, "row", 2),
                            "row_odd_groups": (96, 64, 16, "row", 2)}[case]
    jqt = jax_qt(K, N, gs=gs)
    ours = from_jax_params(jqt, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jtp.localize_meta(jqt.meta, size, kind)
    with pytest.raises(ValueError, match=str(theirs.value).split("(")[0][:30]):
        tp.localize_meta(ours.meta, size, kind)


def test_localize_meta_shapes_match_jax():
    jqt = jax_qt(128, 64)
    ours = from_jax_params(jqt, device="cpu")
    for kind in ("column", "row", "replicate"):
        assert tp.localize_meta(ours.meta, 2, kind).shape == jtp.localize_meta(
            jqt.meta, 2, kind).shape


def test_localize_params_refuses_static_output_on_row_site():
    jqt = jax_qt(128, 64)
    ours = from_jax_params(jqt, device="cpu")
    static = dataclasses.replace(ours, meta=dataclasses.replace(
        ours.meta, output_quant=ActQuantSpec(mode="static")))
    with pytest.raises(ValueError, match="requantize its output"):
        tp.localize_params({"layers.0": {"attn": {"o_proj": {"w": static}}}}, RULES, 2)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("tp_size", [2, 4], ids=["tp2_kv_sharded", "tp4_replicate_slice"])
def test_localize_params_leaves_equal_jax(tiny_tree, fused, tp_size):
    model, q, fq = tiny_tree
    tree = fq if fused else q
    _, jrules = model.tp_localize(tp_size)
    _, rules = Gemma3(Gemma3Config(**TP_FRIENDLY)).tp_localize(tp_size)
    want = jtp.localize_params(tree, jrules, tp_size)
    got = tp.localize_params(from_jax_params(tree, device="cpu"), rules, tp_size)
    assert_leaves_equal(got, want)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_build_param_specs_match_jax(tiny_tree, moe):
    if moe:
        from onnx_quantize_tpu.models.moe import stack_moe_experts as jstack

        jcfg = jtiny_moe(shared_expert_size=128, num_heads=4, num_kv_heads=2, hidden_size=64,
                         head_dim=32, moe_intermediate_size=96)
        jmodel = JGemma3(jcfg)
        q, _ = joqt.quantize(jmodel, jmodel.init(jax.random.key(0)), joqt.QConfig(
            weights=joqt.QWeightArgs(dtype="uint4", group_size=16),
            ignore=[r"\.router$", r"\.shared_gate$"]))
        tree = jstack(jfuse(q))
        model = Gemma3(tiny_moe_config(shared_expert_size=128, num_heads=4, num_kv_heads=2,
                                       hidden_size=64, head_dim=32, moe_intermediate_size=96))
    else:
        jmodel, _, tree = tiny_tree
        model = Gemma3(Gemma3Config(**TP_FRIENDLY))
    _, jrules = jmodel.tp_localize(2)
    _, rules = model.tp_localize(2)
    jl = jtp.localize_params(tree, jrules, 2)
    pl = tp.localize_params(from_jax_params(tree, device="cpu"), rules, 2)
    assert_specs_equal(tp.build_param_specs(pl, rules), jtp.build_param_specs(jl, jrules))


def test_shard_params_slices_equal_jax_shards(tiny_tree):
    """Each rank's slice of the (data 2, model 4) layout equals the shard JAX
    places on the device at that coordinate."""
    from onnx_quantize_tpu.parallel import make_mesh as jmake_mesh

    jmodel, q, _ = tiny_tree
    jmesh = jmake_mesh(model_parallel=4)
    placed = jsharding.shard_params(jmodel, q, jmesh)
    ours = from_jax_params(q, device="cpu")
    model = Gemma3(Gemma3Config(**TP_FRIENDLY))
    for m in range(4):
        local = sharding.shard_params(model, ours, stand_in_mesh(data=(0, 2), model=(m, 4)))
        device = jmesh.devices[0, m]
        for path in (("layers.0", "attn", "q_proj"), ("layers.1", "attn", "o_proj"),
                     ("layers.0", "mlp", "down_proj"), ("lm_head",)):
            jsite, site = placed, local
            for key in path:
                jsite, site = jsite[key], site[key]
            for f in ("data", "scale", "zero_point"):
                arr = getattr(jsite["w"], f)
                want = np.asarray(arr)[arr.sharding.devices_indices_map(arr.shape)[device]]
                got = getattr(site["w"], f).numpy()
                assert want.tobytes() == got.tobytes() and want.shape == got.shape, (path, f)
        emb = placed["embed"]["w"]
        want = np.asarray(emb)[emb.sharding.devices_indices_map(emb.shape)[device]]
        np.testing.assert_array_equal(local["embed"]["w"].numpy(), want)


def test_shard_params_row_misaligned_groups_warn_and_replicate(monkeypatch):
    from onnx_quantize_tpu.parallel import make_mesh as jmake_mesh

    jqt = jax_qt(96, 128, gs=32)  # 96 / 4 = 24 rows a shard: gs 32 does not fit
    jsharded = jsharding.qtensor_shardings(jqt, "row", jmake_mesh(model_parallel=4))
    warned = []
    monkeypatch.setattr(sharding.logger, "warning", lambda *a: warned.append(a))
    local = sharding.qtensor_shardings(from_jax_params(jqt, device="cpu"), "row",
                                       stand_in_mesh(data=(0, 2), model=(1, 4)))
    assert tuple(jsharded.data.sharding.spec) == ()
    assert warned and "replicating" in warned[0][0]
    assert local.data.shape == tuple(jqt.data.shape) and local.meta.shape == (96, 128)


@pytest.mark.parametrize("kind", ["row", "column"])
def test_bake_after_slicing_equals_slicing_the_baked_tree(kind):
    """A row shard holds an even number of whole groups, so the engine's
    bake of a rank's logical slice equals the same slice of the baked global
    tree (data, scale and zero point)."""
    ours = from_jax_params(jax_qt(256, 192, gs=16), device="cpu")
    tree = {"lm_head": {"w": ours}}
    rules = [(r"^lm_head$", kind)]
    for size in (2, 4):
        local = tp.localize_params(tree, rules, size)
        specs = tp.build_param_specs(local, rules)
        baked = prepare_kernel_scales(tree)
        baked_specs = tp.build_param_specs(tp.localize_params(baked, rules, size), rules)
        for i in range(size):
            mesh = stand_in_mesh(model=(i, size))
            first = prepare_kernel_scales(tp.shard_params_local(local, specs, mesh))
            then = tp.shard_params_local(baked, baked_specs, mesh)
            for f in ("data", "scale", "zero_point"):
                a, b = getattr(first["lm_head"]["w"], f), getattr(then["lm_head"]["w"], f)
                assert a.shape == b.shape and torch.equal(a, b), (size, i, f)


@pytest.mark.parametrize("case", ["gqa_straddle", "heads", "experts"])
def test_tp_localize_refusals_match_jax(case):
    if case == "experts":
        jcfg, cfg = (jtiny_moe(num_experts=3, num_heads=4, head_dim=32),
                     tiny_moe_config(num_experts=3, num_heads=4, head_dim=32))
        size, match = 2, "num_experts"
    else:
        kw = dict(num_heads=6, num_kv_heads=3) if case == "gqa_straddle" else dict(num_heads=6)
        jcfg, cfg = JConfig.tiny(**kw), Gemma3Config.tiny(**kw)
        size, match = (2, "num_kv_heads") if case == "gqa_straddle" else (4, "num_heads")
    with pytest.raises(ValueError, match=match):
        JGemma3(jcfg).tp_localize(size)
    with pytest.raises(ValueError, match=match):
        Gemma3(cfg).tp_localize(size)


@pytest.mark.parametrize("kv_heads,size", [(2, 2), (2, 4), (1, 4), (8, 4)])
def test_tp_localize_local_config_matches_jax(kv_heads, size):
    kw = dict(TP_FRIENDLY, num_kv_heads=kv_heads)
    jlocal, jrules = JGemma3(JConfig.tiny(**kw)).tp_localize(size)
    local, rules = Gemma3(Gemma3Config(**kw)).tp_localize(size)
    assert (local.cfg.num_heads, local.cfg.num_kv_heads) == (jlocal.cfg.num_heads,
                                                             jlocal.cfg.num_kv_heads)
    assert rules == jrules
    for block, jblock in zip(local.layers, jlocal.blocks):
        assert block.attn.kv_slice == jblock.attn.kv_slice
        assert block.attn.kv_proj_heads == jblock.attn.kv_proj_heads
        assert block.attn.o_proj.tp_reduce == jblock.attn.o_proj.tp_reduce
        assert block.mlp.down_proj.tp_reduce == jblock.mlp.down_proj.tp_reduce
    assert local.embed.tp_vocab_axis == jlocal.embed.tp_vocab_axis
    assert local._tp_gather_logits == jlocal._tp_gather_logits


@pytest.mark.parametrize("T,shards", [(16, 4), (32, 2), (2048, 2)])
def test_zigzag_permutation_matches_jax(T, shards):
    np.testing.assert_array_equal(cp.zigzag_permutation(T, shards),
                                  jcp.zigzag_permutation(T, shards))
    with pytest.raises(ValueError, match="zigzag"):
        cp.zigzag_permutation(T + 2, shards)


def test_cp_refusals():
    model = Gemma3(Gemma3Config.tiny())
    params = {}
    mesh = stand_in_mesh(seq=(0, 4))
    ids = np.zeros((2, 16), np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        cp.cp_logits(model, params, np.zeros((2, 10), np.int32), mesh)
    with pytest.raises(ValueError, match="unknown cp mode"):
        cp.cp_logits(model, params, ids, mesh, mode="nope")
    with pytest.raises(ValueError, match="unknown layout"):
        cp.cp_logits(model, params, ids, mesh, layout="nope")
    with pytest.raises(ValueError, match="Gemma3-family"):
        cp.cp_localize(object(), size=2)


def test_pipeline_stage_params_split_and_refusals():
    """The stage split's leaves equal JAX's stacked ones; the refusals match."""
    kw = dict(num_layers=4, sliding_pattern=2, hidden_size=64, num_heads=2, num_kv_heads=1,
              head_dim=32, sliding_window=8)
    jmodel = JGemma3(JConfig.tiny(**kw))
    jparams = jmodel.init(jax.random.key(1))
    q, _ = joqt.quantize(jmodel, jparams, joqt.QConfig(
        weights=joqt.QWeightArgs(dtype="uint4", group_size=16), ignore=["lm_head"]))
    model = Gemma3(Gemma3Config.tiny(**kw))
    ours = from_jax_params(q, device="cpu")
    jst, jsh = jpp.pipeline_stage_params(jmodel, q, stages=2)
    st, sh = pp.pipeline_stage_params(model, ours, stages=2)
    assert_leaves_equal(st, jst)
    assert_leaves_equal(sh, jsh)
    for stages, match in ((4, "mixes local/global"), (1, "stages >= 2"), (3, "not divisible")):
        with pytest.raises(ValueError, match=match):
            jpp.pipeline_stage_params(jmodel, q, stages=stages)
        with pytest.raises(ValueError, match=match):
            pp.pipeline_stage_params(model, ours, stages=stages)


def test_partition_spec_and_mesh_helpers():
    from onnx_quantize_tpu_torch.parallel import data_sharding, replicated

    assert tuple(data_sharding(None, 3)) == ("data", None, None)
    assert tuple(replicated(None)) == ()
    assert P(None, "model") == (None, "model") and repr(P("a")) == "P('a',)"
    x = torch.arange(24).reshape(4, 6)
    got = tp.shard_params_local({"w": x}, {"w": P("data", "model")},
                                stand_in_mesh(data=(1, 2), model=(2, 3)))
    np.testing.assert_array_equal(got["w"].numpy(), x.numpy()[2:4, 4:6])
