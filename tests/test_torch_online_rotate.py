"""QuaRot's online rotations (R2/R3/R4) in the port, held to the JAX package.

Counterpart of ``tests/prepasses/test_online_rotate.py``, its MoE case
included (R4 refused there, R2/R3 exact). R2 folds the V head-space rotation,
R3 rotates q and k per head after RoPE (the K cache rotated), R4 mixes the
down_proj input in Hadamard blocks with the transpose folded into the weight.
Exact in float32 (JAX's tolerance: 2e-4 abs, 1e-4 rel); the stamped matrices
are bit-equal to JAX's; the fused W4 MLP is refused under SiLU and under R4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu.models.gemma3 import Gemma3 as JGemma3
from onnx_quantize_tpu.models.llama import tiny_llama_config as jtiny_llama_config
from onnx_quantize_tpu.prepasses import rotate as jrotate
from onnx_quantize_tpu_torch.engine import InferenceEngine
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config
from onnx_quantize_tpu_torch.models.structured import STRUCTURED_GEMMA3, zipf_tokens
from onnx_quantize_tpu_torch.ops.kernels import mlp_w4
from onnx_quantize_tpu_torch.prepasses.rotate import (
    apply_online_rotations,
    clear_online_rotations,
    hadamard_block,
    stamp_online_rotations,
)
from onnx_quantize_tpu_torch.utils import copy_tree

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4


def _ids(batch=2, seq=16, vocab=256):
    return np.random.default_rng(0).integers(1, vocab, size=(batch, seq)).astype(np.int32)


def _run(model, params, ids):
    return model(params, torch.from_numpy(ids).long()).numpy()


def _llama(seed, **kw):
    jmodel = JGemma3(jtiny_llama_config(**kw))
    jparams = jmodel.init(jax.random.key(seed))
    return Gemma3(tiny_llama_config(**kw)), from_jax_params(jparams, device="cpu"), jmodel, jparams


@pytest.mark.parametrize("n", [64, 128, 96])
def test_hadamard_block_orthogonal_and_bit_equal_to_jax(n):
    h = hadamard_block(n, np.random.default_rng(1))
    np.testing.assert_allclose(h @ h.T, np.eye(n), atol=1e-10)
    np.testing.assert_array_equal(h, jrotate.hadamard_block(n, np.random.default_rng(1)))


def test_online_rotations_preserve_fp_logits():
    """R2+R3+R4 (no R1) are a pure reparameterization; the port's folded
    weights and stamped matrices are JAX's (the matrices bit for bit)."""
    model, params, jmodel, jparams = _llama(0, num_layers=2, attn_bias=True)
    ids = _ids()
    ref = _run(model, params, ids)
    model_r = Gemma3(model.cfg)
    rotated = copy_tree(params)
    apply_online_rotations(model_r, rotated, qk=True, v=True, down=True, block=64)
    out = _run(model_r, rotated, ids)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    jmodel_r = JGemma3(jmodel.cfg)
    jrotated = copy_tree(jparams)
    jrotate.apply_online_rotations(jmodel_r, jrotated, qk=True, v=True, down=True, block=64)
    np.testing.assert_array_equal(model_r.layers[0].attn.qk_rot, jmodel_r.blocks[0].attn.qk_rot)
    np.testing.assert_array_equal(model_r.layers[1].mlp.down_rot, jmodel_r.blocks[1].mlp.down_rot)
    for m, p in (("attn", "v_proj"), ("attn", "o_proj"), ("mlp", "down_proj")):
        np.testing.assert_allclose(rotated["layers.1"][m][p]["w"].numpy(),
                                   np.asarray(jrotated["layers.1"][m][p]["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jmodel_r(jrotated, ids)), atol=1e-5, rtol=0)
    clear_online_rotations(model_r)
    assert model_r.layers[0].attn.qk_rot is None and model_r.layers[0].mlp.down_rot is None


def test_online_rotations_engine_decode_exact():
    """The engine's cached-KV decode is exact under R2+R3: rotated q attends
    rotated cached k; o_proj unrotates v."""
    model, params, _, _ = _llama(1, num_layers=2)
    prompts = [[5, 9, 17, 3], [11, 2]]
    base = InferenceEngine(model, params, max_batch=2, max_seq=32).generate(
        prompts, max_new_tokens=10)
    model_r = Gemma3(model.cfg)
    rotated = copy_tree(params)
    apply_online_rotations(model_r, rotated, qk=True, v=True, down=False)
    got = InferenceEngine(model_r, rotated, max_batch=2, max_seq=32).generate(
        prompts, max_new_tokens=10)
    assert got == base


def test_cached_k_actually_rotated():
    """The cache holds rotated K rows."""
    model, params, _, _ = _llama(2, num_layers=1)
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    lengths = np.array([8], np.int32)

    def k_rows(m, p):
        eng = InferenceEngine(m, p, max_batch=1, max_seq=16, kv_quant=False)
        cache, _ = eng.prefill(eng.new_cache(), ids, lengths)
        return cache["k"][0, 0, :8].numpy()  # (S, H, D)

    k_plain = k_rows(model, params)
    model_r = Gemma3(model.cfg)
    rotated = copy_tree(params)
    apply_online_rotations(model_r, rotated, qk=True, v=False, down=False)
    k_rot = k_rows(model_r, rotated)
    np.testing.assert_allclose(k_rot, k_plain @ model_r.layers[0].attn.qk_rot, atol=1e-4)


def _inject_kv_outliers(model, params, rng):
    params = copy_tree(params)
    hd = model.cfg.head_dim
    for i in range(model.cfg.num_layers):
        attn = params[f"layers.{i}"]["attn"]
        for proj in ("k_proj", "v_proj"):
            w = attn[proj]["w"].clone()
            for h in range(w.shape[1] // hd):
                idx = rng.choice(hd, size=3, replace=False)
                w[:, h * hd + idx] *= 25.0
            attn[proj]["w"] = w / 3.0
    return params


def test_int4_kv_distortion_recovery_on_outlier_heads():
    """On outlier-heavy K/V heads (3 channels x 25 a head) R2+R3 recover the
    int4 cache's decode-path distortion (JAX froze plain 0.679, rotated
    0.170; here at 32 tokens: plain above 0.4, rotated below half of it)."""
    model, params = STRUCTURED_GEMMA3(device="cpu")
    params = _inject_kv_outliers(model, params, np.random.default_rng(5))
    S = 32
    toks = zipf_tokens(2 * S, 2048).reshape(2, S)

    def rel_dist(m, p, kv):
        outs = []
        for quant in (False, kv):
            eng = InferenceEngine(m, p, max_batch=2, max_seq=S, kv_quant=quant)
            cache, l0 = eng.prefill(eng.new_cache(), toks[:, :1], np.ones(2, np.int32))
            per = [l0.numpy()]
            for i in range(1, S - 1):
                cache, lg = eng.decode(cache, toks[:, i])
                per.append(lg.numpy())
            outs.append(np.stack(per, 1))
        fp, q = outs
        return np.abs(q - fp).mean() / np.abs(fp).mean()

    plain4 = rel_dist(model, params, "int4")
    model_r = Gemma3(model.cfg)
    rotated = copy_tree(params)
    apply_online_rotations(model_r, rotated, qk=True, v=True, down=False)
    rot4 = rel_dist(model_r, rotated, "int4")
    assert plain4 > 0.4, plain4
    assert rot4 < 0.5 * plain4, (rot4, plain4)


def test_rotate_down_shrinks_static_activation_scale():
    """R4: outlier channels in the down_proj input inflate its per-tensor
    static int8 scale; the blockwise Hadamard spreads them, and the scale
    re-calibrated on the rotated model drops more than 3x."""
    hot = [3, 17, 40, 77]
    ids = _ids(batch=4, seq=8)

    def build():
        m, p, _, _ = _llama(7, num_layers=2)
        for i in range(2):
            mlp = p[f"layers.{i}"]["mlp"]
            for proj in ("gate_proj", "up_proj"):
                w = mlp[proj]["w"].clone()
                w[:, hot] *= 30.0
                mlp[proj]["w"] = w
        return m, p

    common = dict(weights=oqt.QWeightArgs(dtype="int8"),
                  input_activations=oqt.QActivationArgs(dtype="int8"), calibration_data=ids,
                  ignore=["lm_head", "embed"])
    m1, p1 = build()
    qp_plain, _ = oqt.quantize(m1, p1, oqt.QConfig(
        preprocessors=[oqt.RotateConfig(seed=9)], **common))
    m2, p2 = build()
    qp_rot, _ = oqt.quantize(m2, p2, oqt.QConfig(
        preprocessors=[oqt.RotateConfig(seed=9, rotate_down=True, online_block=64)], **common))
    s_plain = float(qp_plain["layers.0"]["mlp"]["down_proj"]["w"].input_scale)
    s_rot = float(qp_rot["layers.0"]["mlp"]["down_proj"]["w"].input_scale)
    assert s_rot < s_plain / 3.0, (s_rot, s_plain)
    out_plain, out_rot = _run(m1, qp_plain, ids), _run(m2, qp_rot, ids)
    assert np.isfinite(out_rot).all()
    assert (out_rot.argmax(-1) == out_plain.argmax(-1)).mean() > 0.8


def test_stamp_matches_apply_determinism():
    """stamp_online_rotations on a fresh model reproduces the transforms (the
    checkpoint-reload path)."""
    model, params, _, _ = _llama(4, num_layers=1)
    rotated = copy_tree(params)
    apply_online_rotations(model, rotated, qk=True, v=True, down=True, block=64, seed=3)
    fresh = Gemma3(model.cfg)
    stamp_online_rotations(fresh, qk=True, down=True, block=64, seed=3)
    np.testing.assert_array_equal(fresh.layers[0].attn.qk_rot, model.layers[0].attn.qk_rot)
    np.testing.assert_array_equal(fresh.layers[0].mlp.down_rot, model.layers[0].mlp.down_rot)
    ids = _ids()
    np.testing.assert_allclose(_run(fresh, rotated, ids), _run(model, rotated, ids), atol=1e-6)


def test_rotate_config_round_trip():
    cfg = oqt.RotateConfig(rotate_qk=True, rotate_v=True, rotate_down=True, online_block=64,
                           seed=11)
    assert oqt.RotateConfig(**dataclasses.asdict(cfg)) == cfg
    with pytest.raises(ValueError, match="mode"):
        oqt.RotateConfig(mode="sparse")


def _megakernel_calls(model, params, monkeypatch):
    """Fused-MLP calls of one decode-sized forward with the megakernel armed."""
    calls = []
    plain = mlp_w4.mlp_w4_fused

    def spy(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(mlp_w4, "mlp_w4_fused", spy)
    for layer in model.layers:
        layer.mlp.use_megakernel = True
    model(params, torch.ones((2, 1), dtype=torch.long))
    return len(calls)


@pytest.mark.parametrize("case", ["gelu", "silu", "gelu+down_rot"])
def test_fused_mlp_refused_under_silu_and_down_rot(case, monkeypatch):
    """The fused W4 MLP computes GeGLU with no hook between the activation and
    down_proj: a SiLU model and an R4-rotated one take the unfused path, as in
    the JAX package (models/gemma3.py:340-352); GeGLU alone takes the kernel."""
    # Widths the kernel tiles (N % 128, groups of 64).
    cfg = Gemma3Config.tiny(hidden_size=128, intermediate_size=256,
                            mlp_activation="silu" if case == "silu" else "gelu_tanh")
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    if case == "gelu+down_rot":
        stamp_online_rotations(model, qk=False, down=True, block=64)
    want = cfg.num_layers if case == "gelu" else 0
    assert _megakernel_calls(model, fuse_gemma3_projections(q), monkeypatch) == want


def test_online_down_rejects_moe():
    """R4 is refused on an MoE model, applied or stamped; R2/R3 keep its
    logits (tests/prepasses/test_online_rotate.py:216)."""
    cfg = tiny_moe_config(num_layers=1)
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    with pytest.raises(NotImplementedError, match="dense MLPs only"):
        apply_online_rotations(model, copy_tree(params), down=True)
    with pytest.raises(NotImplementedError, match="dense MLPs only"):
        stamp_online_rotations(Gemma3(cfg), qk=True, down=True)
    ids = _ids()
    ref = _run(model, params, ids)
    model_r = Gemma3(cfg)
    rotated = copy_tree(params)
    apply_online_rotations(model_r, rotated, qk=True, v=True, down=False)
    np.testing.assert_allclose(_run(model_r, rotated, ids), ref, atol=ATOL, rtol=RTOL)
    clear_online_rotations(model_r)
    assert model_r.layers[0].attn.qk_rot is None
