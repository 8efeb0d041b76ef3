"""The Hopper kernels on a CUDA device: each against its plain version, and a
small engine on the card against the same engine on the CPU.

Every test here needs a card and skips without one. The card's machine has
no JAX, so this file imports only torch, numpy and the port, and runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.algorithms import rtn_quantize
from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor
from onnx_quantize_tpu_torch.ops import quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8
from onnx_quantize_tpu_torch.ops.reference import _qdq_matmul
from onnx_quantize_tpu_torch.plan import resolve_group_size
from onnx_quantize_tpu_torch.utils import tree_map

pytestmark = pytest.mark.cuda

# (dtype, group_size, symmetric, K, N, x shape)
CASES = [
    ("uint4", 64, False, 320, 200, (5,)),  # a pad group, ragged N
    ("uint4", 128, False, 640, 1536, (32,)),  # the Gemma qkv site at decode
    ("int4", 64, True, 128, 20000, (3, 70)),  # 4 columns per thread, ragged M
    ("uint4", -1, False, 130, 128, (4,)),  # channel scales over packed K halves
    ("int8", -1, True, 640, 40004, (33,)),  # lm_head-like, ragged N edge
    ("uint8", -1, False, 96, 128, (7,)),  # zero points
    ("uint8", -1, True, 96, 128, (4,)),  # symmetric uint8 keeps zp = 128
    ("uint8", 32, False, 96, 999, (65,)),  # group scales, ragged M and N
]


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qtensor(dtype, group_size, symmetric, K, N, seed=0):
    args = oqt.QWeightArgs(dtype=dtype, group_size=group_size, symmetric=symmetric)
    gs = resolve_group_size(K, group_size) or -1
    w = torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32))
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, gs, symmetric, False)
    qt = make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy, group_size=gs,
                      symmetric=symmetric, reduce_range=False)
    return prepare_kernel_scales({"w": qt})["w"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[1]}-{c[3]}x{c[4]}")
def test_kernel_matches_plain_reference(case):
    """Kernel output within 1e-4 of max|y| of the dequantize-then-matmul
    reference on the same (bf16-representable) inputs: they differ only in
    float32 summation order."""
    _require_cuda()
    dtype, gs, sym, K, N, xshape = case
    qt = _qtensor(dtype, gs, sym, K, N)
    module = matmul_w4 if qt.meta.packed else matmul_w8
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(xshape + (K,)).astype(
            np.float32)).to(xdt)
        before = module.launches
        got = quantized_matmul(x.cuda(), qt.to("cuda"))
        torch.cuda.synchronize()
        assert module.launches == before + 1
        want = _qdq_matmul(x.float(), qt)
        assert got.shape == want.shape
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_engine_on_card_matches_cpu_and_counts_launches():
    """A tiny float32 engine: logits through the kernels within 1e-4 of max
    logit of the CPU run (plain versions), greedy tokens equal, and one W4
    launch per body site plus one W8 launch per decode step."""
    _require_cuda()
    cfg = Gemma3Config.tiny(hidden_size=320, intermediate_size=512, num_layers=3,
                            sliding_pattern=3, num_heads=2, num_kv_heads=1, head_dim=64,
                            sliding_window=8, vocab_size=512)
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    params = fuse_gemma3_projections(params)
    on_card = tree_map(lambda t: t.to("cuda"), params)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)
    lengths = np.array([12, 9, 15, 3], np.int32)

    def run(p):
        eng = InferenceEngine(model, p, max_batch=4, max_seq=32, kv_quant=True)
        cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
        before = matmul_w4.launches, matmul_w8.launches
        cache, toks = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
        after = matmul_w4.launches, matmul_w8.launches
        return logits.float().cpu(), toks.cpu(), (after[0] - before[0], after[1] - before[1])

    cpu_logits, cpu_toks, cpu_launches = run(params)
    gpu_logits, gpu_toks, gpu_launches = run(on_card)
    assert cpu_launches == (0, 0)
    assert gpu_launches == (4 * cfg.num_layers * 6, 6)
    assert (gpu_logits - cpu_logits).abs().max().item() <= 1e-4 * cpu_logits.abs().max().item()
    assert torch.equal(gpu_toks, cpu_toks)


def test_kernel_bf16_stream_engine_runs_on_card():
    """The bf16 main-path configuration at a small width: finite logits and
    tokens in range through the kernels."""
    _require_cuda()
    cfg = dataclasses.replace(Gemma3Config.tiny(vocab_size=1024), dtype="bfloat16")
    model = Gemma3(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=["lm_head"]))
    eng = InferenceEngine(model, fuse_gemma3_projections(params), max_batch=2, max_seq=32,
                          kv_quant=True, dtype=torch.bfloat16)
    out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]], max_new_tokens=5)
    assert [len(o) for o in out] == [5, 5]
    assert all(0 <= t < cfg.vocab_size for o in out for t in o)
