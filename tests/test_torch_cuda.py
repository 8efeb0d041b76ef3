"""The Hopper kernels on a CUDA device: each against its plain version, and a
small model and engine on the card against the same on the CPU.

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
from onnx_quantize_tpu_torch.algorithms import quantize_bias, rtn_quantize
from onnx_quantize_tpu_torch.core.enums import QFormat
from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config, fuse_gemma3_projections
from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, make_qtensor
from onnx_quantize_tpu_torch.ops import convert_to_w4a8, quantized_matmul
from onnx_quantize_tpu_torch.ops.kernels import (
    SPLIT_SCRATCH,
    flash_attention,
    flash_decode,
    matmul_q8,
    matmul_w4,
    matmul_w4a8,
    matmul_w8,
    matmul_w8a8,
    mlp_w4,
)
from onnx_quantize_tpu_torch.ops.reference import _qdq_matmul, _qlinear_matmul
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
    # W4's launch plan: decode M with the K split (N = 640, a Gemma-3-270M
    # o/down width), large M without it, int4 g64 with a pad group and a
    # ragged tile edge, N % 16 != 0 (the CUDA-core route for bf16 x too).
    *(pytest.param(("uint4", 128, False, K, N, (M,)), id=f"w4-route-{K}x{N}-M{M}")
      for K, N, M in [(1024, 640, 1), (1024, 640, 16), (1024, 640, 33), (2048, 640, 64),
                      (640, 1536, 65), (640, 1536, 2048), (640, 130, 5)]),
    pytest.param(("int4", 64, True, 448, 1008, (32,)), id="w4-route-int4-g64-448x1008-M32"),
    # W8's launch plan: the lm_head's K at decode and window M (mma, no
    # split; x-stationary at M=2048), g32 and g128 tiles that the K split
    # straddles, ragged M and N tile edges, the x-stationary form with a zero
    # point (two warps along M) and at K = 1024 (64 resident rows), both with
    # ragged M and N edges, a K tile of 130 rows (the CUDA-core route for
    # bf16 x too).
    *(pytest.param((dt, gs, sym, K, N, (M,)), id=f"w8-route-{dt}-g{gs}-{K}x{N}-M{M}")
      for dt, gs, sym, K, N, M in [("int8", -1, True, 640, 16384, 32),
                                   ("int8", -1, True, 640, 16384, 2048),
                                   ("uint8", 32, False, 640, 1008, 70),
                                   ("int8", 128, True, 640, 1008, 5),
                                   ("uint8", -1, True, 640, 1008, 33),
                                   ("uint8", -1, False, 640, 65552, 400),
                                   ("int8", -1, True, 1024, 65552, 200),
                                   ("uint8", -1, False, 130, 128, 4)]),
]


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qtensor(dtype, group_size, symmetric, K, N, seed=0, a8=False):
    args = oqt.QWeightArgs(dtype=dtype, group_size=group_size, symmetric=symmetric)
    gs = resolve_group_size(K, group_size) or -1
    w = torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((K, N))).astype(np.float32))
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, gs, symmetric, False)
    tree = {"w": make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy,
                              group_size=gs, symmetric=symmetric, reduce_range=False)}
    if a8:
        tree = convert_to_w4a8(tree)
    return prepare_kernel_scales(tree)["w"]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-g{c[1]}-{c[3]}x{c[4]}")
def test_kernel_matches_plain_reference(case):
    """Kernel output within 1e-4 of max|y| of the dequantize-then-matmul
    reference on the same (bf16-representable) inputs: they differ only in
    float32 summation order. W4 and W8 take the route their plans name (mma
    for bf16 x when the group or K tile and N are multiples of 16, else
    simt), and a second launch gives the same bits (the K split sums its
    partials in a fixed order)."""
    _require_cuda()
    dtype, gs, sym, K, N, xshape = case
    qt = _qtensor(dtype, gs, sym, K, N)
    module = matmul_w4 if qt.meta.packed else matmul_w8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(xshape + (K,)).astype(
            np.float32)).to(xdt)
        before = module.launches
        if module is matmul_w8:
            routes = dict(matmul_w8.route_launches)
        got = quantized_matmul(x.cuda(), qt.to("cuda"))
        torch.cuda.synchronize()
        assert module.launches == before + 1
        want = _qdq_matmul(x.float(), qt)
        assert got.shape == want.shape
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        assert torch.equal(quantized_matmul(x.cuda(), qt.to("cuda")), got)
        M = x[..., :1].numel()
        if module is matmul_w4:
            plan = matmul_w4.w4_plan(M, 2 * qt.data.shape[0], N, qt.meta.pack_group, xdt, sms)
            mma = xdt == torch.bfloat16 and qt.meta.pack_group % 16 == 0 and N % 16 == 0
        else:
            bk = matmul_w8.w8_scale_rows(qt)[0]
            plan = matmul_w8.w8_plan(M, -(-K // bk) * bk, N, bk, xdt, sms)
            mma = xdt == torch.bfloat16 and bk % 16 == 0 and N % 16 == 0
            assert matmul_w8.route_launches[plan.route] == routes[plan.route] + 2
        assert plan.route == ("mma" if mma else "simt")


# (dtype, group_size, symmetric, K, N, x shape) of dynamic-int8 (A8) sites.
A8_CASES = [
    ("uint4", 64, False, 320, 200, (5,)),  # W4A8: a pad group, ragged N
    ("uint4", 128, False, 640, 1536, (32,)),  # the Gemma qkv site at decode
    ("int4", 64, True, 128, 20000, (3, 70)),  # 4 columns per thread, ragged M
    ("uint4", -1, False, 130, 128, (4,)),  # channel scales, group of 65 rows
    ("int8", -1, True, 640, 40004, (33,)),  # W8A8: lm_head-like, ragged N edge
    ("uint8", -1, True, 96, 128, (7,)),  # uint8 symmetric, shifted by 128
    ("int8", 32, True, 96, 999, (65,)),  # group tiles, ragged M and N
    ("int8", -1, True, 1100, 256, (9,)),  # one tile past the plain version's 1024 rows
]


@pytest.mark.parametrize("case", A8_CASES, ids=lambda c: f"a8-{c[0]}-g{c[1]}-{c[3]}x{c[4]}")
def test_a8_kernel_matches_plain_and_oracle(case):
    """The A8 kernels against their plain versions on the card and the CPU
    oracle (fake-quantized x, dequantized W, float32): the integer partials
    are exact on every side, so they differ only in the float32 order of the
    group sums, within 1e-4 of max|y|."""
    _require_cuda()
    dtype, gs, sym, K, N, xshape = case
    qt = _qtensor(dtype, gs, sym, K, N, a8=True)
    module, plain, operands = ((matmul_w4a8, matmul_w4a8.w4a8_matmul_plain,
                                matmul_w4a8.w4a8_operands) if qt.meta.packed else
                               (matmul_w8a8, matmul_w8a8.w8a8_matmul_plain,
                                matmul_w8a8.w8a8_operands))
    card_qt = qt.to("cuda")
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(xshape + (K,)).astype(
            np.float32)).to(xdt)
        before = module.launches
        got = quantized_matmul(x.cuda(), card_qt)
        torch.cuda.synchronize()
        assert module.launches == before + 1
        ops, kw = operands(x.cuda(), card_qt)
        ref = plain(*ops, **kw).reshape(got.shape)
        want = _qdq_matmul(x, qt)
        assert got.shape == want.shape
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# W8A8's launch plan, (dtype, group size, K, N, M, route): the lm_head at
# decode (32 x 64 tiles) and a window-sized M (128 x 128), uint8 shifted by
# XOR (64 x 128), g128 and g32 tiles with ragged M and N edges, a tile of 1100
# rows (x padded to 1104), then the simt route: a 16-row group, N % 16 != 0,
# four columns a thread.
W8A8_ROUTE_CASES = [
    ("int8", -1, 640, 262144, 32, "mma"),
    ("int8", -1, 640, 16384, 2048, "mma"),
    ("uint8", -1, 640, 1024, 100, "mma"),
    ("int8", 128, 640, 1008, 37, "mma"),
    ("uint8", 32, 96, 256, 65, "mma"),
    ("int8", -1, 1100, 256, 9, "mma"),
    ("uint8", 16, 96, 128, 7, "simt"),
    ("int8", -1, 640, 1000, 7, "simt"),
    ("int8", -1, 640, 40004, 33, "simt"),
]


@pytest.mark.parametrize("case", W8A8_ROUTE_CASES,
                         ids=lambda c: f"w8a8-{c[5]}-{c[0]}-g{c[1]}-{c[2]}x{c[3]}-M{c[4]}")
def test_w8a8_routes_bit_equal_to_plain(case):
    """Each route of W8A8's plan equals the plain version bit for bit (exact
    int32 tile sums, then the plain version's rounded fold, tile after tile),
    a second launch gives the same bits, and the route counter names the
    route the plan chose."""
    _require_cuda()
    dtype, gs, K, N, M, route = case
    qt = _qtensor(dtype, gs, True, K, N, a8=True).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((M, K)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    ops, kw = matmul_w8a8.w8a8_operands(x, qt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert matmul_w8a8.w8a8_plan(M, ops[0].shape[1], N, sms, kw["bk"]).route == route
    before = dict(matmul_w8a8.route_launches)
    got = matmul_w8a8.w8a8_matmul(*ops, **kw)
    again = matmul_w8a8.w8a8_matmul(*ops, **kw)
    torch.cuda.synchronize()
    assert matmul_w8a8.route_launches[route] == before[route] + 2
    assert torch.equal(got, again)
    assert torch.equal(got, matmul_w8a8.w8a8_matmul_plain(*ops, **kw))


# W4A8's launch plan, (dtype, group size, symmetric, K, N, M, route): a
# Gemma-3-270M layer's four g128 sites at decode (K split) and at a 32x128
# prefill, g32 and int4 g64 splits with a pad group and ragged M and N tile
# edges, int4 without a split, then the simt route: N % 16 != 0 and a group of
# 65 rows (channel scales over K = 130).
W4A8_ROUTE_CASES = [
    *(("uint4", 128, False, K, N, M, "mma") for K, N in [(640, 1536), (1024, 640),
                                                         (640, 4096), (2048, 640)]
      for M in (32, 4096)),
    ("uint4", 32, False, 640, 1008, 5, "mma"),
    ("uint4", 32, False, 640, 1008, 70, "mma"),
    ("int4", 64, True, 448, 208, 3, "mma"),
    ("int4", 128, True, 640, 20000, 3, "mma"),
    ("uint4", 64, False, 320, 200, 5, "simt"),
    ("uint4", -1, False, 130, 128, 4, "simt"),
]


@pytest.mark.parametrize("case", W4A8_ROUTE_CASES,
                         ids=lambda c: f"w4a8-{c[6]}-{c[0]}-g{c[1]}-{c[3]}x{c[4]}-M{c[5]}")
def test_w4a8_routes_bit_equal_to_plain(case):
    """Each route of W4A8's plan equals the plain version bit for bit (exact
    int32 group sums, then the plain version's rounded fold, pair after pair,
    by the last block of a K split), a second launch gives the same bits, the
    route counter names the route the plan chose, and the split's counters
    and scratch are back at 0."""
    _require_cuda()
    dtype, gs, sym, K, N, M, route = case
    qt = _qtensor(dtype, gs, sym, K, N, a8=True).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((M, K)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    ops, kw = matmul_w4a8.w4a8_operands(x, qt)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = matmul_w4a8.w4a8_plan(M, ops[0].shape[1], N, kw["gs"], sms)
    assert plan.route == route
    before = dict(matmul_w4a8.route_launches)
    got = matmul_w4a8.w4a8_matmul(*ops, **kw)
    again = matmul_w4a8.w4a8_matmul(*ops, **kw)
    torch.cuda.synchronize()
    assert matmul_w4a8.route_launches[route] == before[route] + 2
    assert torch.equal(got, again)
    assert torch.equal(got, matmul_w4a8.w4a8_matmul_plain(*ops, **kw))
    assert all(not counters.any() for _, counters in SPLIT_SCRATCH.values())
    assert all(not parts.any() for key, (parts, _) in SPLIT_SCRATCH.items()
               if key[2] == "W4A8Plan")


def test_activation_quantizer_on_card_equals_cpu():
    """The int8 codes and scale on the card are bit-equal to the CPU's."""
    _require_cuda()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((33, 640)).astype(np.float32))
    for xdt in (torch.float32, torch.bfloat16):
        q_card, s_card = matmul_w4a8.quantize_activation_int8(x.to(xdt).cuda())
        q_cpu, s_cpu = matmul_w4a8.quantize_activation_int8(x.to(xdt))
        assert torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu)


def test_a8_engine_on_card_matches_cpu_and_counts_launches():
    """A tiny float32 A8 engine (every slot active, since the per-tensor
    activation scale couples the rows of a batch): logits through the A8
    kernels within 1e-4 of the largest logit of the CPU run, greedy tokens
    equal, one W4A8 launch per body site and one W8A8 launch per step, and
    no weight-only launch."""
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
    params = convert_to_w4a8(fuse_gemma3_projections(params))
    on_card = tree_map(lambda t: t.to("cuda"), params)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)
    lengths = np.array([12, 9, 15, 3], np.int32)
    modules = (matmul_w4a8, matmul_w8a8, matmul_w4, matmul_w8)

    def run(p):
        eng = InferenceEngine(model, p, max_batch=4, max_seq=32, kv_quant=True)
        cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
        before = [m.launches for m in modules]
        cache, toks = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
        launched = tuple(m.launches - b for m, b in zip(modules, before))
        return logits.float().cpu(), toks.cpu(), launched

    cpu_logits, cpu_toks, cpu_launches = run(params)
    gpu_logits, gpu_toks, gpu_launches = run(on_card)
    assert cpu_launches == (0, 0, 0, 0)
    assert gpu_launches == (4 * cfg.num_layers * 6, 6, 0, 0)
    assert (gpu_logits - cpu_logits).abs().max().item() <= 1e-4 * cpu_logits.abs().max().item()
    assert torch.equal(gpu_toks, cpu_toks)


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


# (B, S, Hq, Hkv, D, window, pos): ragged pos with 0, tile edges and the
# pos = S sentinel of an inactive slot; a window smaller than a tile; one
# query head per KV head; two KV heads; D = 128; S = 128; then the launch
# plan's splits at a decode step of Gemma-3-270M (B = 32, S = 1024, pos =
# 640: clusters of 6 splits, with and without a window of 512) and at B =
# 32, S = 4096 with ragged positions (6 splits; pos 0 has one live key, so
# all but one of its splits are empty).
FD_RAGGED = [0, 63, 64, 511, 512, 4095, 4096] + list(range(100, 4000, 156))[:25]
FD_CASES = [
    (4, 512, 4, 1, 256, None, [0, 63, 64, 512]),
    (4, 512, 4, 1, 256, 40, [0, 39, 300, 512]),
    (3, 128, 2, 2, 128, None, [127, 0, 128]),
    (2, 256, 8, 2, 128, 16, [255, 17]),
    (2, 128, 4, 2, 64, 130, [5, 128]),
    (32, 1024, 4, 1, 256, None, [640] * 32),
    (32, 1024, 4, 1, 256, 512, [640] * 32),
    (32, 4096, 4, 1, 256, None, FD_RAGGED),
    (32, 4096, 4, 1, 256, 512, FD_RAGGED),
]


def _fd_inputs(B, S, Hq, Hkv, D, pos, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, D)) / 16).astype(np.float32)
    kv = [rng.integers(-127, 128, (B, S, Hkv, D)).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(1e-3, 3e-2, (B, S, Hkv)).astype(np.float32) for _ in range(2)]
    args = (q, kv[0], scales[0], kv[1], scales[1], np.asarray(pos, np.int32))
    return [torch.from_numpy(a).cuda() for a in args]


@pytest.mark.parametrize("case", FD_CASES,
                         ids=lambda c: f"B{c[0]}-S{c[1]}-{c[2]}on{c[3]}-D{c[4]}-w{c[5]}")
def test_flash_decode_kernel_matches_plain(case):
    """Kernel within 1e-4 of max|out| of its plain version: the same float32
    products, summed in another order; finite at the pos = S sentinel. The
    split and the cluster's merge are deterministic: a second launch gives
    the same bits."""
    _require_cuda()
    B, S, Hq, Hkv, D, window, pos = case
    args = _fd_inputs(B, S, Hq, Hkv, D, pos)
    before = flash_decode.launches
    got = flash_decode.flash_decode_int8(*args, window=window)
    again = flash_decode.flash_decode_int8(*args, window=window)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 2
    assert torch.equal(got, again)
    want = flash_decode.flash_decode_int8_reference(*args, window=window)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# (B, T, Hq, Hkv, D, window, dtype[, misaligned]): ragged T tiles, GQA, a
# window smaller than a tile, every head_dim the kernel is built for, a
# 2048-token window of Gemma-3-270M (local and global layers), and a bf16 q
# one element off a 16-byte boundary (the wrapper copies it for cp.async).
FA_CASES = [
    (2, 48, 2, 2, 128, None, torch.float32),
    (1, 130, 4, 1, 256, 40, torch.float32),
    (2, 100, 4, 2, 64, 7, torch.bfloat16),
    (1, 256, 4, 1, 256, None, torch.bfloat16),
    (1, 70, 2, 1, 32, 64, torch.bfloat16),
    (1, 2048, 4, 1, 256, 512, torch.bfloat16),
    (1, 2048, 4, 1, 256, None, torch.bfloat16),
    (1, 130, 4, 1, 128, 40, torch.bfloat16, "misaligned"),
]


def _fa_case_id(c):
    return (f"B{c[0]}-T{c[1]}-{c[2]}on{c[3]}-D{c[4]}-w{c[5]}-{str(c[6])[6:]}"
            + "".join(f"-{x}" for x in c[7:]))


def _fa_inputs(B, T, Hq, Hkv, D, dtype, misaligned=False):
    """q, k and v from a seed; v is read through the strides of a
    fused-projection slice, and q optionally one element past an aligned base."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, T, Hq, D)) / np.sqrt(D)).to("cuda", dtype)
    if misaligned:
        buf = torch.empty(q.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(q.reshape(-1))
        q = buf[1:].view(B, T, Hq, D)
        assert q.data_ptr() % 16 != 0
    kv = torch.from_numpy(rng.standard_normal((B, T, 2 * Hkv * D))).to("cuda", dtype)
    k = kv[..., :Hkv * D].reshape(B, T, Hkv, D).contiguous()
    v = kv[..., Hkv * D:].reshape(B, T, Hkv, D)  # strided view
    return q, k, v


def _assert_fa_close(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("case", FA_CASES, ids=_fa_case_id)
def test_flash_attention_kernel_matches_plain(case):
    """float32: within 1e-4 of max|out| (summation order), on the CUDA cores.
    bfloat16: within 1e-2 of max|out| (p is rounded to bf16 against the
    running max in the kernel and the row max in the plain version, and the
    output rounds to bf16), on the tensor cores."""
    _require_cuda()
    B, T, Hq, Hkv, D, window, dtype, *misaligned = case
    q, k, v = _fa_inputs(B, T, Hq, Hkv, D, dtype, bool(misaligned))
    before, routes = flash_attention.launches, dict(flash_attention.route_launches)
    got = flash_attention.flash_attention(q, k, v, sliding_window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    route = "mma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention.route_launches[route] == routes[route] + 1
    want = flash_attention.flash_attention_reference(q, k, v, sliding_window=window)
    _assert_fa_close(got, want, dtype)


# (B, T, Hq, Hkv, D, window, heads, key splits): the mma route's merge with
# one, two and four splits of a row slice, ragged T, GQA 4 and 8.
FA_SPLIT_CASES = [
    (1, 300, 4, 1, 256, None, 4, 1),
    (1, 300, 4, 1, 256, 100, 4, 2),
    (2, 200, 8, 2, 128, None, 2, 4),
    (1, 90, 8, 1, 64, 20, 1, 8),
]


@pytest.mark.parametrize("case", FA_SPLIT_CASES,
                         ids=lambda c: f"T{c[1]}-{c[2]}on{c[3]}-D{c[4]}-w{c[5]}-h{c[6]}x{c[7]}")
def test_flash_attention_mma_key_splits_match_plain(case):
    """Every key split merges to within 1e-2 of max|out| of the plain version."""
    _require_cuda()
    B, T, Hq, Hkv, D, window, heads, splits = case
    q, k, v = _fa_inputs(B, T, Hq, Hkv, D, torch.bfloat16)
    plan = flash_attention.mma_plan(B, T, Hq, D, heads, splits)
    got = flash_attention.launch(q, k, v, window, plan)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_reference(q, k, v, sliding_window=window)
    _assert_fa_close(got, want, torch.bfloat16)


TINY128 = dict(hidden_size=64, num_heads=2, num_kv_heads=1, head_dim=128, sliding_window=16,
               sliding_pattern=2)


def test_attention_kernels_in_model_and_engine_match_cpu():
    """A tiny float32 model on the card: use_flash=True launches one flash
    attention per layer and matches the CPU's einsum path within 1e-4 of the
    largest logit; a fused-attention engine launches one flash decode per
    layer per one-token forward and matches the CPU's unfused engine within
    JAX's own bar (atol 2e-4, rtol 1e-4), greedy tokens equal."""
    _require_cuda()
    model = Gemma3(Gemma3Config.tiny(**TINY128))
    params = model.init(torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to("cuda"), params)
    ids = np.random.default_rng(0).integers(0, 256, (2, 48)).astype(np.int32)
    model.use_flash = True
    before = flash_attention.launches
    flash = model(on_card, torch.from_numpy(ids).long().cuda())
    torch.cuda.synchronize()
    assert flash_attention.launches == before + model.cfg.num_layers
    model.use_flash = False
    dense = model(params, torch.from_numpy(ids).long())
    model.use_flash = "auto"
    assert (flash.cpu() - dense).abs().max().item() <= 1e-4 * dense.abs().max().item()

    def run(p, fused):
        eng = InferenceEngine(model, p, max_batch=2, max_seq=128, kv_quant=True,
                              fused_attention=fused)
        cache, logits = eng.prefill(eng.new_cache(), ids[:, :20], np.array([20, 11], np.int32))
        before = flash_decode.launches
        cache, toks = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
        _, last = eng.decode(cache, toks[:, -1])
        return toks.cpu(), last.float().cpu(), flash_decode.launches - before

    card_toks, card_logits, launched = run(on_card, True)
    cpu_toks, cpu_logits, _ = run(params, False)
    assert launched == 7 * model.cfg.num_layers
    assert torch.equal(card_toks, cpu_toks)
    np.testing.assert_allclose(card_logits.numpy(), cpu_logits.numpy(), atol=2e-4, rtol=1e-4)


# (weight dtype, symmetric, strategy, K, N, x shape, bias): QLINEAR sites.
Q8_CASES = [
    ("int8", True, "channel", 640, 1024, (32,), False),  # the 270M q_proj at decode
    ("int8", True, "channel", 2048, 640, (4, 33), True),  # down, ragged M, an int32 bias
    ("uint8", False, "tensor", 100, 128, (7,), True),  # a ragged K chunk, zero points
    ("uint8", True, "channel", 1000, 256, (65,), False),  # uint8 symmetric (zp 128)
    # N % 128 != 0 takes the kernel too (N % 4 != 0: one column a thread).
    ("int8", True, "channel", 640, 40, (32,), False),
    ("uint8", False, "channel", 100, 100, (7,), True),
    ("int8", True, "tensor", 640, 130, (3, 11), True),
    # Q8's launch plan: the 270M k site at decode (32-column tiles, K split to
    # single slices), q at a 32x128 prefill (128 x 128 tiles, no split), and a
    # ragged tile edge at N = 208 with zero points and a bias.
    pytest.param(("int8", True, "channel", 640, 256, (32,), False), id="q8-route-k-640x256-M32"),
    pytest.param(("int8", True, "channel", 640, 1024, (32, 128), False),
                 id="q8-route-q-640x1024-M4096"),
    pytest.param(("uint8", False, "channel", 640, 208, (5,), True), id="q8-route-640x208-M5"),
]


def _q8_site(dtype, symmetric, strategy, K, N, with_bias, seed=0):
    """A QLINEAR site on the CPU: RTN weights, static uint8 activation
    qparams from the ranges of a sample, and an int32 bias."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((0.1 * rng.standard_normal((K, N))).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    args = oqt.QWeightArgs(dtype=dtype, group_size=-1 if strategy == "channel" else None,
                           symmetric=symmetric)
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, -1, symmetric, False)
    y = x @ w
    xs, ys = (x.max() - x.min()) / 255, (y.max() - y.min()) / 255
    static = ActQuantSpec(mode="static", dtype="uint8")
    qt = make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy, group_size=-1,
                      symmetric=symmetric, reduce_range=False, fmt=QFormat.QLINEAR,
                      input_quant=static, output_quant=static, input_scale=xs,
                      input_zero_point=torch.tensor(128, dtype=torch.uint8), output_scale=ys,
                      output_zero_point=torch.round(-y.min() / ys).clamp(0, 255).to(torch.uint8))
    bias = None
    if with_bias:
        b_q, b_s, _ = quantize_bias(0.1 * torch.from_numpy(rng.standard_normal(N).astype(
            np.float32)), xs, s)
        bias = QBias(b_q, b_s, torch.tensor(0, dtype=torch.int32), "int32")
    return qt, bias


@pytest.mark.parametrize("case", Q8_CASES, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}x{c[4]}")
def test_q8_kernel_bit_equal_to_plain_and_oracle(case):
    """Integer dots, then one rounded operation at a time in the oracle's
    order: the kernel equals its plain version on the card and the CPU
    oracle bit for bit, for float32 and bfloat16 x, on the route its plan
    names (mma when N % 16 == 0, else simt). A second launch gives the same
    bits, and the K split's counters are back at 0 after each launch."""
    _require_cuda()
    dtype, sym, strategy, K, N, xshape, with_bias = case
    qt, bias = _q8_site(dtype, sym, strategy, K, N, with_bias)
    card_qt, card_bias = qt.to("cuda"), None if bias is None else bias.to("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = matmul_q8.q8_plan(int(np.prod(xshape)), K, N, sms)
    assert plan.route == ("mma" if N % 16 == 0 else "simt")
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(xshape + (K,)).astype(
            np.float32)).to(xdt)
        before = matmul_q8.launches
        got = quantized_matmul(x.cuda(), card_qt, card_bias)
        again = quantized_matmul(x.cuda(), card_qt, card_bias)
        torch.cuda.synchronize()
        assert matmul_q8.launches == before + 2
        assert torch.equal(got, again)
        assert all(not counters.any() for _, counters in SPLIT_SCRATCH.values())
        plain = matmul_q8.q8_matmul_plain(*matmul_q8.q8_operands(x.cuda(), card_qt, card_bias))
        assert torch.equal(got, plain.reshape(got.shape))
        assert torch.equal(got.cpu(), _qlinear_matmul(x, qt, bias))


# (K, intermediate, group size, dtype, M, x dtype): the 270M MLP at decode,
# one row, M = 256 (two passes of 32 rows beyond the predicate's cap here),
# and a ragged gate-up group with signed nibbles.
MLP_CASES = [
    (640, 2048, 128, "uint4", 32, torch.bfloat16),
    (640, 2048, 128, "uint4", 1, torch.float32),
    (640, 2048, 128, "uint4", 256, torch.bfloat16),
    (192, 256, 64, "int4", 5, torch.float32),
]


@pytest.mark.parametrize("case", MLP_CASES,
                         ids=lambda c: f"K{c[0]}-I{c[1]}-g{c[2]}-{c[3]}-M{c[4]}-{str(c[5])[6:]}")
def test_mlp_w4_kernel_matches_plain(case):
    """The fused MLP against its plain version on the card: float32 within
    1e-4 of max|y| (summation order); bfloat16 within 1e-2 (act rounds to
    bf16 between the products, where an input one ulp apart can round the
    other way). Two launches give the same bits (the reduction is
    deterministic)."""
    _require_cuda()
    K, inter, gs, dtype, M, xdt = case
    gu = _qtensor(dtype, gs, dtype == "int4", K, 2 * inter, seed=2)
    dn = _qtensor(dtype, gs, dtype == "int4", inter, K, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((M, K)).astype(
        np.float32)).to("cuda", xdt)
    ops, kw = mlp_w4.mlp_w4_operands(x, gu.to("cuda"), dn.to("cuda"))
    before = mlp_w4.launches
    got = mlp_w4.mlp_w4(*ops, **kw)
    again = mlp_w4.mlp_w4(*ops, **kw)
    torch.cuda.synchronize()
    assert mlp_w4.launches == before + 2
    assert torch.equal(got, again)
    want = mlp_w4.mlp_w4_plain(*ops, **kw)
    tol = 1e-4 if xdt == torch.float32 else 1e-2
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


TINY_Q8 = dict(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2, num_kv_heads=1,
               head_dim=128, vocab_size=512)


def test_q8_engine_on_card_equals_plain_and_counts_launches(monkeypatch):
    """A tiny float32 QLINEAR model (every N a multiple of 128), calibrated on
    the CPU: on the card, one Q8 launch per site (7 a layer) and one W8 for
    the head per forward; logits and greedy tokens equal to the same engine
    on the card with Q8 swapped for its plain version."""
    _require_cuda()
    cfg = Gemma3Config.tiny(**TINY_Q8)
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calib = np.random.default_rng(7).integers(1, cfg.vocab_size, (8, 16)).astype(np.int32)
    act = oqt.QActivationArgs(dtype="uint8", is_static=True)
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        input_activations=act, output_activations=act, format="qlinear",
        calibration_data=calib, ignore=["lm_head"]))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    on_card = tree_map(lambda t: t.to("cuda"), fuse_gemma3_projections(params))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)
    lengths = np.array([12, 9, 15, 3], np.int32)

    def run():
        eng = InferenceEngine(model, on_card, max_batch=4, max_seq=32, kv_quant=True)
        before = matmul_q8.launches, matmul_w8.launches
        cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
        cache, toks = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
        torch.cuda.synchronize()
        return logits, toks, (matmul_q8.launches - before[0], matmul_w8.launches - before[1])

    logits, toks, launched = run()
    assert launched == (7 * cfg.num_layers * 7, 7)
    monkeypatch.setattr(matmul_q8, "q8_matmul", matmul_q8.q8_matmul_plain)
    plain_logits, plain_toks, plain_launched = run()
    assert plain_launched == (0, 7)
    assert torch.equal(logits, plain_logits) and torch.equal(toks, plain_toks)


def test_mlp_megakernel_on_card_counts_launches():
    """A tiny float32 W4 model with ``mlp_megakernel=True``: per decode step
    one fused MLP launch per layer, two W4 (qkv, o) and one W8; prefill
    (M = 60) is eligible too. Logits within 1e-4 of max logit of the CPU
    run, greedy tokens equal. With "auto", no fused MLP launches."""
    _require_cuda()
    cfg = Gemma3Config.tiny(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
                            num_kv_heads=1, head_dim=64, vocab_size=512)
    model = Gemma3(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=64), ignore=["lm_head"]))
    params, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    params = fuse_gemma3_projections(params)
    on_card = tree_map(lambda t: t.to("cuda"), params)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 15)).astype(np.int32)
    lengths = np.array([12, 9, 15, 3], np.int32)
    modules = (mlp_w4, matmul_w4, matmul_w8)

    def run(p, mega):
        eng = InferenceEngine(model, p, max_batch=4, max_seq=32, kv_quant=True,
                              mlp_megakernel=mega)
        cache, logits = eng.prefill(eng.new_cache(), ids, lengths)
        before = [m.launches for m in modules]
        cache, toks = eng.decode_multi(cache, torch.argmax(logits, -1), steps=6)
        launched = tuple(m.launches - b for m, b in zip(modules, before))
        return logits.float().cpu(), toks.cpu(), launched

    cpu_logits, cpu_toks, _ = run(params, True)
    gpu_logits, gpu_toks, launched = run(on_card, True)
    assert launched == (cfg.num_layers * 6, 2 * cfg.num_layers * 6, 6)
    assert (gpu_logits - cpu_logits).abs().max().item() <= 1e-4 * cpu_logits.abs().max().item()
    assert torch.equal(gpu_toks, cpu_toks)
    _, _, launched = run(on_card, "auto")
    assert launched == (0, 4 * cfg.num_layers * 6, 6)
