#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``onnx_quantize_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; each prints its seconds):

1. Device: a CUDA device is required; prints the card's name and power limit
   and turns TF32 off for float32 matmuls and convolutions.
2. Build: compiles the Hopper kernels from ``onnx_quantize_tpu_torch/csrc``.
3. Kernels: each kernel against its plain PyTorch version on the card, timed
   with CUDA events (each call alone, L2 flushed, behind a device spin that
   covers the host's dispatch). W4/W8 and W4A8/W8A8 at the main path's shapes (a decode
   step, M=32, and a 32x128 prefill, M=4096) and at odd shapes (ragged M and
   N, a pad group, signed and unsigned weights, uint8 shifted by 128, group
   tiles, a tile past 1024 rows), in bfloat16 and float32, and the lm_head
   at a scoring window's M=2048. W4 also at M = 1, 16, 33, 64, 65 and 2048
   (every route of its launch plan: tensor-core mma with and without the K
   split, the CUDA-core route), timed at M=32 and 2048; W8 on the lm_head
   also at a scoring window's M=2048, and on its mma route with a K split at
   odd shapes. Every case prints its launch plan and gives the same bits
   twice; W8, W4A8 and W8A8 take the route their plan names, and W4A8 and
   W8A8 give their plain versions' bits (K-split counters, and W4A8's
   scratch, back at 0). Yardsticks the port never calls, on the same
   operands: ``torch._weight_int4pack_mm`` (W4 body sites),
   ``torch._weight_int8pack_mm`` (W8 lm_head), dequantize-then-
   ``torch.matmul`` in bf16 (W4 at M=2048, W8 at M=32 and 2048), and
   ``torch._int_mm`` (W8A8 lm_head at M=32 and 2048, and the int32 cores of
   W4A8, on the nibbles widened to int8, and of Q8). Q8 (QLINEAR) on one layer's seven
   site shapes at M=32 and 4096 and at odd shapes (ragged M, K=100 and
   1000, N = 40, 100 and 130, int8 and uint8 weights, symmetric and not, per
   tensor and per channel, with and without an int32 bias), bit-equal to its
   plain version and twice the same bits, each case's launch plan printed
   (s8 tensor-core mma with and without the K split, the CUDA-core route),
   the seven sites timed at M=32 and 4096 beside ``torch._int_mm``.
   The fused W4 MLP at the 270M widths (M=32, 1, 256) and a ragged-K int4
   case, timed beside the unfused W4 gate_up, GeGLU, W4 down it replaces.
   Flash
   decode at B=32, S=4096, 4 query heads on 1 KV head of 256, ragged
   positions (0, tile edges, the pos = S sentinel), window 512 and none, odd
   shapes, each with its launch plan's split of the live range (a cluster of
   up to 8 blocks) printed, twice with the same bits; timed at B=32, S=1024,
   pos=640. Flash attention at T=S=2048 and
   512 in bfloat16, ragged bf16 shapes (D = 32, 64, 128; GQA 2 and 4; two KV
   heads), window 512 and none, and an odd float32 shape: the wrapper's route
   (bf16 on the tensor cores, float32 on the CUDA cores) against the plain
   version, each case's launch plan printed; at T=2048 the kernel, the plain
   version and SDPA timed per layer and per window. ptxas' registers and
   spills of every kernel are printed after the build.
4. Main path: Gemma-3-270M at full width in bfloat16 from a seeded init, W4
   g128 body plus int8 per-channel lm_head, fused q/k/v and gate/up, an int8
   KV cache at B=32 and max_seq=512: prefill 32 prompts of 128 tokens, 64
   greedy decode steps, then ``generate`` on 3 ragged prompts. Checks the
   kernel launch counts, finite logits, tokens in range, and prefill logits
   against the same engine with the kernels swapped for their plain versions.
   Then the A8 arm: ``convert_to_w4a8`` of the same tree (W4A8 on every body
   site, W8A8 on the lm_head), through the same sequence and checks, which
   for it require logits and greedy tokens equal to the plain run's. In
   every arm each W8, W4A8 and W8A8 launch is on the tensor-core route. Then
   the Q8 arm: the body calibrated on the card (8x128 seeded token ids) and
   quantized QLINEAR (int8 per-channel weights, static uint8 activations),
   the int8 weight-only lm_head, fusion (which leaves every QLINEAR site
   unfused): 126 Q8 and 1 W8 launches per forward, logits and greedy tokens
   equal to the run with only Q8 plain. Then the MLP arm: the W4 tree
   through ``mlp_megakernel=True``, 18 fused-MLP, 36 W4 and 1 W8 launches
   per decode step (prefill at M=4096 stays on W4), prefill logits within
   5% of the plain run.
5. Rates: decode tokens/s for the quantized arm, the same with flash decode
   (``fused_attention=True``), the W4A8 arm, the Q8 arm, the quantized arm
   with the fused MLP and an unquantized bf16 arm, by
   the slope between two step counts timed with CUDA events; the arms take
   turns, and each reports the median of 5 samples.
6. Window scoring: ``perplexity_from_tokens`` of the phase-4 model over a
   seeded 4096-token stream (windows of 2048, stride 512: 5 windows), which
   runs flash attention in every layer. Checks the launch counts per window,
   a finite result, and the mean NLL against the same run with every kernel
   swapped for its plain version, for the W4 and the A8 model, every W8, W4A8
   and W8A8 launch on the tensor-core route; for the A8 model also an equal
   ppl with only its two matmul kernels swapped; prints
   the bf16 model's ppl beside them.
7. Decode-path scoring: ``score_nll`` of 32 seeded rows of 640 tokens through
   an engine with an int8 cache and ``fused_attention=True`` (flash decode in
   every layer of every one-token forward, past the 512-token window).
   Checks the launch counts and the NLL against ``fused_attention=False``;
   prints ``score_ppl`` for the float, int8 and int4 caches and steps/s.

The run ends by counting the kernels the activation quantizer and one whole
site launch, and by profiling decode steps of the W4, A8, Q8 and MLP arms
and one scoring window of the W4 model (``torch.profiler``: launches, device
busy time, idle share, the matmul kernels' share). The line
before the last is a JSON object
of per-kernel results, each with the least time the card could take for the
same work (``bound_ms``); the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): the least
# time for a kernel's work is the larger of its bytes over the memory rate
# and its operations over the peak for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "float32": 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# Device cycles (~0.25 ms) of a spin queued before each timed call, so that
# the card is still busy when the host has queued the call's launches and the
# events time the device work alone, not the host's dispatch.
HOST_COVER_CYCLES = 500_000


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn``, each call timed alone with CUDA
    events after a 256 MB write that evicts the 50 MB L2 (a decode step finds
    its weights cold, since a step streams more weight bytes than L2 holds)
    and a device spin that covers the host's dispatch."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# -- phase 3: kernels against their plain versions -----------------------------

def random_qtensor(K: int, N: int, dtype: str, group_size: int, symmetric: bool, gen,
                   a8: bool = False):
    """An RTN-quantized random (K, N) weight on the card (``a8``: with dynamic
    int8 activations), scales baked as the engine bakes them."""
    from onnx_quantize_tpu_torch.algorithms import rtn_quantize
    from onnx_quantize_tpu_torch.core.qconfig import QWeightArgs
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.plan import resolve_group_size

    args = QWeightArgs(dtype=dtype, group_size=group_size, symmetric=symmetric)
    gs = resolve_group_size(K, group_size) or -1
    w = 0.1 * torch.randn((K, N), generator=gen, device="cuda")
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, gs, symmetric, False)
    tree = {"w": make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy,
                              group_size=gs, symmetric=symmetric, reduce_range=False)}
    return prepare_kernel_scales(convert_to_w4a8(tree) if a8 else tree)["w"]


def kernel_operands(kernel: str, qt, x):
    """(wrapper, plain version, operands, keyword args) of ``kernel`` for
    ``x @ dequant(qt)`` (the A8 kernels take x quantized to int8)."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w4a8, matmul_w8, matmul_w8a8

    wrapper, plain, operands = {
        "w4": (matmul_w4.w4_matmul, matmul_w4.w4_dequant_matmul_plain, matmul_w4.w4_operands),
        "w8": (matmul_w8.w8_matmul, matmul_w8.w8_dequant_matmul_plain, matmul_w8.w8_operands),
        "w4a8": (matmul_w4a8.w4a8_matmul, matmul_w4a8.w4a8_matmul_plain,
                 matmul_w4a8.w4a8_operands),
        "w8a8": (matmul_w8a8.w8a8_matmul, matmul_w8a8.w8a8_matmul_plain,
                 matmul_w8a8.w8a8_operands),
    }[kernel]
    return (wrapper, plain, *operands(x, qt))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    """(least milliseconds, what bounds them) for work of ``bytes_moved`` bytes
    and ``ops`` operations of type ``kind`` on the card."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def int_mm_ms(x_q, data, iters: int = 50) -> tuple[float, torch.Tensor]:
    """Milliseconds of ``torch._int_mm`` on the W8A8 kernel's int8 operands (a
    yardstick: the port never calls it), and its int32 product."""
    return cuda_time_ms(lambda: torch._int_mm(x_q, data), iters), torch._int_mm(x_q, data)


def int4pack_ms(x, qt, iters: int = 50) -> tuple[float, torch.Tensor]:
    """Milliseconds and bf16 output of ``torch._weight_int4pack_mm`` (a
    yardstick: the port never calls it) for ``x @ dequant(qt)``, a packed
    uint4 weight with baked scales. Its dequant is ``(q - 8) * s + zero``,
    so ``zero = (8 - zp) * s``; scales and zeros are held in bf16."""
    K, N = qt.meta.shape
    gs = qt.meta.pack_group
    data = qt.data.reshape(-1, gs, N)
    codes = torch.stack([data & 0x0F, data >> 4], dim=1).reshape(-1, N)[:K]  # (K, N)
    s, z = (t.reshape(-1, N)[:K // gs] for t in (qt.scale, qt.zero_point))
    w = codes.t().to(torch.int32)  # (N, K)
    packed = torch._convert_weight_to_int4pack(
        ((w[:, ::2] << 4) | w[:, 1::2]).to(torch.uint8).contiguous(), 8)
    s_and_z = torch.stack([s, (8.0 - z) * s], dim=-1).to(torch.bfloat16).contiguous()
    xb = x.to(torch.bfloat16)

    def call():
        return torch._weight_int4pack_mm(xb, packed, gs, s_and_z)

    return cuda_time_ms(call, iters), call()


def int8pack_ms(x, qt, iters: int = 50) -> tuple[float, torch.Tensor]:
    """Milliseconds and bf16 output of ``torch._weight_int8pack_mm`` (a
    yardstick: the port never calls it) for ``x @ dequant(qt)``, a symmetric
    int8 per-channel weight; the scales are held in bf16."""
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w8 import w8_scale_rows

    _, scale_rows, _ = w8_scale_rows(qt)
    w = qt.data.t().contiguous()  # (N, K) int8
    scales = scale_rows.reshape(-1).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)

    def call():
        return torch._weight_int8pack_mm(xb, w, scales)

    return cuda_time_ms(call, iters), call()


# The bf16 yardsticks of the weight-only kernels, timed at M=32.
BF16_LIBRARY = {"w4": ("_weight_int4pack_mm", int4pack_ms),
                "w8": ("_weight_int8pack_mm", int8pack_ms)}

# W4 rows of M: decode sizes around the plan's tile edges (the K split), a
# scoring window (2048) and a 32x128 prefill (4096), both without a split.
W4_ROWS = (1, 16, 32, 33, 64, 65, 2048, 4096)
# name, kernel, K, N, dtype, group_size, symmetric, rows of M, timed
KERNEL_CASES = [
    ("qkv", "w4", 640, 1536, "uint4", 128, False, W4_ROWS, True),
    ("o", "w4", 1024, 640, "uint4", 128, False, W4_ROWS, True),
    ("gate_up", "w4", 640, 4096, "uint4", 128, False, W4_ROWS, True),
    ("down", "w4", 2048, 640, "uint4", 128, False, W4_ROWS, True),
    ("lm_head", "w8", 640, 262144, "int8", -1, True, (32, 2048), True),
    # Odd shapes: 5 groups padded to 6 and a ragged N edge; ragged M tiles;
    # int4; 4 columns per thread with a ragged edge; int4 g64 with a pad
    # group and a ragged tile edge (W4's mma route); N % 16 != 0 and channel
    # scales over K = 130 (gs 65), both on W4's CUDA-core route in bf16 too;
    # uint8 with zero points.
    ("odd_w4_u4_k320_g64_n200", "w4", 320, 200, "uint4", 64, False, (5, 37), False),
    ("odd_w4_i4_sym_n20000", "w4", 640, 20000, "int4", 128, True, (3, 70), False),
    ("odd_w4_i4_k448_g64_n1008", "w4", 448, 1008, "int4", 64, True, (3, 40), False),
    ("odd_w4_u4_n130", "w4", 640, 130, "uint4", 128, False, (5, 33), False),
    ("odd_w4_u4_channel_k130", "w4", 130, 128, "uint4", -1, False, (4,), False),
    ("odd_w8_i8_n40004", "w8", 640, 40004, "int8", -1, True, (5, 33), False),
    ("odd_w8_u8_asym_n1000", "w8", 640, 1000, "uint8", -1, False, (7, 65), False),
    ("odd_w8_u8_g128", "w8", 640, 999, "uint8", 128, False, (31,), False),
    # W8's mma route with a K split: g32 tiles that the splits straddle
    # (ragged M and N tile edges) and an int8 channel scale.
    ("odd_w8_u8_asym_g32_n1008", "w8", 640, 1008, "uint8", 32, False, (5, 70), False),
    ("odd_w8_i8_n1008", "w8", 640, 1008, "int8", -1, True, (33,), False),
    # The x-stationary form with a zero point (two warps along M) and at
    # K = 1024 (64 resident x rows), with ragged M and N edges.
    ("odd_w8_u8_asym_n65552", "w8", 640, 65552, "uint8", -1, False, (400,), False),
    ("odd_w8_i8_k1024_n65552", "w8", 1024, 65552, "int8", -1, True, (200,), False),
    # The A8 arm's sites (dynamic int8 activations): W4A8 on the body, W8A8
    # on the lm_head, also at a scoring window's M=2048; then odd shapes: a
    # pad group with a ragged N, int4 with ragged M, uint8 symmetric (shifted
    # by 128), group tiles, 4 columns per thread at M > 32 with a ragged
    # edge, a tile of 1100 rows (past the plain version's exact chunks; W8A8's
    # mma route pads x to 1104), and uint8 g128 tiles with ragged M and N
    # edges on W8A8's mma route; W4A8's mma route with a K split (g32, and
    # int4 g64 with a pad group).
    ("qkv", "w4a8", 640, 1536, "uint4", 128, False, (32, 4096), True),
    ("o", "w4a8", 1024, 640, "uint4", 128, False, (32, 4096), True),
    ("gate_up", "w4a8", 640, 4096, "uint4", 128, False, (32, 4096), True),
    ("down", "w4a8", 2048, 640, "uint4", 128, False, (32, 4096), True),
    ("lm_head", "w8a8", 640, 262144, "int8", -1, True, (32, 2048), True),
    ("odd_w4a8_u4_k320_g64_n200", "w4a8", 320, 200, "uint4", 64, False, (5, 37), False),
    ("odd_w4a8_i4_sym_n20000", "w4a8", 640, 20000, "int4", 128, True, (3, 70), False),
    ("odd_w4a8_u4_g32_n1008", "w4a8", 640, 1008, "uint4", 32, False, (5, 70), False),
    ("odd_w4a8_i4_g64_k448_n208", "w4a8", 448, 208, "int4", 64, True, (3, 40), False),
    ("odd_w8a8_u8_sym_n1000", "w8a8", 640, 1000, "uint8", -1, True, (7, 65), False),
    ("odd_w8a8_i8_g128_n999", "w8a8", 640, 999, "int8", 128, True, (31,), False),
    ("odd_w8a8_i8_n40004", "w8a8", 640, 40004, "int8", -1, True, (5, 33), False),
    ("odd_w8a8_i8_k1100", "w8a8", 1100, 256, "int8", -1, True, (9, 40), False),
    ("odd_w8a8_u8_sym_g128_n1008", "w8a8", 640, 1008, "uint8", 128, True, (37, 70), False),
]

# Why these tolerances: kernel and plain version read the same inputs and form
# the same float32 products (a bf16 input times a small integer is exact in
# float32), so they differ only in the order of float32 sums over K <= 2048
# terms; 1e-4 of the output's largest magnitude bounds that for either dtype.
# The A8 kernels' integer partials are exact on both sides (int32 in the
# kernel, float32 below 2^24 in the plain version), and their float32
# epilogue runs the plain version's rounded operations in its order, so they
# agree bit for bit; the same 1e-4 is their bar, and W4A8 and W8A8 (either
# route of their plans) must also give their plain versions' bits exactly,
# twice.
REL_TOL = 1e-4
# The operands' type for the operation peak: bf16 x for W4/W8, int8 for A8.
MATMUL_KIND = {"w4": "bf16", "w8": "bf16", "w4a8": "int8", "w8a8": "int8"}
# The bf16 yardsticks (_weight_int4pack_mm, _weight_int8pack_mm) hold scales,
# zeros and the output in bf16 (2^-9 relative each), where the kernels keep
# float32: 2e-2 of the largest output bounds that, and a wrong layout or
# zero-point convention misses it by far.
LIBRARY_BF16_REL_TOL = 2e-2


def dequant_matmul_ms(x, qt) -> tuple[float, float, torch.Tensor]:
    """"Dequantize once, then ``torch.matmul`` in bf16" for ``x @ dequant(qt)``
    (a yardstick for large M: the port never calls it): milliseconds of the
    matmul on the dequantized bf16 weight, milliseconds of the one-time
    dequantize, and the output."""
    from onnx_quantize_tpu_torch.ops.reference import dequantize_weight

    xb = x.to(torch.bfloat16)
    dq_ms = cuda_time_ms(lambda: dequantize_weight(qt).to(torch.bfloat16), 5)
    wb = dequantize_weight(qt).to(torch.bfloat16)
    return cuda_time_ms(lambda: torch.matmul(xb, wb), 50), dq_ms, torch.matmul(xb, wb)


# W4 and W8 are timed at a decode step (M=32) and a scoring window (M=2048).
W4_TIMED = (32, 2048)
# Calls of _weight_int8pack_mm timed at M=2048 (it took 11.9 ms at M=32).
INT8PACK_ITERS_M2048 = 3


def kernel_plan(kernel: str, M: int, K: int, N: int, kw, xdt, sms: int):
    """The launch plan the wrapper of ``kernel`` makes for x (M, K) of
    ``xdt`` (as the wrapper takes it: padded, or quantized for the A8 kernels)
    against N weight columns."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w4a8, matmul_w8, matmul_w8a8

    if kernel == "w4":
        return matmul_w4.w4_plan(M, K, N, kw["gs"], xdt, sms)
    if kernel == "w8":
        return matmul_w8.w8_plan(M, K, N, kw["bk"], xdt, sms)
    if kernel == "w4a8":
        return matmul_w4a8.w4a8_plan(M, K, N, kw["gs"], sms)
    return matmul_w8a8.w8a8_plan(M, K, N, sms, kw["bk"])


def widened_int8(data, gs: int, signed: bool):
    """Packed group-pair nibbles (K_pad/2, N) as the logical (K_pad, N) int8
    weight: the operand of the int32 core on W4A8's codes."""
    half_rows, N = data.shape
    w = data.reshape(half_rows // gs, gs, N)
    nib = torch.stack([w & 0x0F, w >> 4], dim=1).to(torch.int8)  # (pairs, 2, gs, N)
    if signed:
        nib = torch.where(nib > 7, nib - 16, nib)
    return nib.reshape(2 * half_rows, N).contiguous()


def split_scratch_clear() -> bool:
    """Every K-split counter is back at 0, and W4A8's partials too."""
    from onnx_quantize_tpu_torch.ops.kernels import SPLIT_SCRATCH

    return all(not counters.any() and (key[2] != "W4A8Plan" or not parts.any())
               for key, (parts, counters) in SPLIT_SCRATCH.items())


def run_kernel_checks(gen) -> dict:
    """W4/W8/W4A8/W8A8 against their plain versions, each case's launch plan
    printed; the M=32 numbers go to the kernels line; W4 (a layer's four
    sites), W8 and W8A8 (the lm_head) also at M=2048
    (``results[kernel]["m2048"]``), W4A8 (a layer's four sites) at M=4096
    (``results["w4a8"]["m4096"]``), beside their bounds and yardsticks. Every
    kernel must give the same bits twice, and W8/W4A8/W8A8 take the route
    their plan names; W4A8 and W8A8 must give their plain versions' bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
                   "library_ms": None} for k in MATMUL_KIND}
    big = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bf16_matmul_ms": 0.0,
               "dequant_ms": 0.0, "bytes": 0, "ops": 0} for k in BF16_LIBRARY}
    big_a8 = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
              for k in ("w8a8", "w4a8")}
    for name, kernel, K, N, dtype, gs, sym, rows, timed in KERNEL_CASES:
        qt = random_qtensor(K, N, dtype, gs, sym, gen, a8=kernel in ("w4a8", "w8a8"))
        module = kernel_modules()[kernel]
        for M in rows:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                wrapper, plain, ops, kw = kernel_operands(kernel, qt, x)
                routes = dict(getattr(module, "route_launches", {}))
                y = wrapper(*ops, **kw)
                again = wrapper(*ops, **kw)
                ref = plain(*ops, **kw)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                scale = ref.abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{name} M={M} {xdt}: non-finite output")
                check(err <= REL_TOL * scale,
                      f"{name} M={M} {xdt}: max abs err {err:.3e} > {REL_TOL} * {scale:.3e}")
                check(torch.equal(again, y), f"{name} M={M} {xdt}: two {kernel} launches differ")
                plan = kernel_plan(kernel, M, ops[0].shape[1], N, kw, xdt, sms)
                line = (f"kernel {kernel} {name} M={M} x={str(xdt)[6:]}: max_abs_err={err:.3e} "
                        f"plan={plan.route} {plan.bm}x{plan.bn} "
                        f"splits={getattr(plan, 'splits', 1)} blocks={plan.blocks}")
                if routes:
                    check(module.route_launches[plan.route] == routes[plan.route] + 2,
                          f"{name} M={M}: {kernel} did not take its plan's {plan.route} route")
                if kernel in ("w4a8", "w8a8"):
                    check(torch.equal(y, ref), f"{name} M={M} {xdt}: {kernel} is not bit-equal "
                                               "to its plain version twice")
                    line += " bits=equal"
                check(split_scratch_clear(), f"{name} M={M}: K-split scratch not back at 0")
                res = results[kernel]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if (timed and xdt == torch.bfloat16
                        and (kernel != "w4" or M in W4_TIMED)):
                    iters = 50 if M <= 32 else 20
                    ms = cuda_time_ms(lambda: wrapper(*ops, **kw), iters)
                    plain_ms = cuda_time_ms(lambda: plain(*ops, **kw), iters)
                    line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                    if M == 32:  # one decode step's shapes
                        res["ms"] += ms
                        res["plain_ms"] += plain_ms
                        res["bytes"] += nbytes(*ops, y)
                        res["ops"] += 2 * M * K * N
                    if kernel in ("w4a8", "w8a8") and M == 32:
                        # The plain-torch activation quantizer each A8 site runs first.
                        from onnx_quantize_tpu_torch.ops.kernels.matmul_w4a8 import (
                            quantize_activation_int8,
                        )

                        q_ms = cuda_time_ms(lambda: quantize_activation_int8(x), iters)
                        line += f" quantizer_ms={q_ms:.4f}"
                    if kernel in ("w4a8", "w8a8"):
                        if kernel == "w8a8":
                            lib_ms, ref32 = int_mm_ms(ops[0], ops[2], iters)
                            lib = ref32.float() * (ops[1] * ops[3])  # scaled as the kernel does
                            lib_err = (lib - y).abs().max().item()
                            del ref32, lib
                            check(lib_err <= REL_TOL * scale,
                                  f"{name} M={M}: _int_mm disagrees by {lib_err:.3e}")
                            line += f" int_mm_ms={lib_ms:.4f} int_mm_err={lib_err:.3e}"
                        else:
                            # The int32 core on the same codes: x_q against the
                            # nibbles widened to an int8 (K_pad, N) weight.
                            w8 = widened_int8(ops[2], kw["gs"], kw["signed"])
                            lib_ms, ref32 = int_mm_ms(ops[0], w8, iters)
                            exact = (ops[0].double() @ w8.double()).to(torch.int32)
                            check(torch.equal(ref32, exact),
                                  f"{name} M={M}: _int_mm disagrees with the exact integer dot")
                            del w8, ref32, exact
                            line += f" int_mm_int32_core_ms={lib_ms:.4f}"
                        if M == 32:
                            res["library_ms"] = (res["library_ms"] or 0.0) + lib_ms
                        else:  # a scoring window's lm_head; a 32x128 prefill's sites
                            acc = big_a8[kernel]
                            acc["ms"] += ms
                            acc["plain_ms"] += plain_ms
                            acc["library_ms"] += lib_ms
                            acc["bytes"] += nbytes(*ops, y)
                            acc["ops"] += 2 * M * K * N
                    if kernel in BF16_LIBRARY and M in W4_TIMED:
                        op, lib_fn = BF16_LIBRARY[kernel]
                        lib_ms, lib = lib_fn(x, qt, INT8PACK_ITERS_M2048
                                             if kernel == "w8" and M == 2048 else 50)
                        lib_err = (lib.float() - y).abs().max().item()
                        check(lib_err <= LIBRARY_BF16_REL_TOL * scale,
                              f"{name} M={M}: {op} disagrees by {lib_err:.3e}")
                        line += f" {op}_ms={lib_ms:.4f} {op}_err={lib_err:.3e}"
                        if M == 32:
                            res["library_ms"] = (res["library_ms"] or 0.0) + lib_ms
                    if kernel in BF16_LIBRARY and (M == 2048 or kernel == "w8" and M == 32):
                        mm_ms, dq_ms, dq = dequant_matmul_ms(x, qt)
                        dq_err = (dq.float() - y).abs().max().item()
                        check(dq_err <= LIBRARY_BF16_REL_TOL * scale,
                              f"{name} M={M}: dequantize-then-matmul disagrees by {dq_err:.3e}")
                        line += (f" bf16_matmul_ms={mm_ms:.4f} (after a one-time dequantize of "
                                 f"{dq_ms:.4f} ms) dequant_matmul_err={dq_err:.3e}")
                        del dq
                    if M == 32 and kernel == "w8":
                        res["bf16_matmul_ms"], res["dequant_ms"] = mm_ms, dq_ms
                    if kernel in BF16_LIBRARY and M == 2048:
                        acc = big[kernel]
                        acc["ms"] += ms
                        acc["plain_ms"] += plain_ms
                        acc["library_ms"] += lib_ms
                        acc["bf16_matmul_ms"] += mm_ms
                        acc["dequant_ms"] += dq_ms
                        acc["bytes"] += nbytes(*ops, y)
                        acc["ops"] += 2 * M * K * N
                print(line, flush=True)
    for kernel, res in results.items():
        res["bound_ms"], res["bound_by"] = bound(res.pop("bytes"), res.pop("ops"),
                                                 MATMUL_KIND[kernel])
    for kernel, acc in big.items():
        acc["bound_ms"], acc["bound_by"] = bound(acc.pop("bytes"), acc.pop("ops"), "bf16")
        results[kernel]["m2048"] = acc
    for kernel, acc in big_a8.items():
        acc["bound_ms"], acc["bound_by"] = bound(acc.pop("bytes"), acc.pop("ops"), "int8")
    results["w8a8"]["m2048"] = big_a8["w8a8"]
    results["w4a8"]["m4096"] = big_a8["w4a8"]
    return results


def q8_site(K: int, N: int, dtype: str, symmetric: bool, strategy: str, gen,
            with_bias: bool = False):
    """A QLINEAR site on the card: RTN weights, static uint8 activation
    qparams from a sample's ranges by the calibrator's minmax rule, and an
    int32 bias."""
    from onnx_quantize_tpu_torch.algorithms import quantize_bias, rtn_quantize
    from onnx_quantize_tpu_torch.core.dtypes import QuantType
    from onnx_quantize_tpu_torch.core.enums import QFormat
    from onnx_quantize_tpu_torch.core.numerics import compute_qparams
    from onnx_quantize_tpu_torch.core.qconfig import QWeightArgs
    from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, QBias, make_qtensor

    args = QWeightArgs(dtype=dtype, group_size=-1 if strategy == "channel" else None,
                       symmetric=symmetric)
    w = 0.1 * torch.randn((K, N), generator=gen, device="cuda")
    x = torch.randn((64, K), generator=gen, device="cuda")
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, -1, symmetric, False)

    def qparams(t):
        return compute_qparams(t.min().clamp(max=0.0), t.max().clamp(min=0.0), QuantType.QUInt8,
                               False, False)

    (xs, xz), (ys, yz) = qparams(x), qparams(x @ w)
    static = ActQuantSpec(mode="static", dtype="uint8")
    qt = make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy, group_size=-1,
                      symmetric=symmetric, reduce_range=False, fmt=QFormat.QLINEAR,
                      input_quant=static, output_quant=static, input_scale=xs,
                      input_zero_point=xz, output_scale=ys, output_zero_point=yz)
    bias = None
    if with_bias:
        b_q, b_s, _ = quantize_bias(0.1 * torch.randn((N,), generator=gen, device="cuda"), xs, s)
        bias = QBias(b_q, b_s, torch.zeros((), dtype=torch.int32, device="cuda"), "int32")
    return qt, bias


# name, K, N, weight dtype, symmetric, strategy, rows of M, bias, timed: one
# Gemma-3-270M layer's seven QLINEAR sites (unfused: static output scales
# differ by site), then odd shapes: a ragged K chunk with zero points and a
# per-tensor scale, K past the plain version's 256-row chunks, uint8
# symmetric (zp 128, shifted), int8 asymmetric, 4 columns per thread, and N
# off the TPU's multiples of 128.
Q8_CASES = [
    ("q", 640, 1024, "int8", True, "channel", (32, 4096), False, True),
    ("k", 640, 256, "int8", True, "channel", (32, 4096), False, True),
    ("v", 640, 256, "int8", True, "channel", (32, 4096), False, True),
    ("o", 1024, 640, "int8", True, "channel", (32, 4096), False, True),
    ("gate", 640, 2048, "int8", True, "channel", (32, 4096), False, True),
    ("up", 640, 2048, "int8", True, "channel", (32, 4096), False, True),
    ("down", 2048, 640, "int8", True, "channel", (32, 4096), False, True),
    ("odd_q8_u8_asym_tensor_k100_bias", 100, 128, "uint8", False, "tensor", (7, 37), True, False),
    ("odd_q8_i8_k1000_bias", 1000, 256, "int8", True, "channel", (33,), True, False),
    ("odd_q8_u8_sym_k1000", 1000, 384, "uint8", True, "channel", (5, 65), False, False),
    ("odd_q8_i8_asym_tensor", 640, 128, "int8", False, "tensor", (3,), True, False),
    ("odd_q8_u8_asym_n40064", 640, 40064, "uint8", False, "channel", (33,), False, False),
    # N % 128 != 0 (the TPU's lane rule, not the kernel's): N % 4 != 0 too.
    ("odd_q8_i8_n40", 640, 40, "int8", True, "channel", (32,), False, False),
    ("odd_q8_u8_asym_n100_bias", 100, 100, "uint8", False, "channel", (7,), True, False),
    ("odd_q8_i8_tensor_n130_bias", 640, 130, "int8", True, "tensor", (3, 33), True, False),
]


# Q8 is timed at a decode step (M=32) and a 32x128 prefill (M=4096).
Q8_TIMED = (32, 4096)


def run_q8_checks(gen) -> dict:
    """Q8 against its plain version (bit for bit, and the same bits twice),
    and one layer's seven sites timed at M=32 (the kernels line) and M=4096
    (``results["m4096"]``) beside ``torch._int_mm`` on their int32 core."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_q8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed_res = {M: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "ops": 0}
                 for M in Q8_TIMED}
    err_max = 0.0
    for name, K, N, dtype, sym, strat, rows, with_bias, timed in Q8_CASES:
        qt, bias = q8_site(K, N, dtype, sym, strat, gen, with_bias)
        for M in rows:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                ops = matmul_q8.q8_operands(x, qt, bias)
                y = matmul_q8.q8_matmul(*ops)
                ref = matmul_q8.q8_matmul_plain(*ops)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                check(bool(torch.isfinite(y).all()), f"q8 {name} M={M} {xdt}: non-finite output")
                check(err == 0.0, f"q8 {name} M={M} {xdt}: max abs err {err:.3e}, not 0")
                check(torch.equal(matmul_q8.q8_matmul(*ops), y),
                      f"q8 {name} M={M} {xdt}: two launches differ")
                err_max = max(err_max, err)
                plan = matmul_q8.q8_plan(M, K, N, sms)
                line = (f"kernel q8 {name} M={M} x={str(xdt)[6:]}: max_abs_err={err:.3e} "
                        f"plan={plan.route} {plan.bm}x{plan.bn} splits={plan.splits} "
                        f"blocks={plan.blocks}")
                if timed and M in Q8_TIMED and xdt == torch.bfloat16:
                    iters = 50 if M <= 32 else 20
                    ms = cuda_time_ms(lambda: matmul_q8.q8_matmul(*ops), iters)
                    plain_ms = cuda_time_ms(lambda: matmul_q8.q8_matmul_plain(*ops), iters)
                    # The int32 core on the same codes: x quantized as the
                    # kernel does, int8 weights as stored.
                    c = ops[3]
                    x_q = (torch.clamp(torch.round(x.float() / c.fparams[0]).to(torch.int32)
                                       + c.iparams[0], *c.iq) - c.x_shift).to(torch.int8)
                    lib_ms = cuda_time_ms(lambda: torch._int_mm(x_q, qt.data), iters)
                    exact = (x_q.double() @ qt.data.double()).to(torch.int32)
                    check(torch.equal(torch._int_mm(x_q, qt.data), exact),
                          f"q8 {name} M={M}: _int_mm disagrees with the exact integer dot")
                    acc = timed_res[M]
                    acc["ms"] += ms
                    acc["plain_ms"] += plain_ms
                    acc["library_ms"] += lib_ms
                    acc["bytes"] += nbytes(x, qt.data, c.wsum, c.wzp, c.req, y)
                    acc["ops"] += 2 * M * K * N
                    line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} int_mm_ms={lib_ms:.4f}"
                print(line, flush=True)
    for acc in timed_res.values():
        acc["bound_ms"], acc["bound_by"] = bound(acc.pop("bytes"), acc.pop("ops"), "int8")
    res = dict(timed_res[32], max_abs_err=err_max)
    res["m4096"] = timed_res[4096]
    return res


# name, K, intermediate, dtype, group size, symmetric, rows of M, timed: the
# 270M MLP (M=256 runs the kernel past the predicate's cap at these widths),
# and a ragged gate-up group (K=192, g64: 3 groups padded to 4) in int4.
MLP_CASES = [
    ("mlp_270m", 640, 2048, "uint4", 128, False, (32, 1, 256), True),
    ("odd_mlp_k192_i256_g64_int4", 192, 256, "int4", 64, True, (5,), False),
]
# Why: the kernel and its plain version (the unfused chain of the W4 plain
# version) form the same float32 products, summed in another order; in
# float32 1e-4 of max|y| bounds that. In bfloat16, act rounds to bf16
# between the products, and an h one float32 ulp apart can round the other
# way (2^-8 relative on one act element): 1e-2 of max|y|.
MLP_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def run_mlp_checks(gen) -> dict:
    """The fused MLP against its plain version, timed at M=32 (bf16) beside
    the unfused W4 gate_up, GeGLU and W4 down it replaces."""
    from onnx_quantize_tpu_torch.ops.kernels import mlp_w4, pad_to_multiple
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import w4_matmul

    res = {"max_abs_err": 0.0, "library_ms": None}
    for name, K, inter, dtype, gs, sym, rows, timed in MLP_CASES:
        gu = random_qtensor(K, 2 * inter, dtype, gs, sym, gen)
        dn = random_qtensor(inter, K, dtype, gs, sym, gen)
        for M in rows:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                ops, kw = mlp_w4.mlp_w4_operands(x, gu, dn)
                y = mlp_w4.mlp_w4(*ops, **kw)
                again = mlp_w4.mlp_w4(*ops, **kw)
                ref = mlp_w4.mlp_w4_plain(*ops, **kw)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                scale = ref.abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{name} M={M} {xdt}: non-finite output")
                check(torch.equal(y, again), f"{name} M={M} {xdt}: two launches differ")
                check(err <= MLP_REL_TOL[xdt] * scale,
                      f"{name} M={M} {xdt}: max abs err {err:.3e} > {MLP_REL_TOL[xdt]} * "
                      f"{scale:.3e}")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                line = f"kernel mlp_w4 {name} M={M} x={str(xdt)[6:]}: max_abs_err={err:.3e}"
                if timed and M == 32 and xdt == torch.bfloat16:
                    x2d, wg, sg, zg, wd, sd, zd = ops

                    def unfused():
                        h = w4_matmul(x2d, wg, sg, zg, gs=kw["gs_g"], signed=kw["signed_g"])
                        act = torch.nn.functional.gelu(h[:, :inter], approximate="tanh")
                        act = (act * h[:, inter:]).to(x2d.dtype)
                        act = pad_to_multiple(act, 1, 2 * wd.shape[0]).contiguous()
                        return w4_matmul(act, wd, sd, zd, gs=kw["gs_d"], signed=kw["signed_d"])

                    res["ms"] = cuda_time_ms(lambda: mlp_w4.mlp_w4(*ops, **kw), 50)
                    res["plain_ms"] = cuda_time_ms(lambda: mlp_w4.mlp_w4_plain(*ops, **kw), 50)
                    res["unfused_ms"] = cuda_time_ms(unfused, 50)
                    res["bound_ms"], res["bound_by"] = bound(
                        nbytes(*ops, y), 2 * M * K * 2 * inter + 2 * M * inter * K, "bf16")
                    line += (f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                             f"unfused_w4_pair_ms={res['unfused_ms']:.4f}")
                print(line, flush=True)
    return res


# Why these tolerances: flash decode reads int8 codes and float32 scales and
# forms the same float32 products as its plain version, summed in another
# order (and softmax taken online): 1e-4 of the output's largest magnitude.
# Flash attention in float32 likewise. In bfloat16 both round p to bf16
# before the PV product, but the kernel rounds exp(s - running max) and the
# plain version exp(s - row max), and the output rounds to bf16 (2^-8
# relative): 1e-2 of the largest output.
ATTN_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GLOBAL_LAYERS, LOCAL_LAYERS = 3, 15  # Gemma-3-270M: every 6th of 18 layers is global


def fd_inputs(B, S, Hq, Hkv, D, pos, gen):
    """Pre-scaled float32 queries and an int8 cache with float32 scales."""
    q = torch.randn((B, Hq, D), generator=gen, device="cuda") / 16
    k, v = (torch.randint(-127, 128, (B, S, Hkv, D), generator=gen, device="cuda",
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (1e-3 + 3e-2 * torch.rand((B, S, Hkv), generator=gen, device="cuda")
              for _ in range(2))
    return q, k, ks, v, vs, torch.as_tensor(pos, dtype=torch.int32, device="cuda")


def fa_inputs(B, T, Hq, Hkv, D, dtype, gen):
    q = (torch.randn((B, T, Hq, D), generator=gen, device="cuda") / D ** 0.5).to(dtype)
    k, v = (torch.randn((B, T, Hkv, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def check_attention(name, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    check(err <= ATTN_REL_TOL[dtype] * scale,
          f"{name}: max abs err {err:.3e} > {ATTN_REL_TOL[dtype]} * {scale:.3e}")
    return err


def live_rows(pos, S: int, window) -> int:
    """Cache rows flash decode reads over the batch: [max(pos - window + 1, 0),
    min(pos, S - 1)] for each sequence (this run's positions)."""
    last = pos.long().clamp(max=S - 1)
    first = (pos.long() - window + 1).clamp(min=0) if window else torch.zeros_like(last)
    return int((last - first + 1).clamp(min=0).sum().item())


def causal_pairs(T: int, window) -> int:
    """(query, key) pairs a causal attention over T tokens computes."""
    return sum(min(t + 1, window or T) for t in range(T))


def sdpa_ms(q, k, v, window) -> float:
    """Milliseconds of ``scaled_dot_product_attention`` on flash attention's
    inputs (a yardstick: the port never calls it); q is pre-scaled, so scale
    1. A window is a banded causal mask."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # (B, H, T, D)
    T = q.shape[1]
    mask = None
    if window:
        i = torch.arange(T, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None, scale=1.0, enable_gqa=True)

    return cuda_time_ms(call, 5)


def run_attention_checks(gen) -> dict:
    from onnx_quantize_tpu_torch.ops.kernels import flash_decode as fd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    # Flash decode: ragged positions at the main shape (pos 0 has one live key,
    # fewer than one split's share, so the other splits of its range are
    # empty), then odd shapes. Each case's launch plan (its cluster of splits)
    # is printed; a second launch must give the same bits.
    B, S = 32, 4096
    ragged = [0, 127, 128, 511, 512, 4095, S]
    ragged += torch.randint(0, S, (B - len(ragged),), generator=gen, device="cuda").tolist()
    fd_cases = [("fd_B32_S4096_g4_D256", (B, S, 4, 1, 256, ragged)),
                ("fd_odd_g1_D128_S128", (3, 128, 2, 2, 128, [0, 127, 128])),
                ("fd_odd_kv2_D128", (4, 512, 4, 2, 128, [0, 63, 300, 512])),
                ("fd_odd_kv2_g4_D256_S128", (2, 128, 8, 2, 256, [127, 5]))]
    err_max = 0.0
    for name, shape in fd_cases:
        args = fd_inputs(*shape, gen)
        b, s_len, _, hkv = shape[:4]
        for window in (512, 16, None):
            plan = fd.fd_plan(b, hkv, s_len, window, sms)
            got = fd.flash_decode_int8(*args, window=window)
            again = fd.flash_decode_int8(*args, window=window)
            want = fd.flash_decode_int8_reference(*args, window=window)
            torch.cuda.synchronize()
            err = check_attention(f"{name} window={window}", got, want, torch.float32)
            check(torch.equal(got, again), f"{name} window={window}: two flash-decode launches "
                                           "differ")
            err_max = max(err_max, err)
            print(f"kernel flash_decode {name} window={window}: max_abs_err={err:.3e} "
                  f"splits={plan.splits} blocks={plan.blocks}", flush=True)
    check(fd.fd_plan(B, 1, S, 512, sms).splits > 1 and fd.fd_plan(B, 1, S, None, sms).splits > 1,
          "the main flash-decode shape launched a plan without a split")
    # One decode step's shapes: B=32 sequences at position 640 of a 1024 cache.
    args = fd_inputs(32, 1024, 4, 1, 256, [640] * 32, gen)
    times = {}
    work = [0, 0]  # bytes and float32 operations of one step
    for window, layers in ((None, GLOBAL_LAYERS), (512, LOCAL_LAYERS)):
        q, k, ks, v, vs, pos = args
        rows = live_rows(pos, k.shape[1], window)
        per_row = nbytes(k[0, 0], v[0, 0], ks[0, 0], vs[0, 0])
        out = fd.flash_decode_int8(*args, window=window)
        work[0] += layers * (nbytes(q, pos, out) + rows * per_row)
        work[1] += layers * 4 * rows * q.shape[1] * q.shape[2]  # QK and PV, G heads a row
    for window in (None, 512):
        plan = fd.fd_plan(32, 1, 1024, window, sms)
        check(plan.blocks >= sms, f"a decode step's flash decode (window {window}) launches "
                                  f"{plan.blocks} blocks on {sms} SMs")
        times[window] = (cuda_time_ms(lambda: fd.flash_decode_int8(*args, window=window), 50),
                         cuda_time_ms(lambda: fd.flash_decode_int8_reference(*args, window=window),
                                      50))
        print(f"kernel flash_decode B=32 S=1024 pos=640 window={window}: "
              f"kernel_ms={times[window][0]:.4f} plain_ms={times[window][1]:.4f} "
              f"splits={plan.splits} blocks={plan.blocks}", flush=True)
    results["flash_decode"] = {
        "max_abs_err": err_max,
        # Per decode step of the 270M model: 3 global and 15 local layers.
        "ms": GLOBAL_LAYERS * times[None][0] + LOCAL_LAYERS * times[512][0],
        "plain_ms": GLOBAL_LAYERS * times[None][1] + LOCAL_LAYERS * times[512][1],
        "library_ms": None}  # no single PyTorch call attends over an int8 cache
    results["flash_decode"]["bound_ms"], results["flash_decode"]["bound_by"] = bound(
        *work, "float32")

    results["flash_attention"] = run_flash_attention_checks(gen)
    return results


# Flash attention: (name, (B, T, Hq, Hkv, D, dtype)). A 2048-token window of
# the 270M model (timed) and a 512-token prefill, ragged bf16 shapes (GQA 2
# and 4, two KV heads, D = 32, 64, 128), and an odd float32 shape.
FA_CASES = [("fa_T2048_g4_D256", (1, 2048, 4, 1, 256, torch.bfloat16)),
            ("fa_T512_g4_D256", (1, 512, 4, 1, 256, torch.bfloat16)),
            ("fa_odd_B2_T100_kv2_g2_D64", (2, 100, 4, 2, 64, torch.bfloat16)),
            ("fa_odd_T70_g2_D32", (1, 70, 2, 1, 32, torch.bfloat16)),
            ("fa_odd_T130_g4_D128", (1, 130, 4, 1, 128, torch.bfloat16)),
            ("fa_odd_B2_T48_mha_D128_f32", (2, 48, 2, 2, 128, torch.float32))]
FA_WINDOW = "fa_T2048_g4_D256"


def describe(plan) -> str:
    return (f"plan={plan.route} grid={plan.grid} rows={plan.rows} heads={plan.heads} "
            f"key_splits={plan.key_splits} threads={plan.threads} "
            f"smem={plan.smem_bytes}")


def run_flash_attention_checks(gen) -> dict:
    """Flash attention against the plain version at every case, on the
    wrapper's route (bf16 on the tensor cores, float32 on the CUDA cores). At
    the window shapes, one 2048-token window's 3 global and 15 local layers
    timed: the kernel, the plain version and SDPA."""
    from onnx_quantize_tpu_torch.ops.kernels import flash_attention as fa

    err_max = 0.0
    arms = ("kernel", "plain", "sdpa")
    per_layer = {}  # (arm, window) -> ms
    work = [0, 0]  # one window's bytes and bf16 operations
    for name, shape in FA_CASES:
        B, T, Hq, Hkv, D, dtype = shape
        args = fa_inputs(*shape, gen)
        for window in (512, None):
            plan = fa.fa_plan(B, T, T, Hq, Hkv, D, window, dtype)
            check(plan.route == ("mma" if dtype == torch.bfloat16 else "simt"),
                  f"{name}: plan route {plan.route} for {dtype}")
            routes = dict(fa.route_launches)
            got = fa.flash_attention(*args, sliding_window=window)
            want = fa.flash_attention_reference(*args, sliding_window=window)
            torch.cuda.synchronize()
            check(fa.route_launches[plan.route] == routes[plan.route] + 1,
                  f"{name} window={window}: the wrapper did not take the {plan.route} route")
            err = check_attention(f"{name} window={window} {plan.route}", got, want, dtype)
            line = (f"kernel flash_attention {name} window={window}: {describe(plan)} "
                    f"max_abs_err={err:.3e}")
            err_max = max(err_max, err)
            if name == FA_WINDOW:
                calls = {
                    "kernel": (lambda: fa.flash_attention(*args, sliding_window=window), 20),
                    "plain": (lambda: fa.flash_attention_reference(*args,
                                                                   sliding_window=window), 5),
                }
                for arm, (fn, iters) in calls.items():
                    per_layer[arm, window] = cuda_time_ms(fn, iters)
                per_layer["sdpa", window] = sdpa_ms(*args, window)
                line += " " + " ".join(f"{arm}_ms={per_layer[arm, window]:.4f}" for arm in arms)
                layers = LOCAL_LAYERS if window else GLOBAL_LAYERS
                q = args[0]
                work[0] += layers * nbytes(*args, got)
                work[1] += layers * 4 * q.shape[0] * q.shape[2] * q.shape[3] * causal_pairs(
                    q.shape[1], window)
            print(line, flush=True)
    # Per 2048-token scoring window of the 270M model: 3 global, 15 local layers.
    window_ms = {arm: GLOBAL_LAYERS * per_layer[arm, None] + LOCAL_LAYERS * per_layer[arm, 512]
                 for arm in arms}
    res = {"max_abs_err": err_max, "ms": window_ms["kernel"], "plain_ms": window_ms["plain"],
           "library_ms": window_ms["sdpa"],
           "per_layer": {f"{arm} {'local' if w else 'global'}": ms
                         for (arm, w), ms in per_layer.items()}}
    res["bound_ms"], res["bound_by"] = bound(*work, "bf16")
    return res


# -- phase 4: the main path ------------------------------------------------------

@contextlib.contextmanager
def plain_kernels(only=None):
    """Swap the kernel wrappers (those of the ``only`` modules, or all) for
    their plain versions (reference run only: the package itself never
    routes a CUDA tensor to a plain version)."""
    from onnx_quantize_tpu_torch.ops.kernels import (
        flash_attention,
        flash_decode,
        matmul_q8,
        matmul_w4,
        matmul_w4a8,
        matmul_w8,
        matmul_w8a8,
        mlp_w4,
    )

    swaps = [(matmul_w4, "w4_matmul", matmul_w4.w4_dequant_matmul_plain),
             (matmul_w8, "w8_matmul", matmul_w8.w8_dequant_matmul_plain),
             (matmul_w4a8, "w4a8_matmul", matmul_w4a8.w4a8_matmul_plain),
             (matmul_w8a8, "w8a8_matmul", matmul_w8a8.w8a8_matmul_plain),
             (matmul_q8, "q8_matmul", matmul_q8.q8_matmul_plain),
             (mlp_w4, "mlp_w4", mlp_w4.mlp_w4_plain),
             (flash_attention, "flash_attention", flash_attention.flash_attention_reference),
             (flash_decode, "flash_decode_int8", flash_decode.flash_decode_int8_reference)]
    if only is not None:
        swaps = [swap for swap in swaps if swap[0] in only]
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), wrapper in zip(swaps, saved):
            setattr(module, name, wrapper)


def build_models():
    """The Gemma-3-270M bf16 model from a seeded init, and its W4 tree (W4 g128
    body, int8 per-channel lm_head, fused), float tree (fused) and Q8 tree
    (QLINEAR body calibrated on the card, int8 weight-only lm_head, fused:
    the QLINEAR sites stay unfused). Returns (model, W4, float, Q8 trees,
    calibration and quantization seconds)."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.gemma3 import (
        GEMMA3_270M,
        Gemma3,
        fuse_gemma3_projections,
    )

    cfg = dataclasses.replace(GEMMA3_270M, dtype="bfloat16")
    model = Gemma3(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    body = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
                       ignore=["lm_head"])
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])
    qparams, _ = oqt.quantize(model, params, body)
    qparams, _ = oqt.quantize(model, qparams, head)
    # The reference's body_q8 arm (scripts/tpu_bench_ablate.py:56-71, 83-88).
    static = oqt.QActivationArgs(dtype="uint8", is_static=True)
    calib = np.random.default_rng(7).integers(1, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    q8 = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                     input_activations=static, output_activations=static, format="qlinear",
                     calibration_data=calib, ignore=["lm_head"])
    (q8params, plan), q8_s = timed(lambda: oqt.quantize(model, params, q8))
    check(len(plan) == 7 * cfg.num_layers
          and all(e.input_scale.device.type == "cuda" for e in plan),
          "Q8 calibration: a site without calibrated qparams on the card")
    q8params, _ = oqt.quantize(model, q8params, head)
    return (model, fuse_gemma3_projections(qparams), fuse_gemma3_projections(params),
            fuse_gemma3_projections(q8params), q8_s)


def run_main_path(model, qparams, label: str, prefill_want: dict, step_want: dict,
                  exact: bool = False, plain_only=None, mega: bool = False):
    """Prefill, greedy decode and generate, launching exactly ``prefill_want``
    kernels (name -> count) per prefill and ``step_want`` per decode step, and
    no other; prefill logits and greedy tokens against the same engine with
    the kernels (those of the ``plain_only`` modules, or all) swapped for
    their plain versions: equal when ``exact``, else within 5% of the largest
    logit. ``mega`` arms the fused MLP. Returns (launches, prefill logits)."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    cfg = model.cfg
    B, T, steps = 32, 128, 64
    engine = InferenceEngine(model, qparams, max_batch=B, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16, mlp_megakernel=mega)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (5, 77, 128)]
    new_tokens = 8

    def expect(prefills: int, n_steps: int) -> dict:
        want = {name: 0 for name in kernel_modules()}
        for name, n in prefill_want.items():
            want[name] += prefills * n
        for name, n in step_want.items():
            want[name] += n_steps * n
        return want

    def launched(counts: dict) -> dict:
        return {k: v for k, v in counts.items() if v}

    def since(before: dict) -> dict:
        return {k: v - before[k] for k, v in kernel_counts().items()}

    torch.cuda.synchronize()
    reset_counts()
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    after_prefill = kernel_counts()
    first = torch.argmax(logits, dim=-1)
    cache, generated = engine.decode_multi(cache, first, steps=steps)
    decode_launches = since(after_prefill)
    after_decode = kernel_counts()
    outputs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    gen_launches = since(after_decode)
    total = kernel_counts()

    check(after_prefill == expect(1, 0), f"{label} prefill launched "
          f"{launched(after_prefill)}, expected {prefill_want} and no other")
    check(decode_launches == expect(0, steps), f"{label}: {steps} decode steps launched "
          f"{launched(decode_launches)}, expected {step_want} per step and no other")
    # generate: one prefill + (new_tokens - 1) decode steps.
    check(gen_launches == expect(1, new_tokens - 1),
          f"{label} generate launched {launched(gen_launches)}")
    per_step = {k: v // steps for k, v in launched(decode_launches).items()}
    print(f"main path ({label}) launches: prefill {launched(after_prefill)}, decode x{steps} "
          f"{launched(decode_launches)} ({per_step} per step), generate "
          f"{launched(gen_launches)}; other kernels none", flush=True)

    check(tuple(logits.shape) == (B, cfg.vocab_size), f"prefill logits shape {logits.shape}")
    check(bool(torch.isfinite(logits.float()).all()), "prefill logits not finite")
    check(tuple(generated.shape) == (B, steps), f"decode output shape {generated.shape}")
    check(bool(((generated >= 0) & (generated < cfg.vocab_size)).all()), "token out of range")
    check(bool((cache["lengths"] == T + steps).all()), "cache lengths after decode")
    check([len(o) for o in outputs] == [new_tokens] * 3, "generate output lengths")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o), "generate token range")

    # One decode step's logits after the prefill, printed against the plain run.
    _, step_logits = engine.decode(engine.prefill(engine.new_cache(), ids, lengths)[0], first)

    # The same engine with the kernels swapped for their plain versions.
    cmp_steps = 16
    counts = kernel_counts()
    with plain_kernels(plain_only):
        plain_cache, plain_logits = engine.prefill(engine.new_cache(), ids, lengths)
        _, plain_step_logits = engine.decode(
            engine.prefill(engine.new_cache(), ids, lengths)[0], first)
        _, plain_tokens = engine.decode_multi(plain_cache, first, steps=cmp_steps)
    torch.cuda.synchronize()
    if plain_only is None:
        check(kernel_counts() == counts, "the plain-version run launched kernels")
    diff = (logits.float() - plain_logits.float()).abs()
    peak = plain_logits.float().abs().max().item()
    # bf16 stream: W4/W8 and their plain versions differ by float32 summation
    # order, which can flip a bf16 rounding (2^-8 relative) of a site output;
    # such flips pass through 18 layers. 5% of the largest logit bounds that.
    # The A8 and Q8 kernels agree with their plain versions bit for bit (else
    # a flipped bf16 rounding moves int8 activation codes of later sites and
    # compounds: 7.6% of the largest logit when the A8 kernels summed in
    # another order), and nothing else differs between the two runs, so
    # their arms must match exactly: equal logits and equal greedy tokens.
    tol = 0.0 if exact else 0.05 * peak
    print(f"prefill logits kernel vs plain ({label}): max_abs_diff={diff.max().item():.4e} "
          f"mean_abs_diff={diff.mean().item():.4e} max|logit|={peak:.4e} tol={tol:.4e}",
          flush=True)
    check(diff.max().item() <= tol, f"{label} prefill logits through the kernels disagree "
                                    "with plain")
    step_diff = (step_logits.float() - plain_step_logits.float()).abs()
    print(f"decode-step logits kernel vs plain ({label}, not gated): max_abs_diff="
          f"{step_diff.max().item():.4e} mean_abs_diff={step_diff.mean().item():.4e} "
          f"max|logit|={plain_step_logits.float().abs().max().item():.4e}", flush=True)
    agree = (generated[:, :cmp_steps] == plain_tokens).float().mean().item()
    print(f"greedy tokens equal over {cmp_steps} steps, kernel vs plain ({label}): {agree:.4f}",
          flush=True)
    check(not exact or agree == 1.0, f"{label} greedy tokens differ from the plain run's")
    check_on_mma(label)
    return total, logits


# -- phase 5: decode rates -------------------------------------------------------

def decode_arm(model, params, kv_quant: bool, fused: bool = False, mega: bool = False,
               lo: int = 16, hi: int = 48):
    """A prefilled B=32 engine (``fused``: flash decode over its int8 cache;
    ``mega``: the fused MLP); each call of the returned function times one
    sample of decode tokens/s, the slope between ``lo`` and ``hi`` steps."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    B, T = 32, 128
    engine = InferenceEngine(model, params, max_batch=B, max_seq=512, kv_quant=kv_quant,
                             dtype=torch.bfloat16, fused_attention=fused, mlp_megakernel=mega)
    ids = np.random.default_rng(SEED).integers(1, model.cfg.vocab_size, size=(B, T))
    cache, logits = engine.prefill(engine.new_cache(), ids, np.full((B,), T, np.int32))
    tokens = torch.argmax(logits, dim=-1)

    def run(steps: int) -> float:
        nonlocal cache, tokens
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cache, out = engine.decode_multi(cache, tokens, steps=steps)
        end.record()
        torch.cuda.synchronize()
        tokens = out[:, -1]
        return start.elapsed_time(end) / 1e3

    def sample() -> float:
        t_lo, t_hi = run(lo), run(hi)
        check(bool((cache["lengths"] < engine.max_seq).all()), "decode reached max_seq")
        return B * (hi - lo) / (t_hi - t_lo)

    run(lo)  # warm-up
    return sample


# -- phase 6: window scoring -----------------------------------------------------

def kernel_modules() -> dict:
    """Each kernel's module, which holds its launch counter."""
    from onnx_quantize_tpu_torch.ops.kernels import (
        flash_attention,
        flash_decode,
        matmul_q8,
        matmul_w4,
        matmul_w4a8,
        matmul_w8,
        matmul_w8a8,
        mlp_w4,
    )

    return {"w4": matmul_w4, "w8": matmul_w8, "w4a8": matmul_w4a8, "w8a8": matmul_w8a8,
            "q8": matmul_q8, "mlp_w4": mlp_w4, "flash_attention": flash_attention,
            "flash_decode": flash_decode}


def kernel_counts() -> dict:
    return {name: module.launches for name, module in kernel_modules().items()}


def reset_counts() -> None:
    for module in kernel_modules().values():
        module.launches = 0
    for name in ROUTED:
        kernel_modules()[name].route_launches.update(mma=0, simt=0)


# The kernels whose wrappers count their launches by route.
ROUTED = ("flash_attention", "w8", "w4a8", "w8a8")


def check_on_mma(label: str, names=("w8", "w4a8", "w8a8")) -> None:
    """Every launch of the ``names`` kernels since the last reset took the
    tensor-core route."""
    for name in names:
        module = kernel_modules()[name]
        check(module.route_launches == {"mma": module.launches, "simt": 0},
              f"{label}: {name} ran on the routes {module.route_launches}, expected all "
              f"{module.launches} launches on the tensor cores")


def count_launches(fn) -> tuple[int, list[str]]:
    """(count, names) of the device operations one ``fn()`` call launches,
    from ``torch.profiler``, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names), [n[:40] for n in names]


# Kernel names (the mma routes' kernels, W8's x-stationary form among them).
MATMUL_KERNEL_NAME = re.compile(r"\b(w4a8|w8a8|w4|w8|q8|mlp_w4)(_mma(_xs)?)?_kernel\b")
Q8_KERNEL_NAME = re.compile(r"\bq8(_mma)?_kernel\b")
W4_KERNEL_NAME = re.compile(r"\bw4(_mma)?_kernel\b")
W8_KERNEL_NAME = re.compile(r"\bw8(_mma(_xs)?)?_kernel\b")


def profile_decode(model, params, steps: int = 4, mega: bool = False) -> dict:
    """Per decode step of a prefilled B=32 engine (int8 KV cache, bf16), over
    ``steps`` greedy steps under ``torch.profiler``: device operations
    launched, device busy ms (their summed durations; one stream), wall ms
    (profiled, so longer than unprofiled), the idle share 1 - busy/wall, and
    the busy ms of the quantized-matmul kernels (the fused MLP among them),
    of the Q8 kernels alone, and of everything else."""
    from torch.profiler import ProfilerActivity, profile

    from onnx_quantize_tpu_torch.engine import InferenceEngine

    B, T = 32, 128
    engine = InferenceEngine(model, params, max_batch=B, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16, mlp_megakernel=mega)
    ids = np.random.default_rng(SEED).integers(1, model.cfg.vocab_size, size=(B, T))
    cache, logits = engine.prefill(engine.new_cache(), ids, np.full((B,), T, np.int32))
    tokens = torch.argmax(logits, dim=-1)
    cache, out = engine.decode_multi(cache, tokens, steps=steps)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_multi(cache, out[:, -1], steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    matmul = sum(e.time_range.elapsed_us() for e in events
                 if MATMUL_KERNEL_NAME.search(e.name)) / 1e3
    q8 = sum(e.time_range.elapsed_us() for e in events if Q8_KERNEL_NAME.search(e.name)) / 1e3
    wall_ms = 1e3 * wall
    return {"launches": len(events) / steps, "busy_ms": busy / steps,
            "matmul_ms": matmul / steps, "q8_ms": q8 / steps,
            "other_ms": (busy - matmul) / steps,
            "wall_ms": wall_ms / steps, "idle_share": 1.0 - busy / wall_ms}


def profile_window(model, params) -> dict:
    """One 2048-token scoring window (``perplexity_from_tokens`` over 2048
    seeded tokens) under ``torch.profiler``, after a warm-up window: device
    operations, busy ms, wall ms (profiled), idle share, and the busy ms of
    the W4 kernels, the W8 kernel and flash attention."""
    from torch.profiler import ProfilerActivity, profile

    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    tokens = np.random.default_rng(SEED).integers(0, model.cfg.vocab_size, 2048)
    perplexity_from_tokens(model, params, tokens, 2048, 512)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        perplexity_from_tokens(model, params, tokens, 2048, 512)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def busy(pattern=None):
        return sum(e.time_range.elapsed_us() for e in events
                   if pattern is None or pattern.search(e.name)) / 1e3

    total = busy()
    return {"launches": len(events), "busy_ms": total, "wall_ms": wall_ms,
            "idle_share": 1.0 - total / wall_ms, "w4_ms": busy(W4_KERNEL_NAME),
            "w8_ms": busy(W8_KERNEL_NAME),
            "flash_attention_ms": busy(re.compile(r"flash_attention"))}


def timed(fn):
    """(result, seconds) of ``fn()``, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# Why: the two runs read the same weights and bf16 stream; the kernels differ
# from their plain versions in float32 summation order and (flash attention)
# where p rounds to bf16, which flips bf16 roundings of activations through 18
# layers (PR 1's prefill logits moved by up to 1.6% of the largest logit). The
# per-token NLL changes so made have no common sign; averaged over thousands
# of scored tokens they stay far inside 0.2% of the mean NLL.
MEAN_NLL_REL_TOL = 2e-3


def run_window_scoring(model, qparams, a8params, fparams, card) -> tuple[dict, dict]:
    """Window scoring of the W4 and the A8 model, each through the kernels and
    with the plain versions, and of the bf16 model. Returns each quantized
    model's launches."""
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    max_length, stride, n_tokens = 2048, 512, 4096
    windows = 1 + (n_tokens - max_length) // stride
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, n_tokens)

    def score(params):
        return timed(lambda: perplexity_from_tokens(model, params, tokens, max_length, stride))

    def kernels_vs_plain(params, body: str, head: str, label: str, exact: bool = False):
        reset_counts()
        ppl, secs = score(params)
        launches = kernel_counts()
        want = {name: 0 for name in launches}
        want.update({body: 4 * cfg.num_layers * windows, head: windows,
                     "flash_attention": cfg.num_layers * windows})
        check(launches == want, f"{label} window scoring launched {launches}, expected {want}")
        routes = dict(kernel_modules()["flash_attention"].route_launches)
        check(routes == {"mma": cfg.num_layers * windows, "simt": 0},
              f"{label} window scoring ran flash attention on the routes {routes}, expected "
              "every launch on the tensor cores")
        check_on_mma(f"{label} window scoring")
        check(math.isfinite(ppl), f"{label} window scoring ppl {ppl} is not finite")
        with plain_kernels():
            ppl_plain, secs_plain = score(params)
        check(kernel_counts() == launches, f"the plain-version {label} scoring run launched "
                                           "kernels")
        nll, nll_plain = math.log(ppl), math.log(ppl_plain)
        tol = MEAN_NLL_REL_TOL * nll_plain
        print(f"window scoring {label} launches over {windows} windows: {launches}; per window "
              f"{ {k: v // windows for k, v in launches.items() if v} }", flush=True)
        print(f"window scoring {label} (Gemma-3-270M bf16, seed {SEED}, {n_tokens} tokens, "
              f"window {max_length}, stride {stride}) on {card}: ppl kernels {ppl:.4f} "
              f"({1e3 * secs / windows:.1f} ms/window), plain versions {ppl_plain:.4f} "
              f"({1e3 * secs_plain / windows:.1f} ms/window); mean NLL kernels vs plain "
              f"{nll:.6f} vs {nll_plain:.6f}, tol {tol:.2e}", flush=True)
        check(abs(nll - nll_plain) <= tol,
              f"{label} window scoring mean NLL: kernels disagree with plain")
        if exact:
            # Only the matmul kernels swapped: they agree with their plain
            # versions bit for bit at M=2048 too, and flash attention runs in
            # both, so the ppl must be equal.
            with plain_kernels(only=[kernel_modules()[body], kernel_modules()[head]]):
                ppl_mm_plain, _ = score(params)
            print(f"window scoring {label}: ppl with only {body}/{head} plain "
                  f"{ppl_mm_plain:.4f} vs kernels {ppl:.4f}", flush=True)
            check(ppl_mm_plain == ppl, f"{label} window scoring: the {body}/{head} kernels "
                                       "disagree with their plain versions")
        return launches, ppl

    launches, ppl_q = kernels_vs_plain(qparams, "w4", "w8", "W4+int8 head")
    launches_a8, ppl_a8 = kernels_vs_plain(a8params, "w4a8", "w8a8", "W4A8+W8A8 head",
                                           exact=True)
    ppl_bf16, s_bf16 = score(fparams)
    print(f"window scoring ppl on {card}: W4+int8 head {ppl_q:.4f}, W4A8+W8A8 head "
          f"{ppl_a8:.4f}, bf16 {ppl_bf16:.4f} ({1e3 * s_bf16 / windows:.1f} ms/window)",
          flush=True)
    return launches, launches_a8


# -- phase 7: decode-path scoring -------------------------------------------------

# Why: both engines hold the same int8 codes; the fused path scores them in
# float32 in the kernel, the unfused attend rounds scores and weighted values
# to bf16 in its einsums. Those roundings move logits by a fraction of a
# percent through 18 bf16 layers, with no common sign over 20,000 scored
# tokens: 0.2% of the mean NLL bounds their effect on it.
FUSED_NLL_REL_TOL = 2e-3


def run_decode_scoring(model, qparams, card) -> dict:
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    cfg = model.cfg
    B, T, max_seq = 32, 640, 1024
    ids = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (B, T))
    forwards = T - 1  # the one-token prefill and T - 2 decode steps

    def engine(kv_quant, fused=False):
        return InferenceEngine(model, qparams, max_batch=B, max_seq=max_seq, kv_quant=kv_quant,
                               fused_attention=fused, dtype=torch.bfloat16)

    reset_counts()
    (nll_f, cnt_f), s_f = timed(lambda: engine(True, fused=True).score_nll(ids))
    launches = kernel_counts()
    check(launches["flash_decode"] == cfg.num_layers * forwards
          and launches["flash_attention"] == 0,
          f"decode scoring launched {launches}, expected {cfg.num_layers} flash decode per "
          f"one-token forward ({forwards}) and no flash attention")
    (nll_u, cnt_u), s_u = timed(lambda: engine(True).score_nll(ids))
    check(kernel_counts()["flash_decode"] == launches["flash_decode"],
          "the unfused engine launched flash decode")
    check(bool(np.isfinite(nll_f).all()) and bool((cnt_f == T - 1).all())
          and bool((cnt_u == cnt_f).all()), "decode scoring NLL not finite or counts wrong")
    mean_f, mean_u = nll_f.sum() / cnt_f.sum(), nll_u.sum() / cnt_u.sum()
    tol = FUSED_NLL_REL_TOL * mean_u
    ppl = {"int8 fused": math.exp(mean_f), "int8": math.exp(mean_u)}
    seconds = {"int8 fused": s_f, "int8": s_u}
    for name, kv in (("float", False), ("int4", "int4")):
        ppl[name], seconds[name] = timed(lambda: engine(kv).score_ppl(ids))
    print(f"decode scoring launches: {launches}; per one-token forward "
          f"{launches['flash_decode'] / forwards:.0f} flash decode", flush=True)
    print(f"decode-path scoring (Gemma-3-270M bf16 W4+int8 head, {B} rows x {T} tokens, "
          f"max_seq {max_seq}) on {card}: ppl "
          + ", ".join(f"{k} cache {v:.4f}" for k, v in ppl.items())
          + "; steps/s " + ", ".join(f"{k} {forwards / v:.2f}" for k, v in seconds.items())
          + f"; mean NLL fused vs unfused {mean_f:.6f} vs {mean_u:.6f}, tol {tol:.2e}",
          flush=True)
    check(abs(mean_f - mean_u) <= tol, "decode scoring NLL: fused disagrees with unfused")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "onnx_quantize_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from onnx_quantize_tpu_torch.ops.kernels import build_kernel_library, kernel_library

    # Phase 1: device.
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    phase_t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0:.1f} s", flush=True)
        phase_t0 = now

    phase_done("1 device")

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path, log, build_s = build_kernel_library()
    kernel_library()
    print(f"build: {lib_path.name} nvcc {build_s:.1f} s, ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if (line.startswith("==") or "registers" in line or "spill" in line
                or "Compiling entry function" in line):
            print(f"  ptxas: {line.strip()}")
    phase_done("2 build")

    # Phase 3: kernels against their plain versions.
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernel_results = run_kernel_checks(gen)
    for kernel, what in (("w4", "W4, a layer's four body sites"), ("w8", "W8, the lm_head")):
        res = kernel_results[kernel]
        big = res["m2048"]
        op = BF16_LIBRARY[kernel][0]
        dq32 = (f", bf16 torch.matmul on weights dequantized once {res['bf16_matmul_ms']:.4f}"
                if "bf16_matmul_ms" in res else "")
        print(f"{what} (bf16 x, L2 cold) on {card}: M=32 kernel "
              f"{res['ms']:.4f} ms, bound {res['bound_ms']:.5f} ({res['bound_by']}), plain "
              f"{res['plain_ms']:.4f}, {op} {res['library_ms']:.4f}{dq32}; M=2048 kernel "
              f"{big['ms']:.4f} ms, bound {big['bound_ms']:.5f} ({big['bound_by']}), plain "
              f"{big['plain_ms']:.4f}, {op} {big['library_ms']:.4f}, bf16 torch.matmul on "
              f"weights dequantized once {big['bf16_matmul_ms']:.4f} (the dequantize "
              f"{big['dequant_ms']:.4f})", flush=True)
    a8 = kernel_results["w8a8"]
    print(f"W8A8, the lm_head (int8 x, L2 cold) on {card}: "
          + "; ".join(f"M={M} kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}), plain {r['plain_ms']:.4f}, _int_mm "
                      f"{r['library_ms']:.4f}" for M, r in ((32, a8), (2048, a8["m2048"]))),
          flush=True)
    a8 = kernel_results["w4a8"]
    print(f"W4A8, a layer's four body sites (int8 x, L2 cold) on {card}: "
          + "; ".join(f"M={M} kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}), plain {r['plain_ms']:.4f}, _int_mm (int32 core) "
                      f"{r['library_ms']:.4f}" for M, r in ((32, a8), (4096, a8["m4096"]))),
          flush=True)
    kernel_results.update(run_attention_checks(gen))
    fd = kernel_results["flash_decode"]
    print(f"flash decode, one decode step's 18 layers (B=32, S=1024, pos=640, 3 global + 15 "
          f"local, L2 cold) on {card}: kernel {fd['ms']:.4f} ms, plain {fd['plain_ms']:.4f}, "
          f"bound {fd['bound_ms']:.5f} ({fd['bound_by']})", flush=True)
    fa = kernel_results["flash_attention"]
    print(f"flash attention, one 2048-token window's 18 layers (bf16, 3 global + 15 local, L2 "
          f"cold) on {card}: kernel {fa['ms']:.4f} ms, plain {fa['plain_ms']:.4f}, SDPA {fa['library_ms']:.4f}, bound {fa['bound_ms']:.5f} "
          f"({fa['bound_by']}); per layer "
          + ", ".join(f"{k} {v:.4f}" for k, v in fa["per_layer"].items()), flush=True)
    kernel_results["q8"] = q8 = run_q8_checks(gen)
    print(f"Q8, a layer's seven sites (bf16 x, L2 cold) on {card}: "
          + "; ".join(f"M={M} kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}), plain {r['plain_ms']:.4f}, _int_mm "
                      f"{r['library_ms']:.4f}" for M, r in ((32, q8), (4096, q8["m4096"]))),
          flush=True)
    kernel_results["mlp_w4"] = run_mlp_checks(gen)
    phase_done("3 kernels")

    # Phase 4: the main path: W4, A8, Q8 and MLP arms.
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.ops.kernels import matmul_q8

    model, qparams, fparams, q8params, q8_s = build_models()
    print(f"Q8 tree: calibration (8x128 ids, on the card) and QLINEAR quantization of 126 "
          f"sites in {q8_s:.2f} s", flush=True)
    layers = model.cfg.num_layers
    w4_sites = {"w4": 4 * layers, "w8": 1}  # qkv, o, gate_up, down; the lm_head
    w4_launches, w4_logits = run_main_path(model, qparams, "W4 body, W8 head", w4_sites,
                                           w4_sites)
    # bench's tree with the whole of it converted: W4A8 on the body and W8A8 on
    # the lm_head (the TPU ablation converted the body only).
    a8params = convert_to_w4a8(qparams)
    a8_sites = {"w4a8": 4 * layers, "w8a8": 1}
    a8_launches, a8_logits = run_main_path(model, a8params, "W4A8 body, W8A8 head", a8_sites,
                                           a8_sites, exact=True)
    print(f"prefill logits A8 vs W4 arm (quantization error, not gated): mean_abs_diff="
          f"{(a8_logits.float() - w4_logits.float()).abs().mean().item():.4e} "
          f"mean|logit|={w4_logits.float().abs().mean().item():.4e}", flush=True)
    # Q8: seven unfused QLINEAR sites a layer; held to the run with only Q8
    # plain (the W8 head runs its kernel in both).
    q8_sites = {"q8": 7 * layers, "w8": 1}
    q8_launches, q8_logits = run_main_path(model, q8params, "Q8 body, W8 head", q8_sites,
                                           q8_sites, exact=True, plain_only=[matmul_q8])
    print(f"prefill logits Q8 vs W4 arm (quantization error, not gated): mean_abs_diff="
          f"{(q8_logits.float() - w4_logits.float()).abs().mean().item():.4e}", flush=True)
    # The MLP arm: prefill (M = 4096) fails the fused MLP's M <= 256 and stays
    # on W4; each decode step (M = 32) runs it in every layer.
    mlp_launches, _ = run_main_path(model, qparams, "W4 body with fused MLP, W8 head", w4_sites,
                                    {"mlp_w4": layers, "w4": 2 * layers, "w8": 1}, mega=True)
    launches = {k: w4_launches[k] for k in ("w4", "w8")}
    launches.update({k: a8_launches[k] for k in ("w4a8", "w8a8")})
    launches["q8"] = q8_launches["q8"]
    launches["mlp_w4"] = mlp_launches["mlp_w4"]
    phase_done("4 main path")

    # Phase 5: rates.
    # The loop is host-bound and the host is shared, so the arms take turns
    # (the order rotates each round) and each reports the median of 5 samples.
    # The fused arm is the quantized engine with flash decode in every layer;
    # the MLP arm is the quantized engine with the fused MLP.
    arms = {"quantized": decode_arm(model, qparams, kv_quant=True),
            "quantized fused": decode_arm(model, qparams, kv_quant=True, fused=True),
            "w4a8": decode_arm(model, a8params, kv_quant=True),
            "q8": decode_arm(model, q8params, kv_quant=True),
            "quantized mlp": decode_arm(model, qparams, kv_quant=True, mega=True),
            "bf16": decode_arm(model, fparams, kv_quant=False)}
    rates = {name: [] for name in arms}
    names = list(arms)
    for r in range(5):
        for name in names[r % len(names):] + names[:r % len(names)]:
            rates[name].append(arms[name]())
    rate_q, rate_f, rate_a8, rate_q8, rate_mlp, rate_bf16 = (float(np.median(rates[n]))
                                                             for n in names)
    samples = {n: [round(v, 1) for v in r] for n, r in rates.items()}
    print(f"decode tok/s samples: {json.dumps(samples)}")
    print(f"decode tok/s (B=32, prompt 128, slope 16->48 steps, CUDA events, median of 5) on "
          f"{card}: quantized W4+int8 head+int8 KV {rate_q:.1f}, with flash decode "
          f"{rate_f:.1f}, W4A8+W8A8 head+int8 KV {rate_a8:.1f}, Q8+int8 head+int8 KV "
          f"{rate_q8:.1f}, quantized with fused MLP {rate_mlp:.1f}, bf16 {rate_bf16:.1f}, ratio "
          f"quantized/bf16 {rate_q / rate_bf16:.3f}, fused/unfused {rate_f / rate_q:.3f}, "
          f"w4a8/quantized {rate_a8 / rate_q:.3f}, q8/quantized {rate_q8 / rate_q:.3f}, "
          f"mlp/quantized {rate_mlp / rate_q:.3f}", flush=True)
    phase_done("5 rates")

    # Phase 6: window scoring (the flash-attention path), W4 and A8 models.
    w4_scoring, a8_scoring = run_window_scoring(model, qparams, a8params, fparams, card)
    launches["flash_attention"] = w4_scoring["flash_attention"]
    check(a8_scoring["flash_attention"] == launches["flash_attention"],
          "the A8 model's window scoring launched another flash-attention count")
    phase_done("6 window scoring")

    # Phase 7: decode-path scoring (the flash-decode path).
    launches["flash_decode"] = run_decode_scoring(model, qparams, card)["flash_decode"]
    phase_done("7 decode scoring")

    # Launches of one A8 site: the activation quantizer alone, and the whole
    # site through the dispatch (quantizer, pad, kernel, cast), beside the W4
    # site's, at the qkv shape of a decode step with the engine's baked scales.
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.ops import quantized_matmul
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4a8 import quantize_activation_int8

    x = torch.randn((32, 640), generator=gen, device="cuda").to(torch.bfloat16)
    qkv = {arm: prepare_kernel_scales(params)["layers.0"]["attn"]["_fused_qkv"]["w"]
           for arm, params in (("a8", a8params), ("w4", qparams))}
    q8_q = q8params["layers.0"]["attn"]["q_proj"]["w"]
    counted = {"activation quantizer": count_launches(lambda: quantize_activation_int8(x)),
               "A8 qkv site": count_launches(lambda: quantized_matmul(x, qkv["a8"])),
               "W4 qkv site": count_launches(lambda: quantized_matmul(x, qkv["w4"])),
               "Q8 q site": count_launches(lambda: quantized_matmul(x, q8_q))}
    print("device launches per call at M=32, K=640, bf16 x (torch.profiler): "
          + ", ".join(f"{k} {v[0]} ({', '.join(v[1])})" for k, v in counted.items()), flush=True)
    for arm, params, mega in (("W4+int8 head", qparams, False),
                              ("W4A8+W8A8 head", a8params, False),
                              ("Q8+int8 head", q8params, False),
                              ("W4+int8 head with fused MLP", qparams, True)):
        prof = profile_decode(model, params, mega=mega)
        print(f"decode step profile, {arm} (B=32, int8 KV, torch.profiler, mean of 4 steps) on "
              f"{card}: launches {prof['launches']:.0f}, device busy {prof['busy_ms']:.3f} ms "
              f"(quantized matmul kernels {prof['matmul_ms']:.3f}, Q8 among them "
              f"{prof['q8_ms']:.3f}, other "
              f"{prof['other_ms']:.3f}), wall {prof['wall_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}", flush=True)
    prof = profile_window(model, qparams)
    print(f"window profile, W4+int8 head (one 2048-token window, torch.profiler) on {card}: "
          f"launches {prof['launches']}, device busy {prof['busy_ms']:.3f} ms (W4 kernels "
          f"{prof['w4_ms']:.3f}, W8 {prof['w8_ms']:.3f}, flash attention "
          f"{prof['flash_attention_ms']:.3f}), wall {prof['wall_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}", flush=True)
    phase_done("8 launch counts")

    # name in the kernels line, CUDA source, replaced TPU kernel.
    sources = {
        "w4": ("w4_dequant_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w4.cu",
               "onnx_quantize_tpu/ops/kernels/matmul_w4.py:32"),
        "w8": ("w8_dequant_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w8.cu",
               "onnx_quantize_tpu/ops/kernels/matmul_w8.py:27"),
        "w4a8": ("w4a8_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w4a8.cu",
                 "onnx_quantize_tpu/ops/kernels/matmul_w4a8.py:33"),
        "w8a8": ("w8a8_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w8a8.cu",
                 "onnx_quantize_tpu/ops/kernels/matmul_w8a8.py:28"),
        "flash_attention": ("flash_attention", "onnx_quantize_tpu_torch/csrc/flash_attention.cu",
                            "onnx_quantize_tpu/ops/kernels/flash_attention.py:30"),
        "flash_decode": ("flash_decode", "onnx_quantize_tpu_torch/csrc/flash_decode.cu",
                         "onnx_quantize_tpu/ops/kernels/flash_decode.py:38"),
        "q8": ("q8_matmul", "onnx_quantize_tpu_torch/csrc/matmul_q8.cu",
               "onnx_quantize_tpu/ops/kernels/matmul_q8.py:29"),
        "mlp_w4": ("mlp_w4", "onnx_quantize_tpu_torch/csrc/mlp_w4.cu",
                   "onnx_quantize_tpu/ops/kernels/mlp_w4.py:78"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        res = kernel_results[key]
        check(launches[key] > 0, f"its path launched no {name} kernel")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
