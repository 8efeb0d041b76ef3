#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``onnx_quantize_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero; each prints its seconds):

1. Device: a CUDA device is required; prints the card's name and power limit
   and turns TF32 off for float32 matmuls and convolutions.
2. Build: compiles the Hopper kernels from ``onnx_quantize_tpu_torch/csrc``.
3. Kernels: each kernel against its plain PyTorch version on the card, timed
   with CUDA events. W4/W8 at the main path's shapes (a decode step, M=32,
   and a 32x128 prefill, M=4096) and at odd shapes (ragged M and N, a pad
   group, signed and unsigned weights), in bfloat16 and float32. Flash
   decode at B=32, S=4096, 4 query heads on 1 KV head of 256, ragged
   positions (0, tile edges, the pos = S sentinel), window 512 and none, odd
   shapes, timed at B=32, S=1024, pos=640. Flash attention at T=S=2048 and
   512 in bfloat16, window 512 and none, and an odd float32 shape.
4. Main path: Gemma-3-270M at full width in bfloat16 from a seeded init, W4
   g128 body plus int8 per-channel lm_head, fused q/k/v and gate/up, an int8
   KV cache at B=32 and max_seq=512: prefill 32 prompts of 128 tokens, 64
   greedy decode steps, then ``generate`` on 3 ragged prompts. Checks the
   kernel launch counts, finite logits, tokens in range, and prefill logits
   against the same engine with the kernels swapped for their plain versions.
5. Rates: decode tokens/s for the quantized arm, the same with flash decode
   (``fused_attention=True``) and an unquantized bf16 arm, by the slope
   between two step counts timed with CUDA events; the arms take turns, and
   each reports the median of 5 samples.
6. Window scoring: ``perplexity_from_tokens`` of the phase-4 model over a
   seeded 4096-token stream (windows of 2048, stride 512: 5 windows), which
   runs flash attention in every layer. Checks the launch counts per window,
   a finite result, and the mean NLL against the same run with every kernel
   swapped for its plain version; prints the bf16 model's ppl beside it.
7. Decode-path scoring: ``score_nll`` of 32 seeded rows of 640 tokens through
   an engine with an int8 cache and ``fused_attention=True`` (flash decode in
   every layer of every one-token forward, past the 512-token window).
   Checks the launch counts and the NLL against ``fused_attention=False``;
   prints ``score_ppl`` for the float, int8 and int4 caches and steps/s.

The line before the last is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0


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


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn``, each call timed alone with CUDA
    events after a 256 MB write that evicts the 50 MB L2: a decode step finds
    its weights cold, since a step streams more weight bytes than L2 holds."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# -- phase 3: kernels against their plain versions -----------------------------

def random_qtensor(K: int, N: int, dtype: str, group_size: int, symmetric: bool, gen):
    """An RTN-quantized random (K, N) weight on the card, scales baked as the
    engine bakes them."""
    from onnx_quantize_tpu_torch.algorithms import rtn_quantize
    from onnx_quantize_tpu_torch.core.qconfig import QWeightArgs
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor
    from onnx_quantize_tpu_torch.plan import resolve_group_size

    args = QWeightArgs(dtype=dtype, group_size=group_size, symmetric=symmetric)
    gs = resolve_group_size(K, group_size) or -1
    w = 0.1 * torch.randn((K, N), generator=gen, device="cuda")
    q, s, z = rtn_quantize(w, args.dtype, args.strategy, gs, symmetric, False)
    qt = make_qtensor(q, s, z, quant_type=args.dtype, strategy=args.strategy, group_size=gs,
                      symmetric=symmetric, reduce_range=False)
    return prepare_kernel_scales({"w": qt})["w"]


def kernel_operands(qt, x):
    """(wrapper, plain version, operands, keyword args) for ``x @ dequant(qt)``."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8

    if qt.meta.packed:
        return (matmul_w4.w4_matmul, matmul_w4.w4_dequant_matmul_plain,
                *matmul_w4.w4_operands(x, qt))
    return matmul_w8.w8_matmul, matmul_w8.w8_dequant_matmul_plain, *matmul_w8.w8_operands(x, qt)


# name, kernel, K, N, dtype, group_size, symmetric, rows of M, timed
KERNEL_CASES = [
    ("qkv", "w4", 640, 1536, "uint4", 128, False, (32, 4096), True),
    ("o", "w4", 1024, 640, "uint4", 128, False, (32, 4096), True),
    ("gate_up", "w4", 640, 4096, "uint4", 128, False, (32, 4096), True),
    ("down", "w4", 2048, 640, "uint4", 128, False, (32, 4096), True),
    ("lm_head", "w8", 640, 262144, "int8", -1, True, (32,), True),
    # Odd shapes: 5 groups padded to 6 and a ragged N edge; ragged M tiles;
    # int4; 4 columns per thread with a ragged edge; uint8 with zero points.
    ("odd_w4_u4_k320_g64_n200", "w4", 320, 200, "uint4", 64, False, (5, 37), False),
    ("odd_w4_i4_sym_n20000", "w4", 640, 20000, "int4", 128, True, (3, 70), False),
    ("odd_w8_i8_n40004", "w8", 640, 40004, "int8", -1, True, (5, 33), False),
    ("odd_w8_u8_asym_n1000", "w8", 640, 1000, "uint8", -1, False, (7, 65), False),
    ("odd_w8_u8_g128", "w8", 640, 999, "uint8", 128, False, (31,), False),
]

# Why these tolerances: kernel and plain version read the same inputs and form
# the same float32 products (a bf16 input times a small integer is exact in
# float32), so they differ only in the order of float32 sums over K <= 2048
# terms; 1e-4 of the output's largest magnitude bounds that for either dtype.
REL_TOL = 1e-4


def run_kernel_checks(gen) -> dict:
    results = {"w4": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0},
               "w8": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    for name, kernel, K, N, dtype, gs, sym, rows, timed in KERNEL_CASES:
        qt = random_qtensor(K, N, dtype, gs, sym, gen)
        for M in rows:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                wrapper, plain, ops, kw = kernel_operands(qt, x)
                y = wrapper(*ops, **kw)
                ref = plain(*ops, **kw)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                scale = ref.abs().max().item()
                check(bool(torch.isfinite(y).all()), f"{name} M={M} {xdt}: non-finite output")
                check(err <= REL_TOL * scale,
                      f"{name} M={M} {xdt}: max abs err {err:.3e} > {REL_TOL} * {scale:.3e}")
                line = f"kernel {kernel} {name} M={M} x={str(xdt)[6:]}: max_abs_err={err:.3e}"
                res = results[kernel]
                res["max_abs_err"] = max(res["max_abs_err"], err)
                if timed and xdt == torch.bfloat16:
                    iters = 50 if M <= 32 else 5
                    ms = cuda_time_ms(lambda: wrapper(*ops, **kw), iters)
                    plain_ms = cuda_time_ms(lambda: plain(*ops, **kw), iters)
                    line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}"
                    if M == 32:  # one decode step's shapes
                        res["ms"] += ms
                        res["plain_ms"] += plain_ms
                print(line, flush=True)
    return results


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


def run_attention_checks(gen) -> dict:
    from onnx_quantize_tpu_torch.ops.kernels import flash_attention, flash_decode

    fd, fa = flash_decode, flash_attention
    results = {}
    # Flash decode: ragged positions at the main shape, then odd shapes.
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
        for window in (512, 16, None):
            got = fd.flash_decode_int8(*args, window=window)
            want = fd.flash_decode_int8_reference(*args, window=window)
            torch.cuda.synchronize()
            err = check_attention(f"{name} window={window}", got, want, torch.float32)
            err_max = max(err_max, err)
            print(f"kernel flash_decode {name} window={window}: max_abs_err={err:.3e}", flush=True)
    # One decode step's shapes: B=32 sequences at position 640 of a 1024 cache.
    args = fd_inputs(32, 1024, 4, 1, 256, [640] * 32, gen)
    times = {}
    for window in (None, 512):
        times[window] = (cuda_time_ms(lambda: fd.flash_decode_int8(*args, window=window), 50),
                         cuda_time_ms(lambda: fd.flash_decode_int8_reference(*args, window=window),
                                      50))
        print(f"kernel flash_decode B=32 S=1024 pos=640 window={window}: "
              f"kernel_ms={times[window][0]:.4f} plain_ms={times[window][1]:.4f}", flush=True)
    results["flash_decode"] = {
        "max_abs_err": err_max,
        # Per decode step of the 270M model: 3 global and 15 local layers.
        "ms": GLOBAL_LAYERS * times[None][0] + LOCAL_LAYERS * times[512][0],
        "plain_ms": GLOBAL_LAYERS * times[None][1] + LOCAL_LAYERS * times[512][1]}

    # Flash attention: the window shapes in bf16, then an odd float32 shape.
    fa_cases = [("fa_T2048_g4_D256", (1, 2048, 4, 1, 256, torch.bfloat16)),
                ("fa_T512_g4_D256", (1, 512, 4, 1, 256, torch.bfloat16)),
                ("fa_odd_B2_T48_mha_D128_f32", (2, 48, 2, 2, 128, torch.float32))]
    err_max = 0.0
    times = {}
    for name, shape in fa_cases:
        args = fa_inputs(*shape, gen)
        for window in (512, None):
            got = fa.flash_attention(*args, sliding_window=window)
            want = fa.flash_attention_reference(*args, sliding_window=window)
            torch.cuda.synchronize()
            err = check_attention(f"{name} window={window}", got, want, shape[-1])
            err_max = max(err_max, err)
            line = f"kernel flash_attention {name} window={window}: max_abs_err={err:.3e}"
            if shape[-1] == torch.bfloat16:
                times[name, window] = (
                    cuda_time_ms(lambda: fa.flash_attention(*args, sliding_window=window), 5),
                    cuda_time_ms(lambda: fa.flash_attention_reference(
                        *args, sliding_window=window), 5))
                line += (f" kernel_ms={times[name, window][0]:.4f} "
                         f"plain_ms={times[name, window][1]:.4f}")
            print(line, flush=True)
    full = "fa_T2048_g4_D256"
    results["flash_attention"] = {
        "max_abs_err": err_max,
        # Per 2048-token scoring window of the 270M model: 3 global, 15 local layers.
        "ms": GLOBAL_LAYERS * times[full, None][0] + LOCAL_LAYERS * times[full, 512][0],
        "plain_ms": GLOBAL_LAYERS * times[full, None][1] + LOCAL_LAYERS * times[full, 512][1]}
    return results


# -- phase 4: the main path ------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swap the kernel wrappers for their plain versions (reference run only:
    the package itself never routes a CUDA tensor to a plain version)."""
    from onnx_quantize_tpu_torch.ops.kernels import (
        flash_attention,
        flash_decode,
        matmul_w4,
        matmul_w8,
    )

    swaps = [(matmul_w4, "w4_matmul", matmul_w4.w4_dequant_matmul_plain),
             (matmul_w8, "w8_matmul", matmul_w8.w8_dequant_matmul_plain),
             (flash_attention, "flash_attention", flash_attention.flash_attention_reference),
             (flash_decode, "flash_decode_int8", flash_decode.flash_decode_int8_reference)]
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), wrapper in zip(swaps, saved):
            setattr(module, name, wrapper)


def build_models():
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
    return model, fuse_gemma3_projections(qparams), fuse_gemma3_projections(params)


def run_main_path(model, qparams) -> dict:
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8

    cfg = model.cfg
    B, T, steps = 32, 128, 64
    sites_per_step = 4 * cfg.num_layers  # qkv, o, gate_up, down per layer
    engine = InferenceEngine(model, qparams, max_batch=B, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (5, 77, 128)]
    new_tokens = 8

    def counts():
        return matmul_w4.launches, matmul_w8.launches

    torch.cuda.synchronize()
    matmul_w4.launches = matmul_w8.launches = 0
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    after_prefill = counts()
    first = torch.argmax(logits, dim=-1)
    cache, generated = engine.decode_multi(cache, first, steps=steps)
    after_decode = counts()
    outputs = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    total = counts()

    check(after_prefill == (sites_per_step, 1),
          f"prefill launched {after_prefill} (W4, W8) kernels, expected ({sites_per_step}, 1)")
    decode_launches = (after_decode[0] - after_prefill[0], after_decode[1] - after_prefill[1])
    check(decode_launches == (sites_per_step * steps, steps),
          f"{steps} decode steps launched {decode_launches} (W4, W8) kernels, expected "
          f"{sites_per_step} W4 and 1 W8 per step")
    gen_steps = new_tokens  # one prefill + (new_tokens - 1) decode steps
    check(total[0] - after_decode[0] == sites_per_step * gen_steps
          and total[1] - after_decode[1] == gen_steps,
          f"generate launched {(total[0] - after_decode[0], total[1] - after_decode[1])}")
    print(f"main path launches: prefill {after_prefill}, decode x{steps} {decode_launches}, "
          f"generate {(total[0] - after_decode[0], total[1] - after_decode[1])}, "
          f"per decode step (W4, W8) = ({decode_launches[0] // steps}, "
          f"{decode_launches[1] // steps})", flush=True)

    check(tuple(logits.shape) == (B, cfg.vocab_size), f"prefill logits shape {logits.shape}")
    check(bool(torch.isfinite(logits.float()).all()), "prefill logits not finite")
    check(tuple(generated.shape) == (B, steps), f"decode output shape {generated.shape}")
    check(bool(((generated >= 0) & (generated < cfg.vocab_size)).all()), "token out of range")
    check(bool((cache["lengths"] == T + steps).all()), "cache lengths after decode")
    check([len(o) for o in outputs] == [new_tokens] * 3, "generate output lengths")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o), "generate token range")

    # The same engine with the kernels swapped for their plain versions.
    cmp_steps = 16
    with plain_kernels():
        plain_cache, plain_logits = engine.prefill(engine.new_cache(), ids, lengths)
        _, plain_tokens = engine.decode_multi(plain_cache, first, steps=cmp_steps)
    torch.cuda.synchronize()
    check(counts() == total, "the plain-version run launched kernels")
    diff = (logits.float() - plain_logits.float()).abs()
    peak = plain_logits.float().abs().max().item()
    # bf16 stream: kernel and plain site outputs differ by float32 summation
    # order, which can flip a bf16 rounding (2^-8 relative) of a site output;
    # such flips pass through 18 layers. 5% of the largest logit bounds that.
    tol = 0.05 * peak
    print(f"prefill logits kernel vs plain: max_abs_diff={diff.max().item():.4e} "
          f"mean_abs_diff={diff.mean().item():.4e} max|logit|={peak:.4e} tol={tol:.4e}",
          flush=True)
    check(diff.max().item() <= tol, "prefill logits through the kernels disagree with plain")
    agree = (generated[:, :cmp_steps] == plain_tokens).float().mean().item()
    print(f"greedy tokens equal over {cmp_steps} steps, kernel vs plain: {agree:.4f}", flush=True)
    return {"w4": total[0], "w8": total[1]}


# -- phase 5: decode rates -------------------------------------------------------

def decode_arm(model, params, kv_quant: bool, fused: bool = False, lo: int = 16, hi: int = 48):
    """A prefilled B=32 engine (``fused``: flash decode over its int8 cache);
    each call of the returned function times one sample of decode tokens/s,
    the slope between ``lo`` and ``hi`` steps."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    B, T = 32, 128
    engine = InferenceEngine(model, params, max_batch=B, max_seq=512, kv_quant=kv_quant,
                             dtype=torch.bfloat16, fused_attention=fused)
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
        matmul_w4,
        matmul_w8,
    )

    return {"w4": matmul_w4, "w8": matmul_w8, "flash_attention": flash_attention,
            "flash_decode": flash_decode}


def kernel_counts() -> dict:
    return {name: module.launches for name, module in kernel_modules().items()}


def reset_counts() -> None:
    for module in kernel_modules().values():
        module.launches = 0


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


def run_window_scoring(model, qparams, fparams, card) -> dict:
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    max_length, stride, n_tokens = 2048, 512, 4096
    windows = 1 + (n_tokens - max_length) // stride
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, n_tokens)

    def score(params):
        return timed(lambda: perplexity_from_tokens(model, params, tokens, max_length, stride))

    reset_counts()
    ppl_q, s_q = score(qparams)
    launches = kernel_counts()
    want = {"w4": 4 * cfg.num_layers * windows, "w8": windows,
            "flash_attention": cfg.num_layers * windows, "flash_decode": 0}
    check(launches == want, f"window scoring launched {launches}, expected {want}")
    check(math.isfinite(ppl_q), f"window scoring ppl {ppl_q} is not finite")
    with plain_kernels():
        ppl_plain, s_plain = score(qparams)
    check(kernel_counts() == launches, "the plain-version scoring run launched kernels")
    ppl_bf16, s_bf16 = score(fparams)
    nll_q, nll_plain = math.log(ppl_q), math.log(ppl_plain)
    tol = MEAN_NLL_REL_TOL * nll_plain
    print(f"window scoring launches over {windows} windows: {launches}; per window "
          f"{ {k: v // windows for k, v in launches.items()} }", flush=True)
    print(f"window scoring (Gemma-3-270M bf16, seed {SEED}, {n_tokens} tokens, window "
          f"{max_length}, stride {stride}) on {card}: ppl W4+int8 head kernels {ppl_q:.4f} "
          f"({1e3 * s_q / windows:.1f} ms/window), plain versions {ppl_plain:.4f} "
          f"({1e3 * s_plain / windows:.1f} ms/window), bf16 {ppl_bf16:.4f} "
          f"({1e3 * s_bf16 / windows:.1f} ms/window); mean NLL kernels vs plain "
          f"{nll_q:.6f} vs {nll_plain:.6f}, tol {tol:.2e}", flush=True)
    check(abs(nll_q - nll_plain) <= tol, "window scoring mean NLL: kernels disagree with plain")
    return launches


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
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    phase_done("2 build")

    # Phase 3: kernels against their plain versions.
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernel_results = run_kernel_checks(gen)
    kernel_results.update(run_attention_checks(gen))
    phase_done("3 kernels")

    # Phase 4: the main path.
    model, qparams, fparams = build_models()
    launches = run_main_path(model, qparams)
    phase_done("4 main path")

    # Phase 5: rates.
    # The loop is host-bound and the host is shared, so the arms take turns
    # (the order rotates each round) and each reports the median of 5 samples.
    # The fused arm is the quantized engine with flash decode in every layer.
    arms = {"quantized": decode_arm(model, qparams, kv_quant=True),
            "quantized fused": decode_arm(model, qparams, kv_quant=True, fused=True),
            "bf16": decode_arm(model, fparams, kv_quant=False)}
    rates = {name: [] for name in arms}
    names = list(arms)
    for r in range(5):
        for name in names[r % 3:] + names[:r % 3]:
            rates[name].append(arms[name]())
    rate_q, rate_f, rate_bf16 = (float(np.median(rates[n])) for n in names)
    print(f"decode tok/s samples: {json.dumps({n: [round(v, 1) for v in r] for n, r in rates.items()})}")
    print(f"decode tok/s (B=32, prompt 128, slope 16->48 steps, CUDA events, median of 5) on "
          f"{card}: quantized W4+int8 head+int8 KV {rate_q:.1f}, with flash decode "
          f"{rate_f:.1f}, bf16 {rate_bf16:.1f}, ratio quantized/bf16 {rate_q / rate_bf16:.3f}, "
          f"fused/unfused {rate_f / rate_q:.3f}", flush=True)
    phase_done("5 rates")

    # Phase 6: window scoring (the flash-attention path).
    launches["flash_attention"] = run_window_scoring(model, qparams, fparams,
                                                     card)["flash_attention"]
    phase_done("6 window scoring")

    # Phase 7: decode-path scoring (the flash-decode path).
    launches["flash_decode"] = run_decode_scoring(model, qparams, card)["flash_decode"]
    phase_done("7 decode scoring")

    # name in the kernels line, CUDA source, replaced TPU kernel.
    sources = {
        "w4": ("w4_dequant_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w4.cu",
               "onnx_quantize_tpu/ops/kernels/matmul_w4.py:32"),
        "w8": ("w8_dequant_matmul", "onnx_quantize_tpu_torch/csrc/matmul_w8.cu",
               "onnx_quantize_tpu/ops/kernels/matmul_w8.py:27"),
        "flash_attention": ("flash_attention", "onnx_quantize_tpu_torch/csrc/flash_attention.cu",
                            "onnx_quantize_tpu/ops/kernels/flash_attention.py:30"),
        "flash_decode": ("flash_decode", "onnx_quantize_tpu_torch/csrc/flash_decode.cu",
                         "onnx_quantize_tpu/ops/kernels/flash_decode.py:38"),
    }
    kernels = []
    for key, (name, source, replaces) in sources.items():
        res = kernel_results[key]
        check(launches[key] > 0, f"its path launched no {name} kernel")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"],
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
