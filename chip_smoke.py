#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``onnx_quantize_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check exits non-zero):

1. Device: a CUDA device is required; prints the card's name and power limit
   and turns TF32 off for float32 matmuls and convolutions.
2. Build: compiles the Hopper kernels from ``onnx_quantize_tpu_torch/csrc``.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (a decode step, M=32, and a 32x128 prefill, M=4096)
   and at odd shapes (ragged M and N, a pad group, signed and unsigned
   weights), in bfloat16 and float32; times both with CUDA events.
4. Main path: Gemma-3-270M at full width in bfloat16 from a seeded init, W4
   g128 body plus int8 per-channel lm_head, fused q/k/v and gate/up, an int8
   KV cache at B=32 and max_seq=512: prefill 32 prompts of 128 tokens, 64
   greedy decode steps, then ``generate`` on 3 ragged prompts. Checks the
   kernel launch counts, finite logits, tokens in range, and prefill logits
   against the same engine with the kernels swapped for their plain versions.
5. Rates: decode tokens/s for the quantized and an unquantized bf16 arm, by
   the slope between two step counts timed with CUDA events; the arms
   alternate, and each reports the median of 5 samples.

The line before the last is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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


# -- phase 4: the main path ------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Swap the kernel wrappers for their plain versions (reference run only:
    the package itself never routes a CUDA tensor to a plain version)."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8

    saved = matmul_w4.w4_matmul, matmul_w8.w8_matmul
    matmul_w4.w4_matmul = matmul_w4.w4_dequant_matmul_plain
    matmul_w8.w8_matmul = matmul_w8.w8_dequant_matmul_plain
    try:
        yield
    finally:
        matmul_w4.w4_matmul, matmul_w8.w8_matmul = saved


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

def decode_arm(model, params, kv_quant: bool, lo: int = 16, hi: int = 48):
    """A prefilled B=32 engine; each call of the returned function times one
    sample of decode tokens/s, the slope between ``lo`` and ``hi`` steps."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    B, T = 32, 128
    engine = InferenceEngine(model, params, max_batch=B, max_seq=512, kv_quant=kv_quant,
                             dtype=torch.bfloat16)
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

    # Phase 2: build.
    t0 = time.perf_counter()
    lib_path, log, build_s = build_kernel_library()
    kernel_library()
    print(f"build: {lib_path.name} nvcc {build_s:.1f} s, ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # Phase 3: kernels against their plain versions.
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernel_results = run_kernel_checks(gen)

    # Phase 4: the main path.
    model, qparams, fparams = build_models()
    launches = run_main_path(model, qparams)

    # Phase 5: rates.
    # The loop is host-bound and the host is shared, so the arms alternate
    # (q, bf16, bf16, q, ...) and each reports the median of 5 samples.
    arms = {"quantized": decode_arm(model, qparams, kv_quant=True),
            "bf16": decode_arm(model, fparams, kv_quant=False)}
    rates = {name: [] for name in arms}
    for r in range(5):
        for name in (("quantized", "bf16") if r % 2 == 0 else ("bf16", "quantized")):
            rates[name].append(arms[name]())
    rate_q, rate_bf16 = (float(np.median(rates[n])) for n in ("quantized", "bf16"))
    print(f"decode tok/s samples: {json.dumps({n: [round(v, 1) for v in r] for n, r in rates.items()})}")
    print(f"decode tok/s (B=32, prompt 128, slope 16->48 steps, CUDA events, median of 5) on "
          f"{card}: quantized W4+int8 head+int8 KV {rate_q:.1f}, bf16 {rate_bf16:.1f}, "
          f"ratio {rate_q / rate_bf16:.3f}", flush=True)

    sources = {"w4": ("onnx_quantize_tpu_torch/csrc/matmul_w4.cu",
                      "onnx_quantize_tpu/ops/kernels/matmul_w4.py:32"),
               "w8": ("onnx_quantize_tpu_torch/csrc/matmul_w8.cu",
                      "onnx_quantize_tpu/ops/kernels/matmul_w8.py:27")}
    kernels = []
    for name in ("w4", "w8"):
        res = kernel_results[name]
        check(launches[name] > 0, f"the main path launched no {name} kernel")
        kernels.append({
            "name": f"{name}_dequant_matmul", "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
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
