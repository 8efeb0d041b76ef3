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
   at a scoring window's M=2048, and W4 with HQQ's float zero points at the
   qkv and down shapes (M=32 and 2048) and a ragged one. W4 also at M = 1, 16, 33, 64, 65 and 2048
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
   The fused W4 MLP at the 270M widths (M=32, 1, 64, 128, 256) and a
   ragged-K int4 case, each on its launch plan's route (bf16 on the tensor
   cores, float32 on the CUDA cores) with the plan printed, twice the same
   bits, the reduction's counters back at 0, one device operation a call;
   timed in bf16 at every M of the 270M case beside the unfused W4 gate_up,
   GeGLU, W4 down it replaces and the first port's design (the CUDA-core
   route) in turns; ptxas' lines for its kernels printed.
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
   through ``mlp_megakernel=True``, 18 fused-MLP (every one on the
   tensor-core route), 36 W4 and 1 W8 launches per decode step (prefill at
   M=4096 stays on W4), prefill logits within 5% of the plain run.
4b. Quantizer algorithms: the same bf16 model quantized on the card (the Q8
   arm's 8x128 calibration ids) by RTN, GPTQ, AWQ and HQQ (uint4 g128) and
   SmoothQuant (the Q8 arm's QLINEAR config), each algorithm's seconds
   printed apart from its calibration forwards, and the mean per-site
   relative output error on the calibration inputs held to RTN's (GPTQ and
   AWQ no worse, HQQ within 10%). Layer 0 quantized again by the port on the
   CPU from the card's weights and captured inputs: equal codes for RTN, HQQ
   and SmoothQuant, 95% for GPTQ, 99% for AWQ. One site's activations
   through the percentile and entropy calibrators on the card and the CPU:
   equal counts and ranges. Each tree, with the int8 lm_head, through phase
   4's sequence: GPTQ converted to W4A8 (72 W4A8 + 1 W8A8 a forward, equal to
   the plain run), AWQ (126 W4 + 1 W8: its prescales keep every site
   unfused), HQQ (72 W4 + 1 W8, float zero points), SmoothQuant (126 Q8 + 1
   W8, equal to the run with Q8 plain); then the window NLL of each beside
   the bf16 and RTN models'.
4c. QuaRot on Llama-3.2-1B (published widths: hidden 2048, 16 layers, 32
   query heads on 8 KV heads of 64, vocab 128,256, llama3 rope scaling),
   random weights from seed 0 at Llama's initializer range (std 0.02).
   First W4, W8, W4A8 and W8A8 at its site shapes and flash attention at its
   window shape (T=2048, D=64, GQA 4), as in phase 3. (a) float32: the model
   through the QuaRot pass (R1 and the online R2/R3/R4) against the
   unrotated one, prefill logits at B=4, T=128 within 1e-3 of the largest.
   Then the bf16 model through ``RotateConfig`` with RTN uint4 g128 on the
   body and the int8 per-channel lm_head, fused: (b) converted to W4A8 (64
   W4A8 + 1 W8A8 a forward) through phase 4's sequence, logits and tokens
   equal to the plain run; (c) the W4 tree (64 W4 + 1 W8), within 5%,
   beside a sensitivity control (the plain run against itself with one bf16
   ulp added to 0.1% of the embedding); (d) window scoring of (c), flash
   attention in all 16 layers, mean NLL within 0.2% of the plain run; (e)
   the W4A8 tree saved and loaded as a checkpoint: bit-equal logits once the
   online rotations are stamped again, other logits without; (f) layer 0's
   down_proj through
   MatMulNBits export and import: equal codes, scales, zero points and W4
   outputs; (g) the structured-weight Llama anchor (hidden 256, 4 layers):
   plain per-channel int4 loses more than 10 ppl and the rotation recovers
   at least 70% of it. Prints its seconds and peak device memory.
4d. Mixture-of-Experts at Qwen1.5-MoE-A2.7B's published widths (60 experts,
   top-4, experts 1408 wide, a 5632-wide shared expert behind a sigmoid gate,
   hidden 2048, 24 layers, 16 heads of 128 with q/k/v biases, vocab 151,936,
   untied head), full depth, bf16, random weights from seed 0 (projections
   at std 0.02). First W4 at its new shapes (q/k/v/o, an expert's gate_up
   and down, the shared pair, the fused layout's 168,960-wide gate_up and
   84,480-deep down) at M=32 and 4096 against its plain version, beside its
   bound and the dequantize-once bf16 matmul; flash decode at 16 heads on 16
   of 128 and flash attention at the 2048-token window. RTN uint4 g128 and
   g64 on the card (router and shared gate left float), the int8 head, then
   the engine layouts: g128 keeps every layer in the loop (11 groups) and
   stacks it, g64 fuses every layer. (a) the stacked tree and (b) the fused
   one, the ragged prefill off: prefill 32 prompts of 128 and 32 greedy
   steps over an int8 cache, W4 launches gated per forward (q, k, v, o, the
   shared pair and the experts' sites), prefill logits within 5% of the
   plain run's largest, 90% of the routing choices alike, the served tokens
   teacher-forced through the plain run (``TF_EXACT_MIN`` its argmax, worst
   margin under ``TF_MARGIN_MAX``), beside a no-kernel sensitivity control
   read the same ways; (c) (a)'s tokens through flash decode; (d) (a) as
   W4A8/W8A8 at B=4, logits and tokens equal to plain; (e) one 2048-token
   window of (a) on "auto", NLL within 0.2% of plain; (f) the ragged prefill
   against the dense-masked experts, layer 0 timed at M from 8 to 4096 and
   the whole model's logits and forward time compared, the numbers behind
   ``RAGGED_MIN_M``. Prints its seconds and peak memory.
5. Rates: decode tokens/s for the quantized arm, the same with flash decode
   (``fused_attention=True``), the W4A8 arm, the Q8 arm, the quantized arm
   with the fused MLP and an unquantized bf16 arm, by
   the slope between two step counts timed with CUDA events; the arms take
   turns, and each reports the median of 3 samples.
6. Window scoring: ``perplexity_from_tokens`` of the phase-4 model over a
   seeded 4096-token stream (windows of 2048, stride 512: 5 windows), which
   runs flash attention in every layer. Checks the launch counts per window,
   a finite result, and the mean NLL against the same run with every kernel
   swapped for its plain version, for the W4 and the A8 model, every W8, W4A8
   and W8A8 launch on the tensor-core route; for the A8 model also an equal
   ppl with only its two matmul kernels swapped; prints
   the bf16 model's ppl beside them.
7. Decode-path scoring: ``score_nll`` of 32 seeded rows of 544 tokens through
   the first 6 of the 270M's 18 layers, five sliding-window and one global
   (``DECODE_SCORING_LAYERS``; a depth cut for the time limit) and an engine with an int8 cache and
   ``fused_attention=True`` (flash decode in every layer of every one-token
   forward, past the 512-token window).
   Checks the launch counts and the NLL against ``fused_attention=False``;
   prints ``score_ppl`` for the float, int8 and int4 caches and steps/s.
8. Launch counts and profiles (below).
9. Serving: the continuous-batching scheduler at the JAX serving probe's
   load (``scripts/tpu_bench_serving.py:51-90``: 128 requests from seed 0,
   prompts of 32-128 ids, budgets of 48-96; B=32, max_seq 512, int8 KV) over
   phase 4's trees. (a) The W4 tree, all 128 requests, chunk 16, narrow
   admission, pipeline 1 then 4: every request done, each output its
   budget's length (or ended on EOS or max_seq), ids in range,
   ``stats["emitted"]`` equal to the tokens handed out, one W8 and 72 W4
   launches for every forward (the decode steps and one admission prefill a
   round that admits) and no other; 16 requests' prompt + output fed back
   through the decode path at M=32, each served token's logit within 5% of
   the row's largest |logit| of the largest. (b) The A8 tree, the first 32
   requests (8 sampled at temperature 0.8, top-k 50, top-p 0.95; 4 with (a)'s
   most frequent token as EOS; 8 behind a registered 64-token prefix), chunk
   8, pipeline 2: W4A8 and W8A8 launched, every output and the stats equal
   to the run with both kernels swapped for their plain versions, from the
   same seed. (c) (a)'s tree with ``fused_attention=True`` on the first 32
   requests: 18 flash-decode launches a decode step, and (a)'s
   teacher-forced check. Prints each arm's generated and total tok/s beside
   phase 5's fixed-batch W4 rate, occupancy, rounds and admission rounds,
   latency percentiles and seconds.
10. Speculative decoding: Gemma-3-1B (published widths: hidden 1152,
   intermediate 6912, 4 query heads on 1 KV head of 256, vocab 262,144) cut
   to the first 6 of its 26 layers (``SPEC_TARGET_LAYERS``, five
   sliding-window and one global; a depth cut for the time limit), bf16 from
   seed 0, W4 g128 body and int8
   per-channel lm_head, fused, int8 KV, max_seq 512, as the target (its
   sites are among phase 3's cases at M = 8 and 40). delta is twice the
   largest |difference| between the target's (B, k+1) verify logits and its
   one-token steps' over the same prefix; a greedy stream must equal the
   target-only one or first leave it where the target-only top-2 logits lie
   within delta. (a) Phase 4's 270M W4 tree with flash decode drafts, k=4,
   B=8, prompts of 128 seeded ids, 32 new tokens: one round's launches (4
   draft steps of 72 W4, 1 W8 and 18 flash decode; a verify of 24 W4 and 1
   W8) counted under ``torch.cuda.set_sync_debug_mode("error")``, the delta
   rule against target-only ``generate``; prints rounds, mean emitted per
   live round, ms a round and tok/s beside target-only decode (CUDA
   events), and one verify's ``write_kv_window`` against the masked
   ``write_kv``. (b) The 1B tree drafting for itself: at least 0.9 k
   emitted a live round, and the delta rule. (c) Both trees converted to
   W4A8/W8A8, B=4: greedy and sampled streams and a blob equal to the run
   with both kernels plain, two sampled runs from one seed equal. (d)
   ``SpeculativeScheduler`` with (b)'s pair, rounds 4, over phase 9's first
   16 requests: every request done within its budget, the stats consistent,
   the delta rule against the ``ContinuousBatchingScheduler`` over the
   target alone; tok/s of both. Prints its seconds and peak memory.

11. Model families and ways in. (a) Phase 4's float Gemma-3-270M (the
   same seed) written as a two-shard BF16 Hugging Face checkpoint (HF's
   names, (out, in) projections, the tied head left out), read back by
   ``load_gemma3_hf(..., dtype=torch.bfloat16)`` with every leaf bit-equal,
   quantized as phase 4 (W4 g128 body, int8 head, fused) into a tree equal
   to phase 4's, served (B=32, prompt 128, 16 greedy steps) with phase 4's
   stream; then ``python -m onnx_quantize_tpu_torch.tools.perplexity`` in a
   subprocess over 4,096 seeded tokens (5 windows of 2048, stride 512):
   ``--hf-weights`` (the float32 model: flash attention on the CUDA cores)
   and ``--checkpoint`` on the W4 tree saved by ``save_checkpoint``, each
   within 1e-4 of ``perplexity_from_tokens`` in process. (b) TransformerLM
   at GPT-2 small's published widths (768 wide, 12 layers of 12 heads, 3072
   inner, vocab 50,257, 1024 positions; projections at its initializer
   range 0.02) over (8, 1024) ids: BASELINE config 2 (72 W8 a forward
   behind dynamic uint8 inputs), config 3 (static uint8 in and out,
   percentile 0.995) as QDQ (72 W8) and as QLINEAR (72 Q8 with QBias).
   (c) BertClassifier at BERT-base's (768 wide, 12 layers, vocab 30,522,
   max_seq 128, two classes) over 512 synthetic SST-2 sentences: the JAX
   grid's uint8_channel (W8), uint4_g128_rtn (W4, the classifier at N=2),
   wio_uint8_dynamic and wio_int8_static_sym (W8 behind the activation
   QDQ), the latter also as QLINEAR (Q8), accuracy printed. Weight-only
   arms within 1e-3 of the largest logit of the plain run, argmax equal on
   99.9% (GPT-2) or 510 of 512 (BERT); Q8 arms equal to it. An arm with
   activation QDQ on W8 turns a last-bit difference into code flips that
   compound, so it is held site by site on the plain run's own inputs and,
   as a whole, to a last-bit control (the plain run with W8's sums in
   float64). Phase 3 also runs W4 and W8 at N=2 (512 rows) and W8 and Q8
   (with an int32 bias, bit-equal) at GPT-2's sites (8192 rows), float32 x,
   timed beside their bounds. Prints the phase's seconds and peak memory.
12. Parallelism (``onnx_quantize_tpu_torch/parallel``): one world of two
   ranks, both on cuda:0, started with ``torch.multiprocessing`` (spawn)
   after phase 2's build, over gloo, chosen and printed (NCCL refuses two
   ranks on one device); ``parallel.comm`` stages every CUDA tensor through
   pinned host memory and counts it. The parent builds every tree and the
   single-device references first and shares them with the ranks; each rank
   first tries gloo's collectives once on CUDA tensors (a measurement,
   printed), then the legs, each printing its seconds, its collectives
   (calls, bytes, staged bytes) and its kernel launches: (a) the TP engine
   at Gemma-3-4B's full width, 6 layers (W4 g128, int8 head, fused, int8
   KV, flash decode) on (data 1, model 2): prefill B=8 T=128, 16 greedy
   steps (exactly 24 W4, 1 W8 and 6 flash-decode launches a step on each
   rank), 8 requests through the scheduler (chunk 2, pipeline 2); (b) EP at
   Qwen1.5-MoE-A2.7B's full width, 2 layers, stacked (g128) and fused (g64)
   experts, 30 a rank: prefill B=8 T=128 and 8 greedy steps; then
   ``a2a_moe_mlp`` over 2 x 64 token rows against the one-device MoE MLP,
   with the worst-case capacity bit-equal to none and a capacity of 4
   dropping; (c) ``tp_ops`` and ``collective`` at Gemma-3-4B's MLP shapes
   (M=256, K=2560, 10240, W4 g128) against the one-device matmul chain; (d)
   PP, Llama-3.2-1B at full width and depth in 2 stages, 4 microbatches of
   2 x 512, flash attention in the stages; (e) CP, Llama-3.2-1B, one
   2048-token window in 2 shards (``CP_RUNS``: ring and gather, zigzag and
   contiguous, at 16 layers and at 1, beside a one-ulp embedding control),
   and ``perplexity_from_tokens(mesh=)`` over 4,096 tokens against the call
   without a mesh; (f) DP, the main path's 270M tree at B=32 on (data 2,
   model 1), greedy and then sampled from a seeded generator. PP and DP
   must give the single-device logits and tokens bit for bit; TP and EP
   within ``PARALLEL_TP_TOL``/``PARALLEL_EP_TOL`` of the largest logit, which
   a control with bf16 all-reduce partials must fail, and greedy streams
   equal up to a near-tie; the ranks' launches are added to the kernels
   line. Phase 3 also runs W4 and W8 at the 4B's rank-local shapes and
   flash decode at 4 query heads on 2 KV heads. A failed rank fails the
   phase.
13. Tools and examples. (a) ``python -m
   onnx_quantize_tpu_torch.tools.benchmark --control`` in a subprocess, as
   a user runs it: w4 at the 270M's fused gate_up (32 x 640 x 4096) and
   down (32 x 2048 x 640), w8 at its lm_head (32 x 640 x 262,144), w4a8 at
   the gate_up, and the command line's defaults (w4, 1024 x 2048 x 2048);
   each must exit 0 with one JSON line of the report's keys, read 0 <
   pct_roofline <= 100 and a time no lower than the bound computed here
   from the shapes (``tool_bytes``); each is printed beside phase 3's time
   for the same kernel and shape. (b) Each example in process through its
   ``main(argv)``, under the launch counters, its checkpoint written to a
   temporary directory: gemma3_rtn and gemma3_awq at Gemma-3-270M's full
   width and depth, llama_rtn and llama_rotate_w4 (RTN) at Llama-3.2-1B's,
   moe_rtn at Qwen1.5-MoE-A2.7B's width with ``MOE_EXAMPLE_LAYERS`` of its
   24 layers (the full float32 tree is about 57 GB). Each checkpoint is
   reloaded by ``load_checkpoint`` on the card (online rotations stamped
   again; the MoE in the example's engine layout, ragged prefill off),
   prefilled (B=8, T=128) and decoded 8 greedy steps, launching exactly its
   W4 and W8 sites a forward, its logits finite and within 5% of the
   largest logit of the plain run. The serving example with its defaults
   (270M bf16, 32 requests, 8 slots, chunk 16, pipeline 8) finishes every
   request within its budget with one W8 and 72 W4 launches a forward; the
   BERT example with its defaults prints six accuracies in [0, 1]. Its
   launches go into the kernels line.

Phase 8 counts the device operations (as the nodes of a CUDA graph
captured from one call) of the activation quantizer, the zero pad of its
codes and one whole A8 site (which must be their sum plus one W4A8 kernel),
a W4 and a Q8 site (each non-zero), and profiles decode steps of the W4,
A8, Q8 and MLP arms and one scoring window of the W4 model (``torch.profiler``: launches, device
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
import struct
import subprocess
import sys
import tempfile
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
                   a8: bool = False, hqq: bool = False):
    """An RTN-quantized random (K, N) weight on the card (``a8``: with dynamic
    int8 activations; ``hqq``: HQQ-quantized, with float zero points), scales
    baked as the engine bakes them."""
    from onnx_quantize_tpu_torch.algorithms import hqq_quantize, rtn_quantize
    from onnx_quantize_tpu_torch.core.qconfig import QWeightArgs
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.nn.qtensor import make_qtensor
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.plan import resolve_group_size

    args = QWeightArgs(dtype=dtype, group_size=group_size, symmetric=symmetric)
    gs = resolve_group_size(K, group_size) or -1
    w = 0.1 * torch.randn((K, N), generator=gen, device="cuda")
    if hqq:
        q, s, z = hqq_quantize(w, args.dtype, gs)
    else:
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
    and ``ops`` operations of type ``kind`` on the card: the larger of the
    bytes over the memory rate and the operations over the peak for their
    type, at the published H100 SXM peaks (``tools.benchmark.H100``)."""
    from onnx_quantize_tpu_torch.tools.benchmark import H100

    t_bytes = bytes_moved / H100.hbm_bytes_per_s
    t_ops = ops / H100.peak_ops_per_s(kind)
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
# The rows of M of phase 10's target: a decode step at B = 8 and a verify of
# 8 x (k + 1) tokens.
SPEC_ROWS = (8, 40)
# The rows of M of phase 12's TP leg: a decode step at B = 8 and a prefill of
# 8 x 128 tokens.
SHARD_ROWS = (8, 1024)
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
    # HQQ's float zero points (not integers, so never folded as one) at the
    # 270M body's shapes, a decode step and a scoring window, and at a pad
    # group with a ragged N edge.
    ("hqq_qkv", "w4", 640, 1536, "uint4", 128, False, (32, 2048), False),
    ("hqq_down", "w4", 2048, 640, "uint4", 128, False, (32, 2048), False),
    ("hqq_odd_k320_g64_n200", "w4", 320, 200, "uint4", 64, False, (5, 37), False),
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
    # Phase 10's target, Gemma-3-1B: its four W4 body sites (K = 1152 is 9
    # groups, a pad group in the group-pair layout; N = 1536 and 13824) and
    # its W8 lm_head, at a step of B = 8 and a verify of 8 x (k + 1) = 40 rows.
    ("gemma3_1b_qkv", "w4", 1152, 1536, "uint4", 128, False, SPEC_ROWS, False),
    ("gemma3_1b_o", "w4", 1024, 1152, "uint4", 128, False, SPEC_ROWS, False),
    ("gemma3_1b_gate_up", "w4", 1152, 13824, "uint4", 128, False, SPEC_ROWS, False),
    ("gemma3_1b_down", "w4", 6912, 1152, "uint4", 128, False, SPEC_ROWS, False),
    ("gemma3_1b_lm_head", "w8", 1152, 262144, "int8", -1, True, SPEC_ROWS, False),
    # Phase 12's rank-local shapes, Gemma-3-4B at tp = 2: W4 at the fused qkv
    # (N = 2048), o (K = 1024, 8 groups), fused gate_up (N = 10240) and down
    # (K = 5120, 40 groups) shards, and W8 on the half lm_head (2560 x
    # 131,072); timed at their rows, apart from the kernels line.
    ("gemma3_4b_tp2_qkv", "w4", 2560, 2048, "uint4", 128, False, SHARD_ROWS, True),
    ("gemma3_4b_tp2_o", "w4", 1024, 2560, "uint4", 128, False, SHARD_ROWS, True),
    ("gemma3_4b_tp2_gate_up", "w4", 2560, 10240, "uint4", 128, False, SHARD_ROWS, True),
    ("gemma3_4b_tp2_down", "w4", 5120, 2560, "uint4", 128, False, SHARD_ROWS, True),
    ("gemma3_4b_tp2_lm_head", "w8", 2560, 131072, "int8", -1, True, (8,), True),
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


def run_kernel_checks(gen, cases=KERNEL_CASES) -> dict:
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
    for name, kernel, K, N, dtype, gs, sym, rows, timed in cases:
        qt = random_qtensor(K, N, dtype, gs, sym, gen, a8=kernel in ("w4a8", "w8a8"),
                            hqq=name.startswith("hqq_"))
        check(qt.meta.float_zero_point == name.startswith("hqq_"),
              f"{name}: float zero points not recorded as such")
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
                        and (kernel != "w4" or M in W4_TIMED + SHARD_ROWS)):
                    iters = 50 if M <= 32 else 20
                    ms = cuda_time_ms(lambda: wrapper(*ops, **kw), iters)
                    plain_ms = cuda_time_ms(lambda: plain(*ops, **kw), iters)
                    b_ms, b_by = bound(nbytes(*ops, y), 2 * M * K * N, MATMUL_KIND[kernel])
                    line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
                             f"({b_by})")
                    res.setdefault("case_ms", {})[(name, M)] = ms
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
# 270M MLP (M=256 runs the kernel past the predicate's cap at these widths;
# M=64 and 128 place the crossover with the unfused pair), and a ragged
# gate-up group (K=192, g64: 3 groups padded to 4) in int4.
MLP_CASES = [
    ("mlp_270m", 640, 2048, "uint4", 128, False, (32, 1, 64, 128, 256), True),
    ("odd_mlp_k192_i256_g64_int4", 192, 256, "int4", 64, True, (5,), False),
]
# Why: the kernel and its plain version (the unfused chain of the W4 plain
# version) form the same float32 products, summed in another order; in
# float32 1e-4 of max|y| bounds that. In bfloat16, act rounds to bf16
# between the products, and an h one float32 ulp apart can round the other
# way (2^-8 relative on one act element): 1e-2 of max|y|.
MLP_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas' lines (registers, spills) for the entry functions whose
    mangled names hold ``kernel``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("Compiling entry function" in line or "registers" in line
                     or "spill" in line):
            lines.append(line.strip())
    return lines


def run_mlp_checks(gen, log: str) -> dict:
    """The fused MLP against its plain version on its plan's route, each
    case's plan printed, two launches bit-equal, the reduction's counters
    back at 0 and one device operation a call (``torch.profiler``, M=32);
    the 270M widths timed in bf16 at M=1, 32, 64, 128 and 256 beside the
    unfused W4 gate_up, GeGLU and W4 down it replaces and the first port's design
    (the simt route, which runs that kernel) on the same operands. The M=32
    numbers go to the kernels line; ``res["by_m"]`` holds every timed M."""
    from onnx_quantize_tpu_torch.ops.kernels import mlp_w4, pad_to_multiple
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import w4_matmul

    for line in ptxas_lines(log, "mlp_w4"):
        print(f"  ptxas mlp_w4: {line}")
    res = {"max_abs_err": 0.0, "library_ms": None, "by_m": {}}
    for name, K, inter, dtype, gs, sym, rows, timed in MLP_CASES:
        gu = random_qtensor(K, 2 * inter, dtype, gs, sym, gen)
        dn = random_qtensor(inter, K, dtype, gs, sym, gen)
        for M in rows:
            for xdt in (torch.bfloat16, torch.float32):
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                ops, kw = mlp_w4.mlp_w4_operands(x, gu, dn)
                plan = mlp_w4.mlp_w4_plan(M, ops[0].shape[1], inter, K, kw["gs_g"],
                                          kw["gs_d"], xdt)
                on_route = mlp_w4.route_launches[plan.route]
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
                check(mlp_w4.route_launches[plan.route] == on_route + 2,
                      f"{name} M={M}: mlp_w4 did not take its plan's {plan.route} route")
                check(split_scratch_clear(), f"{name} M={M}: the reduction's counters not at 0")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                line = (f"kernel mlp_w4 {name} M={M} x={str(xdt)[6:]}: max_abs_err={err:.3e} "
                        f"plan={plan.route} tj={plan.tj} bm={plan.bm}x{plan.passes} "
                        f"cluster={plan.cluster} blocks={plan.blocks} "
                        f"scratch={plan.scratch_elems} counters={plan.tiles} "
                        f"smem={plan.smem_bytes}")
                if timed and xdt == torch.bfloat16:
                    x2d, wg, sg, zg, wd, sd, zd = ops
                    before_plan = mlp_w4.simt_plan(M, inter, K)

                    def before():
                        return mlp_w4.launch(*ops, **kw, plan=before_plan)

                    def unfused():
                        h = w4_matmul(x2d, wg, sg, zg, gs=kw["gs_g"], signed=kw["signed_g"])
                        act = torch.nn.functional.gelu(h[:, :inter], approximate="tanh")
                        act = (act * h[:, inter:]).to(x2d.dtype)
                        act = pad_to_multiple(act, 1, 2 * wd.shape[0]).contiguous()
                        return w4_matmul(act, wd, sd, zd, gs=kw["gs_d"], signed=kw["signed_d"])

                    old = before()
                    torch.cuda.synchronize()
                    old_err = (old - ref).abs().max().item()
                    check(old_err <= MLP_REL_TOL[xdt] * scale,
                          f"{name} M={M}: the first design disagrees by {old_err:.3e}")
                    # Kernel and first design in turns (A, B, B, A), after a warm-up
                    # that brings the card's clocks up.
                    t = {"ms": [], "before_ms": []}
                    for key, fn in (("ms", lambda: mlp_w4.mlp_w4(*ops, **kw)),
                                    ("before_ms", before), ("before_ms", before),
                                    ("ms", lambda: mlp_w4.mlp_w4(*ops, **kw))):
                        t[key].append(cuda_time_ms(fn, 25, warmup=20))
                    r = {"ms": sum(t["ms"]) / 2, "before_ms": sum(t["before_ms"]) / 2,
                         "plain_ms": cuda_time_ms(lambda: mlp_w4.mlp_w4_plain(*ops, **kw), 50),
                         "unfused_ms": cuda_time_ms(unfused, 50)}
                    r["bound_ms"], r["bound_by"] = bound(
                        nbytes(*ops, y), 2 * M * K * 2 * inter + 2 * M * inter * K, "bf16")
                    res["by_m"][M] = r
                    if M == 32:
                        # One device operation a call on either route: no memset.
                        for route, fn in (("mma", lambda: mlp_w4.mlp_w4(*ops, **kw)),
                                          ("simt", before)):
                            n_ops, names = count_launches(fn)
                            check(n_ops == 1, f"{name}: one fused-MLP call on the {route} route "
                                              f"launched {n_ops} device operations: {names}")
                        line += " device_ops_per_call=1"
                        res.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "unfused_ms", "before_ms")})
                    line += (f" kernel_ms={r['ms']:.4f} ({t['ms'][0]:.4f}, {t['ms'][1]:.4f}) "
                             f"before_first_design_ms={r['before_ms']:.4f} "
                             f"({t['before_ms'][0]:.4f}, {t['before_ms'][1]:.4f}) "
                             f"unfused_w4_pair_ms={r['unfused_ms']:.4f} "
                             f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                             f"({r['bound_by']}) before_err={old_err:.3e}")
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
    # The last is phase 12's TP decode, Gemma-3-4B at tp = 2: 4 query heads on
    # 2 KV heads of 256, B = 8, its window 1024; timed beside its bound.
    fd_cases = [("fd_B32_S4096_g4_D256", (B, S, 4, 1, 256, ragged)),
                ("fd_odd_g1_D128_S128", (3, 128, 2, 2, 128, [0, 127, 128])),
                ("fd_odd_kv2_D128", (4, 512, 4, 2, 128, [0, 63, 300, 512])),
                ("fd_odd_kv2_g4_D256_S128", (2, 128, 8, 2, 256, [127, 5])),
                ("fd_tp2_g2_D256", (8, 1024, 4, 2, 256, [0, 127, 128, 511, 640, 1023, 1024,
                                                         900]))]
    err_max = 0.0
    for name, shape in fd_cases:
        args = fd_inputs(*shape, gen)
        b, s_len, _, hkv = shape[:4]
        timed = name == "fd_tp2_g2_D256"
        for window in (512, 16, 1024, None) if timed else (512, 16, None):
            plan = fd.fd_plan(b, hkv, s_len, window, sms)
            got = fd.flash_decode_int8(*args, window=window)
            again = fd.flash_decode_int8(*args, window=window)
            want = fd.flash_decode_int8_reference(*args, window=window)
            torch.cuda.synchronize()
            err = check_attention(f"{name} window={window}", got, want, torch.float32)
            check(torch.equal(got, again), f"{name} window={window}: two flash-decode launches "
                                           "differ")
            err_max = max(err_max, err)
            line = (f"kernel flash_decode {name} window={window}: max_abs_err={err:.3e} "
                    f"splits={plan.splits} blocks={plan.blocks}")
            if timed and window in (1024, None):
                q, k, ks, v, vs, pos = args
                rows = live_rows(pos, s_len, window)
                b_ms, b_by = bound(nbytes(q, pos, got) + rows * nbytes(k[0, 0], v[0, 0],
                                                                      ks[0, 0], vs[0, 0]),
                                   4 * rows * q.shape[1] * q.shape[2], "float32")
                ms = cuda_time_ms(lambda: fd.flash_decode_int8(*args, window=window), 20)
                plain_ms = cuda_time_ms(
                    lambda: fd.flash_decode_int8_reference(*args, window=window), 5)
                line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} ({b_by})"
            print(line, flush=True)
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

    swaps = [(matmul_w4, "w4_matmul", w4_plain_in_row_chunks),
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


# The W4 plain version forms a (groups, M, N) float32 product; at a prefill's
# M the fused MoE sites would need tens of GB of it, so reference runs take
# it in row chunks of at most this many bytes (each row's arithmetic is the
# same either way).
PLAIN_W4_SCRATCH_BYTES = 8 << 30


def w4_plain_in_row_chunks(x2d, data, scales, zps, *, gs: int, signed: bool):
    """The W4 plain version over row chunks of x2d (reference runs only)."""
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import w4_dequant_matmul_plain

    rows = max(1, PLAIN_W4_SCRATCH_BYTES // (4 * (2 * data.shape[0] // gs) * data.shape[1]))
    return torch.cat([w4_dequant_matmul_plain(x2d[i:i + rows], data, scales, zps, gs=gs,
                                              signed=signed)
                      for i in range(0, max(x2d.shape[0], 1), rows)])


def build_models():
    """The Gemma-3-270M bf16 model from a seeded init, and its W4 tree (W4 g128
    body, int8 per-channel lm_head, fused), float tree (fused) and Q8 tree
    (QLINEAR body calibrated on the card, int8 weight-only lm_head, fused:
    the QLINEAR sites stay unfused). Returns (model, its unfused float params,
    the W4, float and Q8 trees, calibration and quantization seconds)."""
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
    return (model, params, fuse_gemma3_projections(qparams), fuse_gemma3_projections(params),
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


# -- phase 4b: quantizer algorithms ----------------------------------------------

# Why these thresholds (set before the first run; PERF.md section 6):
# on one layer's sites the card and the CPU run the same algorithm on the same
# weights and captured inputs. RTN, HQQ and SmoothQuant take their divisions
# by device scalars and their powers and sums in float64, so their codes must
# be equal. GPTQ's Hessian and Cholesky factors and AWQ's losses are float32
# matmuls that each device's library sums in its own order; a code flipped at a
# rounding tie feeds GPTQ's error forward, and a near-tie between two of AWQ's
# grid ratios would change a whole site: GPTQ must keep 95% of the codes
# equal, AWQ 99%.
CPU_CODE_SHARE = {"RTN": 1.0, "HQQ": 1.0, "SmoothQuant": 1.0, "GPTQ": 0.95, "AWQ": 0.99}
# The JAX package's accuracy pins' relations (tests/integration/
# test_pinned_accuracy.py:57-90): GPTQ and AWQ no worse than RTN at the same
# bit width, HQQ within 10% of it, on the mean per-site relative output error.
ERROR_RELATION = {"GPTQ": 1.0, "AWQ": 1.0, "HQQ": 1.1}


def site_inputs(model, params, calib) -> dict:
    """Every site's input taps of the float model over the calibration ids
    (float32, (samples, T, K)): what the algorithms' first calibration sees."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.calibration import collect_activations
    from onnx_quantize_tpu_torch.plan import build_plan

    plan = build_plan(model.linear_sites(), oqt.QConfig(weights=oqt.QWeightArgs(),
                                                        ignore=["lm_head"]))
    cp = oqt.CalibrationParams()
    batches = collect_activations(model, params, plan, calib, cp.num_samples, cp.batch_size,
                                  None, tap_inputs=True, tap_outputs=False)
    return {e.name: torch.cat([b[e.name]["input"].float() for b in batches]) for e in plan}


def mean_site_error(model, params, qparams, inputs) -> float:
    """Mean over the body's sites of ||X W - (X prescale) dq(Wq)|| / ||X W||
    on the float model's calibration inputs X."""
    from onnx_quantize_tpu_torch.ops.reference import dequantize_weight
    from onnx_quantize_tpu_torch.utils import tree_get

    errs = []
    for site in model.linear_sites():
        if site.name not in inputs:
            continue
        x = inputs[site.name].reshape(-1, site.in_features)
        qsite = tree_get(qparams, site.param_path)
        want = x @ tree_get(params, site.param_path)["w"].float()
        xs = x * qsite["prescale"] if "prescale" in qsite else x
        got = xs @ dequantize_weight(qsite["w"])
        errs.append(((want - got).norm() / want.norm()).item())
    return float(np.mean(errs))


def timed_quantize(model, params, qconfig):
    """(tree, plan, calibration seconds, algorithm seconds) of ``quantize``:
    the calibration forwards timed apart from the rest."""
    import onnx_quantize_tpu_torch as oqt
    import onnx_quantize_tpu_torch.prepasses as prepasses

    calibrate, spent = prepasses.calibrate_model, []

    def timed_calibrate(*args):
        _, secs = timed(lambda: calibrate(*args))
        spent.append(secs)

    prepasses.calibrate_model = timed_calibrate
    try:
        (tree, plan), total = timed(lambda: oqt.quantize(model, params, qconfig))
    finally:
        prepasses.calibrate_model = calibrate
    return tree, plan, sum(spent), total - sum(spent)


def layer_codes_on_cpu(name: str, model, params, trees: dict, inputs: dict, layer: int = 0):
    """Share of layer ``layer``'s codes that the port computes alike on the
    CPU, from the card's weights and captured inputs, for arm ``name``."""
    from onnx_quantize_tpu_torch.algorithms import gptq_quantize, hqq_quantize, rtn_quantize
    from onnx_quantize_tpu_torch.core.dtypes import QuantType
    from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
    from onnx_quantize_tpu_torch.core.qconfig import QWeightArgs
    from onnx_quantize_tpu_torch.ops.reference import unpack_weight
    from onnx_quantize_tpu_torch.prepasses.awq import AwqPass
    from onnx_quantize_tpu_torch.utils import tree_get

    group = QuantizationStrategy.GROUP
    equal = total = 0
    for site in model.linear_sites():
        if not site.name.startswith(f"layers.{layer}."):
            continue
        w = tree_get(params, site.param_path)["w"].float().cpu()
        x = inputs[site.name].cpu()
        if name == "RTN":
            q, _, _ = rtn_quantize(w, QuantType.QUInt4, group, 128, False, False)
        elif name == "HQQ":
            q, _, _ = hqq_quantize(w, QuantType.QUInt4, 128)
        elif name == "GPTQ":
            q, _, _ = gptq_quantize(w, x, QuantType.QUInt4, group, 128)
        elif name == "AWQ":
            scales, losses = AwqPass(False).scale_grid(
                w, x, QWeightArgs(dtype="uint4", group_size=128))
            w = scales[torch.argmin(losses)].reshape(-1, 1) * w
            q, _, _ = rtn_quantize(w, QuantType.QUInt4, group, 128, False, False)
        else:  # SmoothQuant, then int8 per-channel symmetric RTN
            act = torch.clamp(x.reshape(-1, site.in_features).abs().amax(dim=0), min=1e-5)
            from onnx_quantize_tpu_torch.core.numerics import pow_f32

            s = pow_f32(act, 0.5) / pow_f32(w.abs().amax(dim=1) + 1e-9, 0.5)
            q, _, _ = rtn_quantize(s.reshape(-1, 1) * w, QuantType.QInt8,
                                   QuantizationStrategy.CHANNEL, -1, True, False)
        card = unpack_weight(tree_get(trees[name], site.param_path)["w"]).cpu()
        equal += int((card == q).sum())
        total += q.numel()
    return equal / total


def check_calibrators_on_cpu(inputs: dict, card: str) -> None:
    """One site's tapped activations through the percentile and entropy
    calibrators on the card and on the CPU, a sequence at a time (so the
    histograms grow and are rebuilt): equal counts and ranges."""
    from onnx_quantize_tpu_torch.calibration import EntropyCalibrator, PercentileCalibrator

    x = inputs["layers.3.mlp.down_proj"]
    for cls in (PercentileCalibrator, EntropyCalibrator):
        on_card, on_cpu = cls(), cls()
        for i in range(x.shape[0]):
            on_card.collect("a", x[i] * (1 + i))
            on_cpu.collect("a", (x[i] * (1 + i)).cpu())
        counts_equal = torch.equal(on_card.counts("a").cpu(), on_cpu.counts("a"))
        card_range = [t.item() for t in on_card.compute_range("a")]
        cpu_range = [t.item() for t in on_cpu.compute_range("a")]
        print(f"{cls.__name__} on layers.3.mlp.down_proj's input ({x.shape[0]} batches, "
              f"{int(on_card.counts('a').sum())} values) on {card} vs the CPU: counts equal "
              f"{counts_equal}, range {card_range} vs {cpu_range}", flush=True)
        check(on_card.counts("a").device.type == "cuda", f"{cls.__name__} counted on the host")
        check(counts_equal and card_range == cpu_range,
              f"{cls.__name__}: the card's histogram or range differs from the CPU's")


def run_quantizer_algorithms(model, params, qparams, fparams, card) -> dict:
    """GPTQ W4A8, AWQ, HQQ and SmoothQuant Q8 trees of the bf16 model,
    quantized on the card, each through its kernels (launch counts, plain
    run), its per-site error beside RTN's, a window NLL, and one layer's
    codes against the CPU's. Returns the arms' launches."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.gemma3 import fuse_gemma3_projections
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.ops.kernels import matmul_q8
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    layers = cfg.num_layers
    calib = np.random.default_rng(7).integers(1, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    inputs = site_inputs(model, params, calib)
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])
    w4 = dict(dtype="uint4", group_size=128)
    static = oqt.QActivationArgs(dtype="uint8", is_static=True)
    configs = {
        "RTN": oqt.QConfig(weights=oqt.QWeightArgs(**w4), ignore=["lm_head"]),
        "GPTQ": oqt.QConfig(weights=oqt.QWeightArgs(**w4, algorithm=oqt.GPTQConfig()),
                            ignore=["lm_head"], calibration_data=calib),
        "AWQ": oqt.QConfig(weights=oqt.QWeightArgs(**w4), preprocessors=[oqt.AwqConfig()],
                           ignore=["lm_head"], calibration_data=calib),
        "HQQ": oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", strategy="group",
                                                   group_size=128, algorithm=oqt.HqqConfig()),
                           ignore=["lm_head"]),
        "RTN int8": oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1,
                                                        symmetric=True), ignore=["lm_head"]),
        "SmoothQuant": oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
            input_activations=static, output_activations=static, format="qlinear",
            preprocessors=[oqt.SmoothQuantConfig(alpha=0.5)], calibration_data=calib,
            ignore=["lm_head"]),
    }
    trees, errors = {}, {}
    for name, qc in configs.items():
        tree, plan, calib_s, algo_s = timed_quantize(model, params, qc)
        check(len(plan) == 7 * layers and all(e.captured_input is None for e in plan),
              f"{name}: the plan lost a site or kept its captured inputs")
        trees[name] = tree
        errors[name] = mean_site_error(model, params, tree, inputs)
        print(f"quantizer {name} (Gemma-3-270M bf16, 126 body sites) on {card}: calibration "
              f"{calib_s:.2f} s, algorithm {algo_s:.2f} s; mean per-site relative output "
              f"error on the calibration inputs {errors[name]:.6f}", flush=True)
    for name, rel in ERROR_RELATION.items():
        print(f"per-site error {name} {errors[name]:.6f} vs RTN uint4 g128 {errors['RTN']:.6f} "
              f"(ratio {errors[name] / errors['RTN']:.4f}, must be <= {rel})", flush=True)
        check(errors[name] <= rel * errors["RTN"],
              f"{name}'s per-site error exceeds {rel} x RTN's")
    print(f"per-site error SmoothQuant W8 {errors['SmoothQuant']:.6f} vs RTN int8 channel "
          f"{errors['RTN int8']:.6f} (not gated)", flush=True)

    for name in ("RTN", "HQQ", "SmoothQuant", "GPTQ", "AWQ"):
        share, secs = timed(lambda: layer_codes_on_cpu(name, model, params, trees, inputs))
        print(f"layer 0 codes, {name} on {card} vs the port on the CPU: {share:.6f} equal "
              f"(threshold {CPU_CODE_SHARE[name]}, CPU {secs:.1f} s)", flush=True)
        check(share >= CPU_CODE_SHARE[name], f"{name}: the card's layer-0 codes differ from "
                                             "the CPU's")
    check_calibrators_on_cpu(inputs, card)

    def serve(name):
        return fuse_gemma3_projections(oqt.quantize(model, trees[name], head)[0])

    launches = {}
    a8 = convert_to_w4a8(serve("GPTQ"))
    counts = {"w4a8": 4 * layers, "w8a8": 1}
    launches["GPTQ"], _ = run_main_path(model, a8, "GPTQ W4A8 body, W8A8 head", counts, counts,
                                        exact=True)
    arms = {"GPTQ": a8}
    for name, counts in (("AWQ", {"w4": 7 * layers, "w8": 1}),
                         ("HQQ", {"w4": 4 * layers, "w8": 1})):
        arms[name] = serve(name)
        launches[name], _ = run_main_path(model, arms[name], f"{name} W4 body, W8 head", counts,
                                          counts)
    arms["SmoothQuant"] = serve("SmoothQuant")
    counts = {"q8": 7 * layers, "w8": 1}
    launches["SmoothQuant"], _ = run_main_path(model, arms["SmoothQuant"],
                                               "SmoothQuant Q8 body, W8 head", counts, counts,
                                               exact=True, plain_only=[matmul_q8])

    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 4096)
    nll = {}
    for name, tree in (("bf16", fparams), ("RTN", qparams), *arms.items()):
        ppl, secs = timed(lambda: perplexity_from_tokens(model, tree, tokens, 2048, 512))
        check(math.isfinite(ppl), f"{name} window ppl {ppl} is not finite")
        nll[name] = math.log(ppl)
    print(f"window scoring mean NLL (4096 tokens, window 2048, stride 512) on {card}: "
          + ", ".join(f"{k} {v:.6f}" for k, v in nll.items()), flush=True)
    return launches


# -- phase 4c: QuaRot on Llama-3.2-1B ---------------------------------------------

# The Llama-3.2-1B body's sites (K, N): the fused qkv, o, the fused gate_up and
# down; the lm_head (2048, 128256). W4 and W8 at a decode step (M=32) and a
# scoring window (M=2048), W4A8 at M=32 and a 32x128 prefill (M=4096), W8A8
# at M=32 and M=2048; checked and timed as the 270M cases are.
LLAMA_KERNEL_CASES = [
    *((name, kernel, K, N, "uint4", 128, False, rows, True)
      for kernel, rows in (("w4", (32, 2048)), ("w4a8", (32, 4096)))
      for name, K, N in (("llama_qkv", 2048, 3072), ("llama_o", 2048, 2048),
                         ("llama_gate_up", 2048, 16384), ("llama_down", 8192, 2048))),
    ("llama_lm_head", "w8", 2048, 128256, "int8", -1, True, (32, 2048), True),
    ("llama_lm_head", "w8a8", 2048, 128256, "int8", -1, True, (32, 2048), True),
]
# Why (set before the first run, PERF.md section 6): the rotated float32
# model computes the same function as the unrotated one; they differ by the
# float32 rounding of the folded weights (2^-24 relative) and float32 sums in
# another order, carried through 16 layers. A narrower model (hidden 512, 16
# layers) on the CPU moved its logits by 1.6e-5 of the largest; 1e-3 of the
# largest logit bounds that at full width, while a wrong fold moves them by
# the logits' own size.
ROTATION_REL_TOL = 1e-3
# Llama's published initializer range (its HF config.json's
# "initializer_range": 0.02). The port's Linear.init draws 0.1 times a
# truncated standard normal (the JAX package's init); at Llama-3.2-1B's widths
# that draw makes a chaotic pre-norm decoder (no post-norms cap the residual
# stream), in which a one-ulp change of a few embedding entries moves the bf16
# logits by more than the W4 arm's 5% bar (PERF.md section 6). The
# phase's projections are drawn at 0.02, so the bar tells the W4 kernel's
# summation order from a fault.
LLAMA_INIT_STD = 0.02
# The structured anchor's ask (tests/integration/test_rotate_ppl.py:49-55):
# plain per-channel int4 loses more than 10 ppl, and the rotation recovers at
# least 70% of that gap.
ANCHOR_MIN_GAP, ANCHOR_MAX_SHARE = 10.0, 0.3


def run_window_flash_attention(gen, name: str, Hq: int, Hkv: int, D: int, layers: int) -> dict:
    """Flash attention at a model's window shape (T=2048, ``Hq`` query heads on
    ``Hkv`` KV heads of ``D``, causal, bf16) against its plain version, and one
    window's ``layers`` layers timed: the kernel, the plain version and SDPA."""
    from onnx_quantize_tpu_torch.ops.kernels import flash_attention as fa

    B, T = 1, 2048
    args = fa_inputs(B, T, Hq, Hkv, D, torch.bfloat16, gen)
    plan = fa.fa_plan(B, T, T, Hq, Hkv, D, None, torch.bfloat16)
    routes = dict(fa.route_launches)
    got = fa.flash_attention(*args, sliding_window=None)
    want = fa.flash_attention_reference(*args, sliding_window=None)
    torch.cuda.synchronize()
    check(plan.route == "mma" and fa.route_launches["mma"] == routes["mma"] + 1,
          f"{name} flash attention did not take the tensor-core route")
    err = check_attention(name, got, want, torch.bfloat16)
    res = {"max_abs_err": err,
           "ms": layers * cuda_time_ms(lambda: fa.flash_attention(*args, sliding_window=None), 20),
           "plain_ms": layers * cuda_time_ms(
               lambda: fa.flash_attention_reference(*args, sliding_window=None), 5),
           "library_ms": layers * sdpa_ms(*args, None)}
    res["bound_ms"], res["bound_by"] = bound(
        layers * nbytes(*args, got), layers * 4 * B * Hq * D * causal_pairs(T, None), "bf16")
    print(f"kernel flash_attention {name} ({layers} causal layers): {describe(plan)} "
          f"max_abs_err={err:.3e} kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"sdpa_ms={res['library_ms']:.4f} bound_ms={res['bound_ms']:.5f} "
          f"({res['bound_by']})", flush=True)
    return res


def llama_params(model) -> dict:
    """Llama-3.2-1B's random weights from seed 0: the port's init with every
    projection scaled from the Linear init's 0.1 to ``LLAMA_INIT_STD`` (the
    embedding's 0.02 is already Llama's; the tied lm_head views it)."""
    from onnx_quantize_tpu_torch.utils import tree_get

    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    for site in model.linear_sites():
        if site.name != "lm_head":
            node = tree_get(params, site.param_path)
            node["w"] = node["w"] * (LLAMA_INIT_STD / 0.1)
    return params


def bump_embedding(tree) -> tuple[dict, int]:
    """``tree`` with one bf16 ulp added to 0.1% of the embedding's entries
    (seeded), and the count bumped: a control of the model's own sensitivity."""
    emb = tree["embed"]["w"]
    bump = torch.rand(emb.shape, generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
                      device="cuda") < 1e-3
    return {**tree, "embed": {"w": torch.where(
        bump, torch.nextafter(emb, torch.full_like(emb, math.inf)), emb)}}, int(bump.sum())


def sensitivity_control(model, tree, card) -> None:
    """The W4 arm's bar beside the model's own sensitivity: the plain run's
    prefill logits against the plain run with one bf16 ulp added to 0.1% of
    the embedding's entries (no kernel differs). Not gated."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    B, T = 32, 128
    ids = np.random.default_rng(SEED).integers(1, model.cfg.vocab_size, size=(B, T))
    bumped, n_bumped = bump_embedding(tree)
    logits = []
    with plain_kernels():
        for t in (tree, bumped):
            engine = InferenceEngine(model, t, max_batch=B, max_seq=512, kv_quant=True,
                                     dtype=torch.bfloat16)
            logits.append(engine.prefill(engine.new_cache(), ids,
                                          np.full((B,), T, np.int32))[1].float())
    diff = (logits[1] - logits[0]).abs().max().item()
    peak = logits[0].abs().max().item()
    print(f"sensitivity control (Llama-3.2-1B QuaRot W4, plain, {n_bumped} embedding "
          f"entries one bf16 ulp up) on {card}: prefill logits max_abs_diff={diff:.4e} "
          f"({diff / peak:.4f} of max|logit| {peak:.4e}; not gated)", flush=True)


def llama_exactness(card) -> None:
    """Arm (a): the float32 Llama-3.2-1B and the same model through the
    QuaRot pass (R1, R2, R3, R4): prefill logits at B=4, T=128."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.llama import LLAMA32_1B, Llama
    from onnx_quantize_tpu_torch.plan import QuantPlan
    from onnx_quantize_tpu_torch.utils import copy_tree

    model = Llama(LLAMA32_1B)
    params = llama_params(model)
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, LLAMA32_1B.vocab_size, size=(4, 128))).to("cuda")
    with torch.inference_mode():
        ref = model(params, ids).float()
        rotate = oqt.RotateConfig(rotate_qk=True, rotate_v=True, rotate_down=True, seed=SEED)
        rotated = copy_tree(params)
        (_, secs) = timed(lambda: rotate.build_pass(None)(model, rotated, QuantPlan(), None))
        out = model(rotated, ids).float()
    diff = (out - ref).abs().max().item()
    peak = ref.abs().max().item()
    print(f"Llama-3.2-1B float32 QuaRot R1+R2/R3/R4 (fold {secs:.2f} s on the card) on {card}: "
          f"prefill logits B=4 T=128 rotated vs unrotated max_abs_diff={diff:.4e} "
          f"({diff / peak:.3e} of max|logit| {peak:.4e}), tol {ROTATION_REL_TOL:.0e} of it",
          flush=True)
    check(bool(torch.isfinite(out).all()), "the rotated Llama's logits are not finite")
    check(diff <= ROTATION_REL_TOL * peak, "the rotated float32 Llama's logits moved")


def llama_structured_anchor(card) -> None:
    """Arm (g): test_rotate_ppl's structured-weight Llama (hidden 256, 4
    layers, vocab 2048) on the card, float32: fp, per-channel int4 and
    rotate + per-channel int4 ppl over the pins' 2048-token Zipf stream."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.llama import Llama, tiny_llama_config
    from onnx_quantize_tpu_torch.models.structured import structured_params, zipf_tokens
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    model = Llama(tiny_llama_config(vocab_size=2048, hidden_size=256, intermediate_size=1024,
                                    num_layers=4, num_heads=4, num_kv_heads=1, head_dim=64))
    params = structured_params(model, device="cuda")
    tokens = zipf_tokens(2048, 2048)
    qc = dict(weights=oqt.QWeightArgs(dtype="int4", group_size=-1), ignore=["lm_head"])
    trees = {"fp": params,
             "int4 channel": oqt.quantize(model, params, oqt.QConfig(**qc))[0],
             "rotate + int4 channel": oqt.quantize(model, params, oqt.QConfig(
                 preprocessors=[oqt.RotateConfig(seed=3)], **qc))[0]}
    ppl = {k: perplexity_from_tokens(model, t, tokens, max_length=256, stride=128)
           for k, t in trees.items()}
    gap, gap_rot = ppl["int4 channel"] - ppl["fp"], ppl["rotate + int4 channel"] - ppl["fp"]
    print(f"structured Llama anchor (hidden 256, 4 layers, 2048 tokens, window 256, stride 128; "
          f"the CPU pins 1965.2, 2017.5, 1968.0) on {card}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ppl.items())
          + f"; int4 gap {gap:.4f}, rotated gap {gap_rot:.4f} "
          f"({100 * (1 - abs(gap_rot) / gap):.1f}% recovered)", flush=True)
    check(gap > ANCHOR_MIN_GAP, "per-channel int4 lost no more than 10 ppl on the anchor")
    check(abs(gap_rot) < ANCHOR_MAX_SHARE * gap, "the rotation recovered less than 70% of the "
                                                 "int4 gap on the anchor")


def run_llama_quarot(card) -> dict:
    """Phase 4c: QuaRot on Llama-3.2-1B at full width, random weights from
    seed 0 (arms (a)-(g), PERF.md section 4). Returns the launches of its
    kernels."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.interop import export_matmul_nbits, import_matmul_nbits
    from onnx_quantize_tpu_torch.models.gemma3 import fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.llama import LLAMA32_1B, Llama
    from onnx_quantize_tpu_torch.nn.qtensor import unpack_k_pairs
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8, quantized_matmul
    from onnx_quantize_tpu_torch.prepasses.rotate import stamp_online_rotations

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llama_exactness(card)
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(LLAMA32_1B, dtype="bfloat16")
    model = Llama(cfg)
    params = llama_params(model)
    rotate = oqt.RotateConfig(rotate_qk=True, rotate_v=True, rotate_down=True, seed=SEED)
    body = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
                       preprocessors=[rotate], ignore=["lm_head"])
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])
    (q, plan), q_s = timed(lambda: oqt.quantize(model, params, body))
    del params
    check(len(plan) == 7 * cfg.num_layers and model.layers[0].attn.qk_rot is not None
          and model.layers[0].mlp.down_rot is not None,
          "QuaRot quantize: a site missing or the online rotations not stamped")
    q, _ = oqt.quantize(model, q, head)
    print(f"Llama-3.2-1B bf16 QuaRot (R1+R2/R3/R4, seed {SEED}) and RTN uint4 g128 of "
          f"{len(plan)} body sites on the card: {q_s:.2f} s", flush=True)
    w4 = fuse_gemma3_projections(q)
    a8 = convert_to_w4a8(w4)
    layers = cfg.num_layers

    # (b) QuaRot W4A8, equal to the plain run; (c) QuaRot W4, within 5%.
    counts = {"w4a8": 4 * layers, "w8a8": 1}
    a8_launches, a8_logits = run_main_path(model, a8, "Llama-3.2-1B QuaRot W4A8 body, W8A8 "
                                           "head", counts, counts, exact=True)
    counts = {"w4": 4 * layers, "w8": 1}
    w4_launches, _ = run_main_path(model, w4, "Llama-3.2-1B QuaRot W4 body, W8 head", counts,
                                   counts)
    sensitivity_control(model, w4, card)

    # (d) window scoring of the W4 tree: flash attention in all 16 layers.
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 4096)
    fa_launches, _ = score_windows(model, w4, tokens, "w4", "w8",
                                   "Llama-3.2-1B bf16 QuaRot W4+int8 head", card)

    # (e) the W4A8 tree through a checkpoint: bit-equal logits once the online
    # rotations are stamped again, different logits without the stamp.
    B, T = 32, 128
    ids = np.random.default_rng(SEED).integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)

    def prefill(m, tree):
        engine = InferenceEngine(m, tree, max_batch=B, max_seq=512, kv_quant=True,
                                 dtype=torch.bfloat16)
        return engine.prefill(engine.new_cache(), ids, lengths)[1]

    with tempfile.TemporaryDirectory() as tmp:
        (_, save_s) = timed(lambda: save_checkpoint(tmp, model, a8, plan))
        ((model2, a8_back), load_s) = timed(lambda: load_checkpoint(tmp, device="cuda"))
    unstamped = prefill(model2, a8_back)
    stamp_online_rotations(model2, qk=True, down=True, block=rotate.online_block, seed=SEED)
    reloaded = prefill(model2, a8_back)
    stamp_diff = (unstamped.float() - a8_logits.float()).abs().max().item()
    print(f"checkpoint of the Llama QuaRot W4A8 tree on {card}: save {save_s:.2f} s, load "
          f"{load_s:.2f} s; prefill logits after reload and stamp equal: "
          f"{torch.equal(reloaded, a8_logits)}; without the stamp max_abs_diff "
          f"{stamp_diff:.4e}", flush=True)
    check(model2.cfg == cfg, "the checkpoint rebuilt another config")
    check(torch.equal(reloaded, a8_logits), "the reloaded, re-stamped W4A8 tree's logits differ")
    check(stamp_diff > 0, "the reloaded tree gave the same logits without the online stamp")

    # (f) MatMulNBits export and import of layer 0's down_proj (a W4 site).
    site = q["layers.0"]["mlp"]["down_proj"]["w"]
    art = export_matmul_nbits(site)
    back = import_matmul_nbits(art.data, art.scales, art.zero_points, K=art.K, N=art.N,
                               bits=art.bits, block_size=art.block_size, device="cuda")
    K = site.meta.shape[0]
    codes_equal = torch.equal(unpack_k_pairs(back.data, K, False, back.meta.pack_group),
                              unpack_k_pairs(site.data, K, False, site.meta.pack_group))
    qp_equal = (torch.equal(back.scale, site.scale)
                and torch.equal(back.zero_point.float(), site.zero_point.float()))
    x = torch.randn((32, K), generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda").to(torch.bfloat16)
    out_equal = torch.equal(quantized_matmul(x, back), quantized_matmul(x, site))
    print(f"MatMulNBits export/import of layer 0's down_proj ({K}x{art.N}, uint4, block "
          f"{art.block_size}) on {card}: codes equal {codes_equal}, scales and zero points "
          f"equal {qp_equal}, W4 outputs equal {out_equal}", flush=True)
    check(codes_equal and qp_equal and out_equal, "MatMulNBits round trip changed the site")

    del q, w4, a8, a8_back, reloaded, unstamped
    torch.cuda.empty_cache()
    llama_structured_anchor(card)
    print(f"phase 4c Llama-3.2-1B QuaRot on {card}: {time.perf_counter() - t0:.1f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    launches = {k: a8_launches[k] for k in ("w4a8", "w8a8")}
    launches.update({k: w4_launches[k] + fa_launches[k] for k in ("w4", "w8")})
    launches["flash_attention"] = fa_launches["flash_attention"]
    return launches


# -- phase 4d: Mixture-of-Experts at Qwen1.5-MoE-A2.7B's width --------------------

# W4 at the MoE path's shapes new to the port (name, K, N, group size): the
# attention sites (q, k and v carry biases, so they stay unfused, each
# 2048 x 2048 as o is), one routed expert's fused gate_up and its down
# (K = 1408: 11 groups and one pad group at g128), the shared expert's pair,
# and the fused layout's two sites at g64 (60 experts' gate_up along N,
# their down along K); at a decode step (M=32) and a 32x128 prefill (M=4096).
MOE_W4_SHAPES = [("attn_q_k_v_o", 2048, 2048, 128), ("expert_gate_up", 2048, 2816, 128),
                 ("expert_down", 1408, 2048, 128), ("shared_gate_up", 2048, 11264, 128),
                 ("shared_down", 5632, 2048, 128), ("fused_gate_up", 2048, 168960, 64),
                 ("fused_down", 84480, 2048, 64)]
MOE_ROWS = (32, 4096)
# Why: in a bf16 stream the W4 kernel and its plain version differ in float32
# summation order, which flips bf16 roundings of activations. A router's
# logits are bf16 (the stream dtype, as in the reference), so a flipped last
# bit of its input moves a near-tied top-4 choice, that token then takes
# another expert's output, and through attention and later routers the
# difference spreads: on an H100 about 95% of the (token, layer) choices come
# out alike and no row alike in all 24 layers (PERF.md section 6). So the W4
# arms hold phase 4's 5% of the largest logit on every row of the prefill
# logits, 90% of the choices alike, and the served tokens teacher-forced
# through the plain run: at least TF_EXACT_MIN of them its argmax, the worst
# margin under TF_MARGIN_MAX of the row's largest |logit|. A no-kernel
# control, (a)'s tree with one bf16 ulp on 0.1% of the embedding, is read
# the same ways beside them. On an H100 (PERF.md section 6) the sound arms'
# worst margins were 0.0114-0.0123 and the control's 0.0172, so the margin
# bar sits between them: a kernel that moves the logits as much as that
# perturbation fails it. The argmax share does not tell them apart (arms
# 0.9669-0.9805, control 0.9659); its bar sits under both.
MOE_CHOICES_ALIKE_MIN = 0.90
TF_EXACT_MIN, TF_MARGIN_MAX = 0.95, 0.015
# The ragged prefill's rows of M timed against the dense-masked experts, per
# source layout; the logits of the whole model compared at the ones marked.
MOE_RAGGED_M = {"stacked": (8, 32, 128, 512, 2048, 4096), "fused": (512, 1024, 2048, 4096)}
MOE_RAGGED_LOGITS_M = {"stacked": (128, 512, 4096), "fused": (4096,)}


def run_moe_kernel_checks(gen, card) -> dict:
    """W4 at the MoE shapes against its plain version (twice the same bits),
    timed beside its bound and the dequantize-once bf16 ``torch.matmul``;
    flash decode at the MoE decode shape (16 query heads on 16 KV heads of
    128) and flash attention at its window shape. Returns per-shape W4 rows
    and the flash-attention result."""
    from onnx_quantize_tpu_torch.ops.kernels import flash_decode as fd
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for name, K, N, gs in MOE_W4_SHAPES:
        qt = random_qtensor(K, N, "uint4", gs, False, gen)
        for M in MOE_ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ops, kw = matmul_w4.w4_operands(x, qt)
            y = matmul_w4.w4_matmul(*ops, **kw)
            again = matmul_w4.w4_matmul(*ops, **kw)
            ref = w4_plain_in_row_chunks(*ops, **kw)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            scale = ref.abs().max().item()
            del ref
            check(bool(torch.isfinite(y).all()), f"moe {name} M={M}: non-finite W4 output")
            check(err <= REL_TOL * scale, f"moe {name} M={M}: W4 max abs err {err:.3e} > "
                                          f"{REL_TOL} * {scale:.3e}")
            check(torch.equal(y, again), f"moe {name} M={M}: two W4 launches differ")
            check(split_scratch_clear(), f"moe {name} M={M}: K-split scratch not back at 0")
            plan = matmul_w4.w4_plan(M, ops[0].shape[1], N, gs, torch.bfloat16, sms)
            iters = 20 if M <= 32 else 5
            ms = cuda_time_ms(lambda: matmul_w4.w4_matmul(*ops, **kw), iters)
            plain_ms = cuda_time_ms(lambda: w4_plain_in_row_chunks(*ops, **kw), 2, warmup=1)
            mm_ms, dq_ms, dq = dequant_matmul_ms(x, qt)
            del dq
            b_ms, b_by = bound(nbytes(*ops, y), 2 * M * K * N, "bf16")
            rows[(name, M)] = dict(K=K, N=N, gs=gs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, bf16_matmul_ms=mm_ms, dequant_ms=dq_ms,
                                   max_abs_err=err)
            print(f"kernel w4 moe_{name} K={K} N={N} g{gs} M={M} on {card}: max_abs_err="
                  f"{err:.3e} plan={plan.route} {plan.bm}x{plan.bn} splits={plan.splits} "
                  f"blocks={plan.blocks} kernel_ms={ms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
                  f"plain_ms={plain_ms:.4f} bf16_matmul_ms={mm_ms:.4f} (after a one-time "
                  f"dequantize of {dq_ms:.4f} ms)", flush=True)
            del x, ops, y, again
        del qt
        torch.cuda.empty_cache()
    # Flash decode at the MoE decode step: B=32 rows at positions 128-159 of a
    # 512-row cache, 16 query heads on 16 KV heads of 128 (group 1).
    pos = list(range(128, 160))
    args = fd_inputs(32, 512, 16, 16, 128, pos, gen)
    plan = fd.fd_plan(32, 16, 512, None, sms)
    got = fd.flash_decode_int8(*args, window=None)
    again = fd.flash_decode_int8(*args, window=None)
    want = fd.flash_decode_int8_reference(*args, window=None)
    torch.cuda.synchronize()
    err = check_attention("fd_moe_B32_S512_g1_D128", got, want, torch.float32)
    check(torch.equal(got, again), "moe flash decode: two launches differ")
    fd_ms = cuda_time_ms(lambda: fd.flash_decode_int8(*args, window=None), 50)
    fd_plain = cuda_time_ms(lambda: fd.flash_decode_int8_reference(*args, window=None), 20)
    # The bound as phase 3's: the live cache rows' codes and scales, the
    # queries, positions and output once; QK and PV over the live rows.
    q, k, ks, v, vs, pos_t = args
    rows = live_rows(pos_t, k.shape[1], None)
    fd_bound, fd_by = bound(nbytes(q, pos_t, got) + rows * nbytes(k[0, 0], v[0, 0], ks[0, 0],
                                                                   vs[0, 0]),
                            4 * rows * q.shape[1] * q.shape[2], "float32")
    print(f"kernel flash_decode fd_moe_B32_S512_g1_D128 (one layer, pos 128-159) on {card}: "
          f"max_abs_err={err:.3e} splits={plan.splits} blocks={plan.blocks} "
          f"kernel_ms={fd_ms:.4f} plain_ms={fd_plain:.4f} bound_ms={fd_bound:.5f} ({fd_by})",
          flush=True)
    fa = run_window_flash_attention(gen, "fa_moe_T2048_g1_D128", 16, 16, 128, 24)
    return {"w4": rows, "flash_attention": fa}


def moe_params(model) -> dict:
    """The MoE model's random weights from seed 0: the port's init with every
    projection (the router, each expert, the shared pair and its gate, the
    untied lm_head) scaled from the Linear init's 0.1 to ``LLAMA_INIT_STD``,
    which is Qwen1.5-MoE-A2.7B's published initializer range too (its HF
    config.json's "initializer_range": 0.02)."""
    from onnx_quantize_tpu_torch.utils import tree_get

    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    for site in model.linear_sites():
        node = tree_get(params, site.param_path)
        node["w"] = node["w"] * (LLAMA_INIT_STD / 0.1)
    return params


@contextlib.contextmanager
def ragged_prefill(model, mode):
    """Every MoE layer's ``use_ragged_prefill`` set to ``mode``, "auto" after."""
    for block in model.layers:
        block.mlp.use_ragged_prefill = mode
    try:
        yield
    finally:
        for block in model.layers:
            block.mlp.use_ragged_prefill = "auto"


@contextlib.contextmanager
def record_routing(model):
    """Each MoE layer's top-k expert indices of every forward, in call order."""
    records = [[] for _ in model.layers]

    def recorder(routing, store):
        def wrapped(params, x, ctx=None):
            top_p, top_i = routing(params, x, ctx)
            store.append(top_i)
            return top_p, top_i
        return wrapped

    for block, store in zip(model.layers, records):
        block.mlp._routing = recorder(block.mlp._routing, store)
    try:
        yield records
    finally:
        for block in model.layers:
            del block.mlp._routing


def routed_alike(first, second) -> tuple[torch.Tensor, list[float]]:
    """(rows whose every token chose the same expert set in every layer in both
    recordings, each layer's share of token choices alike), from the first
    forward of each recording."""
    rows = None
    per_layer = []
    for a, b in zip(first, second):
        same = (torch.sort(a[0], dim=-1).values == torch.sort(b[0], dim=-1).values).all(-1)
        rows = same.all(-1) if rows is None else rows & same.all(-1)
        per_layer.append(same.float().mean().item())
    return rows, per_layer


def describe_alike(rows, per_layer) -> str:
    return (f"rows routed alike in every layer {rows.float().mean().item():.4f}, token-layer "
            f"choices alike {float(np.mean(per_layer)):.4f} (layer 0 {per_layer[0]:.4f}, layer "
            f"{len(per_layer) // 2} {per_layer[len(per_layer) // 2]:.4f}, layer "
            f"{len(per_layer) - 1} {per_layer[-1]:.4f})")


def served_margins(engine, ids, lengths, served):
    """Feeds ``served`` (B, S) after the prompts through ``engine``: a prefill,
    then one served token a step. For each served token: the row's largest
    logit minus the token's, over the row's largest |logit|. Returns (prefill
    logits, share of served tokens exactly the argmax, worst margin)."""
    B, S = served.shape
    worst = torch.zeros((B,), dtype=torch.float32, device="cuda")
    exact = torch.zeros((B,), dtype=torch.int64, device="cuda")
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first_logits = logits
    for j in range(S):
        if j:
            cache, logits = engine.decode(cache, served[:, j - 1])
        lf = logits.float()
        top = lf.max(dim=-1).values
        tok = lf.gather(1, served[:, j:j + 1].long())[:, 0]
        worst = torch.maximum(worst, (top - tok) / lf.abs().max(dim=-1).values)
        exact += (tok == top).long()
    return first_logits, int(exact.sum()) / (B * S), float(worst.max())


def moe_expected(model, tree, B: int, T: int, expert_w4: int) -> dict:
    """W4/W8 launches of one forward over ``B`` rows of ``T`` tokens: q, k, v,
    o and the shared pair in every layer, the experts' ``expert_w4`` unless
    the ragged prefill takes them, one lm_head."""
    mlp = model.layers[0].mlp
    layer = tree["layers.0"]["mlp"]
    fused = "_stacked_experts" not in layer
    source = layer.get("_stacked_experts", layer.get("_fused_experts"))
    ragged = mlp._ragged_ok(source, (B, T, model.cfg.hidden_size), torch.device("cuda"),
                            fused_source=fused)
    return {"w4": model.cfg.num_layers * (6 + (0 if ragged else expert_w4)), "w8": 1}


def run_moe_arm(model, tree, label: str, expert_w4: int, card: str, steps: int = 32) -> dict:
    """Arms (a) and (b), with the ragged prefill off, so every expert site runs
    its W4 kernel at the prefill's M = 4096 too: prefill 32 prompts of 128
    tokens and ``steps`` greedy decode steps over an int8 cache, the launches
    gated per forward. Held to the plain run: at least MOE_CHOICES_ALIKE_MIN
    of the (token, layer) routing choices alike, the prefill logits within 5%
    of the largest on every row, and the served tokens teacher-forced through
    it, at least TF_EXACT_MIN its argmax with the worst margin under
    TF_MARGIN_MAX."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    cfg = model.cfg
    B, T = 32, 128
    engine = InferenceEngine(model, tree, max_batch=B, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16)
    ids = np.random.default_rng(SEED).integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    torch.cuda.synchronize()
    reset_counts()
    with record_routing(model) as routes:
        (cache, logits), prefill_s = timed(
            lambda: engine.prefill(engine.new_cache(), ids, lengths))
    prefill_counts = {k: v for k, v in kernel_counts().items() if v}
    first = torch.argmax(logits, dim=-1)
    (cache, generated), decode_s = timed(lambda: engine.decode_multi(cache, first, steps=steps))
    total = kernel_counts()
    step = moe_expected(model, tree, B, 1, expert_w4)
    want_prefill = moe_expected(model, tree, B, T, expert_w4)
    want_total = {k: want_prefill[k] + steps * step[k] for k in step}
    check(prefill_counts == want_prefill, f"{label} prefill launched {prefill_counts}, expected "
                                          f"{want_prefill} and no other")
    check({k: v for k, v in total.items() if v} == want_total,
          f"{label}: prefill and {steps} steps launched {total}, expected {want_total}")
    check_on_mma(label)
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()),
          f"{label}: prefill logits not finite or of shape {tuple(logits.shape)}")
    check(bool(((generated >= 0) & (generated < cfg.vocab_size)).all()), "token out of range")
    check(bool((cache["lengths"] == T + steps).all()), f"{label}: cache lengths after decode")
    print(f"phase 4d {label} on {card}: launches a prefill {prefill_counts}, a decode step "
          f"{step}; prefill {1e3 * prefill_s:.1f} ms, decode {1e3 * decode_s / steps:.1f} ms a "
          f"step (host clock, B=32, {steps} steps)", flush=True)

    served = torch.cat([first[:, None], generated], dim=1)  # (B, 1 + steps)
    counts = kernel_counts()
    with plain_kernels(), record_routing(model) as plain_routes:
        plain_logits, exact, margin = served_margins(engine, ids, lengths, served)
        torch.cuda.synchronize()
    check(kernel_counts() == counts, f"{label}: the plain-version run launched kernels")
    rows, per_layer = routed_alike(routes, plain_routes)
    choices = float(np.mean(per_layer))
    diff = (logits.float() - plain_logits.float()).abs().max().item()
    peak = plain_logits.float().abs().max().item()
    print(f"phase 4d {label} kernel vs plain: {describe_alike(rows, per_layer)}; prefill "
          f"logits max_abs_diff {diff:.4e}, max|logit| {peak:.4e}, tol {0.05 * peak:.4e}; "
          f"served tokens teacher-forced through the plain run: {exact:.4f} exactly its argmax, "
          f"worst margin {margin:.4f} of the row's largest |logit|", flush=True)
    check(choices >= MOE_CHOICES_ALIKE_MIN, f"{label}: only {choices:.4f} of the token-layer "
                                            "choices routed alike")
    check(diff <= 0.05 * peak, f"{label}: prefill logits through the kernels disagree with "
                               "plain")
    check(exact >= TF_EXACT_MIN and margin < TF_MARGIN_MAX,
          f"{label}: served tokens not the plain run's argmax ({exact:.4f}, margin {margin:.4f})")
    share = rows.float().mean().item()
    return {"launches": total, "ids": ids, "lengths": lengths, "served": served,
            "logits": logits.float(), "routes": routes,
            "prefill_ms": 1e3 * prefill_s, "step_ms": 1e3 * decode_s / steps,
            "routed_alike": share, "choices_alike": choices, "tf_exact": exact,
            "tf_margin": margin}


def moe_sensitivity_control(model, tree, arm: dict, card: str) -> dict:
    """The W4 arms' bars beside the model's own sensitivity: (a)'s tree through
    the kernels (ragged prefill off, as in (a)) with one bf16 ulp added to
    0.1% of the embedding's entries, no kernel differing. Its prefill's
    routing and logits against (a)'s, and (a)'s served tokens teacher-forced
    through it. Not gated: it shows what the bars tell apart."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    bumped, n_bumped = bump_embedding(tree)
    engine = InferenceEngine(model, bumped, max_batch=32, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16)
    with record_routing(model) as routes:
        logits, exact, margin = served_margins(engine, arm["ids"], arm["lengths"], arm["served"])
    rows, per_layer = routed_alike(arm["routes"], routes)
    diff = (logits.float() - arm["logits"]).abs().max().item()
    passes = exact >= TF_EXACT_MIN and margin < TF_MARGIN_MAX
    print(f"sensitivity control (the (a) tree through the kernels, {n_bumped} embedding "
          f"entries one bf16 ulp up) on {card}: {describe_alike(rows, per_layer)}; prefill "
          f"logits max_abs_diff {diff:.4e} ({diff / arm['logits'].abs().max().item():.4f} of "
          f"max|logit|); (a)'s served tokens teacher-forced through it: {exact:.4f} exactly its "
          f"argmax, worst margin {margin:.4f} (the W4 arms' bars {TF_EXACT_MIN} and "
          f"{TF_MARGIN_MAX}: the control {'passes' if passes else 'fails'} them; not gated)",
          flush=True)
    return {"tf_exact": exact, "tf_margin": margin, "choices_alike": float(np.mean(per_layer))}


def moe_flash_decode_arm(model, tree, arm: dict, card: str, steps: int = 16) -> dict:
    """Arm (c): (a)'s tree with ``fused_attention=True``: (a)'s served tokens
    teacher-forced through it over ``steps`` tokens, 24 flash-decode launches a
    decode step, at least TF_EXACT_MIN of the served tokens its argmax with
    the worst margin under TF_MARGIN_MAX."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    engine = InferenceEngine(model, tree, max_batch=32, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16, fused_attention=True)
    reset_counts()
    (_, exact, margin), secs = timed(lambda: served_margins(
        engine, arm["ids"], arm["lengths"], arm["served"][:, :steps]))
    launches = kernel_counts()
    layers = model.cfg.num_layers
    check(launches["flash_decode"] == (steps - 1) * layers,
          f"arm (c) launched {launches['flash_decode']} flash-decode kernels, expected "
          f"{(steps - 1) * layers}")
    print(f"phase 4d (c) flash decode (D=128, 16 heads on 16) on {card}: {steps} of (a)'s "
          f"served tokens teacher-forced, {exact:.4f} exactly the argmax, worst margin "
          f"{margin:.4f}; {launches['flash_decode']} flash-decode launches; {secs:.1f} s",
          flush=True)
    check(exact >= TF_EXACT_MIN and margin < TF_MARGIN_MAX,
          f"arm (c): (a)'s tokens not the flash-decode engine's argmax ({exact:.4f}, "
          f"margin {margin:.4f})")
    return launches


def moe_a8_arm(model, tree, card: str, steps: int = 8) -> dict:
    """Arm (d): (a)'s tree through ``convert_to_w4a8``, B=4: prefill and greedy
    decode launch W4A8 on every body site and W8A8 on the lm_head; logits and
    tokens equal to the same run on the plain kernels."""
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8

    cfg = model.cfg
    B, T = 4, 128
    engine = InferenceEngine(model, convert_to_w4a8(tree), max_batch=B, max_seq=512,
                             kv_quant=True, dtype=torch.bfloat16)
    ids = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, size=(B, T))
    lengths = np.full((B,), T, np.int32)

    def run():
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        _, toks = engine.decode_multi(cache, torch.argmax(logits, -1), steps=steps)
        return logits, toks

    reset_counts()
    (logits, toks), secs = timed(run)
    launches = kernel_counts()
    # q, k, v, o, the shared pair and every expert's gate_up and down a layer.
    want = {"w4a8": (1 + steps) * cfg.num_layers * (6 + 2 * cfg.num_experts), "w8a8": 1 + steps}
    check({k: v for k, v in launches.items() if v} == want,
          f"arm (d) launched {launches}, expected {want}")
    check_on_mma("arm (d)")
    with plain_kernels():
        (plain_logits, plain_toks), plain_secs = timed(run)
    check(kernel_counts() == launches, "arm (d): the plain-version run launched kernels")
    equal = torch.equal(logits, plain_logits) and torch.equal(toks, plain_toks)
    print(f"phase 4d (d) W4A8 body, W8A8 head (B=4, {steps} steps) on {card}: launches "
          f"{want}; logits and tokens equal to plain: {equal}; {secs:.1f} s, plain "
          f"{plain_secs:.1f} s", flush=True)
    check(equal, "arm (d): the A8 kernels disagree with their plain versions")
    return launches


def moe_scoring_arm(model, tree, card: str) -> dict:
    """Arm (e): one 2048-token window of (a)'s tree through
    ``perplexity_from_tokens``: flash attention in every layer (D=128, MHA);
    the window's NLL within 0.2% of the plain run's."""
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, 2048)
    reset_counts()
    ppl, secs = timed(lambda: perplexity_from_tokens(model, tree, tokens, 2048, 2048))
    launches = kernel_counts()
    want = moe_expected(model, tree, 1, 2048, 2 * cfg.num_experts)
    want["flash_attention"] = cfg.num_layers
    check({k: v for k, v in launches.items() if v} == want,
          f"arm (e) launched {launches}, expected {want}")
    check(kernel_modules()["flash_attention"].route_launches["mma"] == cfg.num_layers,
          "arm (e): flash attention off the tensor cores")
    with plain_kernels():
        ppl_plain, plain_secs = timed(lambda: perplexity_from_tokens(model, tree, tokens, 2048,
                                                                     2048))
    nll, nll_plain = math.log(ppl), math.log(ppl_plain)
    print(f"phase 4d (e) one 2048-token window on {card}: ppl kernels {ppl:.4f} ({secs:.2f} s), "
          f"plain {ppl_plain:.4f} ({plain_secs:.2f} s); NLL {nll:.6f} vs {nll_plain:.6f}, tol "
          f"{MEAN_NLL_REL_TOL * nll_plain:.2e}; launches {want}", flush=True)
    check(math.isfinite(ppl) and abs(nll - nll_plain) <= MEAN_NLL_REL_TOL * nll_plain,
          "arm (e): the window NLL through the kernels disagrees with plain")
    return launches


def ragged_from(times: dict):
    """The least M measured from which the ragged layer is the faster at every
    larger M measured (None where it is not the faster at the largest)."""
    least = None
    for M in sorted(times, reverse=True):
        dense, ragged = times[M]
        if ragged >= dense:
            break
        least = M
    return least


def moe_ragged_arm(model, tree, source: str, card: str) -> dict:
    """Arm (f): layer 0's experts over M rows by the ragged prefill and by the
    dense-masked layout (CUDA events, each call alone), and the whole model's
    logits and forward time (host clock) both ways at the marked M. Returns
    {M: (dense ms, ragged ms)}."""
    from onnx_quantize_tpu_torch.models import gemma3

    cfg = model.cfg
    mlp = model.layers[0].mlp
    layer = tree["layers.0"]["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    with torch.inference_mode():
        for M in MOE_RAGGED_M[source]:
            x = torch.randn((M, cfg.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
            with ragged_prefill(model, False):
                dense = cuda_time_ms(lambda: mlp(layer, x), 5)
            with ragged_prefill(model, True):
                ragged = cuda_time_ms(lambda: mlp(layer, x), 5)
            times[M] = (dense, ragged)
        for M in MOE_RAGGED_LOGITS_M[source]:
            ids = torch.from_numpy(np.random.default_rng(SEED).integers(
                1, cfg.vocab_size, size=(M // 128, 128))).to("cuda")
            with ragged_prefill(model, False), record_routing(model) as dense_routes:
                dense_logits, dense_s = timed(lambda: model(tree, ids).float())
            fetches = [b.mlp.host_fetches for b in model.layers]
            with ragged_prefill(model, True), record_routing(model) as ragged_routes:
                ragged_logits, ragged_s = timed(lambda: model(tree, ids).float())
            fetched = sum(b.mlp.host_fetches for b in model.layers) - sum(fetches)
            check(bool(torch.isfinite(ragged_logits).all()), f"ragged {source} M={M}: logits "
                                                             "not finite")
            check(fetched == cfg.num_layers, f"ragged {source} M={M}: {fetched} host fetches, "
                                             f"expected one a layer")
            alike = describe_alike(*routed_alike(dense_routes, ragged_routes))
            diff = (ragged_logits - dense_logits).abs().max().item()
            print(f"phase 4d (f) ragged vs dense-masked, {source} tree, M={M} on {card}: logits "
                  f"max_abs_diff {diff:.4e} of max|logit| {dense_logits.abs().max().item():.4e} "
                  f"(not gated: the ragged path's weights are rounded to bf16); {alike}; host "
                  f"fetches {fetched} ({cfg.num_layers} layers); the model's forward "
                  f"dense-masked {1e3 * dense_s:.1f} ms, ragged {1e3 * ragged_s:.1f} ms (host "
                  f"clock, first call each)", flush=True)
            del dense_logits, ragged_logits
    print(f"phase 4d (f) layer 0's experts, {source} tree, on {card} (CUDA events, L2 cold): "
          + "; ".join(f"M={M} dense-masked {d:.3f} ms, ragged {r:.3f} ms" for M, (d, r)
                      in times.items())
          + f"; measured: ragged the faster from M >= {ragged_from(times)}; the auto rule "
            f"(RAGGED_MIN_M) takes a prompt's forward from M >= {gemma3.RAGGED_MIN_M[source]}",
          flush=True)
    return times


def run_moe(card) -> dict:
    """Phase 4d: Qwen1.5-MoE-A2.7B at full width and depth in bf16 from seed 0
    (arms (a)-(f), PERF.md section 4). Returns the launches of its kernels."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.models.gemma3 import fuse_gemma3_projections
    from onnx_quantize_tpu_torch.utils import tree_map
    from onnx_quantize_tpu_torch.models.moe import (
        QWEN15_MOE_A27B,
        MoE,
        fuse_moe_experts,
        stack_moe_experts,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = run_moe_kernel_checks(gen, card)

    cfg = dataclasses.replace(QWEN15_MOE_A27B, dtype="bfloat16")
    model = MoE(cfg)
    params, init_s = timed(lambda: moe_params(model))
    leaves = []
    tree_map(leaves.append, params)
    print(f"Qwen1.5-MoE-A2.7B bf16 ({cfg.num_layers} layers, "
          f"{sum(t.numel() for t in leaves) / 1e9:.2f}B params, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f} GiB) initialized on "
          f"the card in {init_s:.2f} s", flush=True)
    del leaves
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])
    trees = {}
    for gs in (128, 64):
        body = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=gs),
                           ignore=["lm_head", r"\.router$", r"\.shared_gate$"])
        (q, plan), q_s = timed(lambda: oqt.quantize(model, params, body))
        q, _ = oqt.quantize(model, q, head)
        trees[gs] = q
        print(f"RTN uint4 g{gs} of {len(plan)} body sites and the int8 lm_head on the card: "
              f"{q_s:.2f} s", flush=True)
    del params, q, plan
    torch.cuda.empty_cache()
    print(f"peak device memory with the float and both quantized trees: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for gs in (128, 64):
        tree = fuse_gemma3_projections(trees.pop(gs))
        tree = fuse_moe_experts(prepare_kernel_scales(tree))
        trees[gs] = stack_moe_experts(tree)
        del tree
        torch.cuda.empty_cache()
    layouts = {gs: sorted({next(k for k in trees[gs][f"layers.{i}"]["mlp"] if k.startswith("_"))
                           for i in range(cfg.num_layers)}) for gs in trees}
    print(f"engine layouts: g128 {layouts[128]} (1408/128 = 11 groups, an odd count: "
          f"fuse_moe_experts keeps the loop, then stacked), g64 {layouts[64]}", flush=True)
    check(layouts == {128: ["_stacked_experts"], 64: ["_fused_experts"]},
          f"engine layouts {layouts}")

    # (a), its control and (c) with the ragged prefill off: every expert site
    # runs its W4 kernel at the prefill's M too. (e) keeps "auto".
    with ragged_prefill(model, False):
        arm_a = run_moe_arm(model, trees[128], "(a) stacked W4 g128", 2 * cfg.num_experts,
                            card)
        control = moe_sensitivity_control(model, trees[128], arm_a, card)
        fd_launches = moe_flash_decode_arm(model, trees[128], arm_a, card)
    counted = [arm_a["launches"], fd_launches, moe_a8_arm(model, trees[128], card),
               moe_scoring_arm(model, trees[128], card)]
    ragged = {"stacked": moe_ragged_arm(model, trees[128], "stacked", card)}
    del trees[128]
    torch.cuda.empty_cache()
    with ragged_prefill(model, False):
        arm_b = run_moe_arm(model, trees[64], "(b) fused W4 g64", 2, card)
    counted.append(arm_b["launches"])
    ragged["fused"] = moe_ragged_arm(model, trees[64], "fused", card)
    del trees
    torch.cuda.empty_cache()
    print(f"phase 4d Qwen1.5-MoE-A2.7B on {card}: {time.perf_counter() - t0:.1f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    launches = {}
    for counts in counted:
        for key, n in counts.items():
            if n:
                launches[key] = launches.get(key, 0) + n
    return {"launches": launches, "checks": checks, "ragged": ragged, "a": arm_a, "b": arm_b,
            "control": control}


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
ROUTED = ("flash_attention", "w8", "w4a8", "w8a8", "mlp_w4")


def check_on_mma(label: str, names=("w8", "w4a8", "w8a8", "mlp_w4")) -> None:
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


# cudaGraphNodeType values (CUDA runtime API).
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}


def count_graph_nodes(fn) -> tuple[int, list[str]]:
    """(count, kinds) of the device operations one ``fn()`` call launches: the
    nodes of a CUDA graph captured from the call, after a warm-up call on the
    capture stream (it fills the per-stream caches, as the K splits'
    scratch). No profiler: late in a long run a torch.profiler session can
    lose all of its device records (PERF.md section 6)."""
    import ctypes

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    try:
        cudart = ctypes.CDLL(None)  # the runtime torch loaded with global symbols
        cudart.cudaGraphGetNodes
    except AttributeError:
        cudart = ctypes.CDLL("libcudart.so.12")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cudart.cudaGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cudart.cudaGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
          "cudaGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_KINDS.get(kind.value, str(kind.value)))
    return count.value, kinds


# Kernel names (the mma routes' kernels, W8's x-stationary form among them).
MATMUL_KERNEL_NAME = re.compile(r"\b(w4a8|w8a8|w4|w8|q8|mlp_w4)(_mma(_xs)?)?_kernel\b")
Q8_KERNEL_NAME = re.compile(r"\bq8(_mma)?_kernel\b")
MLP_KERNEL_NAME = re.compile(r"\bmlp_w4(_mma)?_kernel\b")
W4_KERNEL_NAME = re.compile(r"\bw4(_mma)?_kernel\b")
W8_KERNEL_NAME = re.compile(r"\bw8(_mma(_xs)?)?_kernel\b")


def profile_decode(model, params, steps: int = 4, mega: bool = False) -> dict:
    """Per decode step of a prefilled B=32 engine (int8 KV cache, bf16), over
    ``steps`` greedy steps under ``torch.profiler``: device operations
    launched, device busy ms (their summed durations; one stream), wall ms
    (profiled, so longer than unprofiled), the idle share 1 - busy/wall, and
    the busy ms of the quantized-matmul kernels (the fused MLP among them),
    of the Q8 kernels alone, of the fused MLP alone, and of everything else."""
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
    mlp = sum(e.time_range.elapsed_us() for e in events if MLP_KERNEL_NAME.search(e.name)) / 1e3
    wall_ms = 1e3 * wall
    return {"launches": len(events) / steps, "busy_ms": busy / steps,
            "matmul_ms": matmul / steps, "q8_ms": q8 / steps, "mlp_ms": mlp / steps,
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


def score_windows(model, params, tokens, body: str, head: str, label: str, card: str,
                  exact: bool = False) -> tuple[dict, float]:
    """``perplexity_from_tokens`` of ``params`` over ``tokens`` (windows of 2048,
    stride 512) through the kernels, launching per window 4 ``body`` kernels a
    layer, one ``head`` kernel and flash attention in every layer (each on the
    tensor cores), and no other; the mean NLL against the same run with every
    kernel swapped for its plain version; when ``exact``, the ppl equal to the
    run with only the two matmul kernels plain. Returns (launches, ppl)."""
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    max_length, stride = 2048, 512
    windows = 1 + (len(tokens) - max_length) // stride

    def score():
        return timed(lambda: perplexity_from_tokens(model, params, tokens, max_length, stride))

    reset_counts()
    ppl, secs = score()
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
        ppl_plain, secs_plain = score()
    check(kernel_counts() == launches, f"the plain-version {label} scoring run launched "
                                       "kernels")
    nll, nll_plain = math.log(ppl), math.log(ppl_plain)
    tol = MEAN_NLL_REL_TOL * nll_plain
    print(f"window scoring {label} launches over {windows} windows: {launches}; per window "
          f"{ {k: v // windows for k, v in launches.items() if v} }", flush=True)
    print(f"window scoring {label} (seed {SEED}, {len(tokens)} tokens, window {max_length}, "
          f"stride {stride}) on {card}: ppl kernels {ppl:.4f} ({1e3 * secs / windows:.1f} "
          f"ms/window), plain versions {ppl_plain:.4f} ({1e3 * secs_plain / windows:.1f} "
          f"ms/window); mean NLL kernels vs plain {nll:.6f} vs {nll_plain:.6f}, tol {tol:.2e}",
          flush=True)
    check(abs(nll - nll_plain) <= tol,
          f"{label} window scoring mean NLL: kernels disagree with plain")
    if exact:
        # Only the matmul kernels swapped: they agree with their plain
        # versions bit for bit at M=2048 too, and flash attention runs in
        # both, so the ppl must be equal.
        with plain_kernels(only=[kernel_modules()[body], kernel_modules()[head]]):
            ppl_mm_plain, _ = score()
        print(f"window scoring {label}: ppl with only {body}/{head} plain "
              f"{ppl_mm_plain:.4f} vs kernels {ppl:.4f}", flush=True)
        check(ppl_mm_plain == ppl, f"{label} window scoring: the {body}/{head} kernels "
                                   "disagree with their plain versions")
    return launches, ppl


def run_window_scoring(model, qparams, a8params, fparams, card) -> tuple[dict, dict]:
    """Window scoring of the W4 and the A8 model, each through the kernels and
    with the plain versions, and of the bf16 model. Returns each quantized
    model's launches."""
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    n_tokens = 4096
    windows = 1 + (n_tokens - 2048) // 512
    tokens = np.random.default_rng(SEED).integers(0, model.cfg.vocab_size, n_tokens)
    launches, ppl_q = score_windows(model, qparams, tokens, "w4", "w8",
                                    "Gemma-3-270M bf16 W4+int8 head", card)
    launches_a8, ppl_a8 = score_windows(model, a8params, tokens, "w4a8", "w8a8",
                                        "Gemma-3-270M bf16 W4A8+W8A8 head", card, exact=True)
    ppl_bf16, s_bf16 = timed(lambda: perplexity_from_tokens(model, fparams, tokens, 2048, 512))
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


# Phase 7's depth: the first 6 of the 270M's 18 layers (five sliding-window,
# one global), cut to keep the run inside its time limit on a slow host: each
# of its one-token forwards is host-bound, so its time follows depth.
DECODE_SCORING_LAYERS = 6


def run_decode_scoring(model, qparams, card) -> dict:
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3

    full = model.cfg.num_layers
    model = Gemma3(dataclasses.replace(model.cfg, num_layers=DECODE_SCORING_LAYERS))
    qparams = {k: v for k, v in qparams.items()
               if not k.startswith("layers.") or int(k.split(".")[1]) < DECODE_SCORING_LAYERS}
    print(f"phase 7 depth cut: the first {DECODE_SCORING_LAYERS} of the model's {full} layers",
          flush=True)
    cfg = model.cfg
    B, T, max_seq = 32, 544, 1024
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


# -- phase 9: continuous-batching serving -------------------------------------------

SERVE_BATCH, SERVE_MAX_SEQ = 32, 512
# Phase 4's W4 bar read as a margin: in the teacher-forced decode a served
# token's logit lies at most 5% of the row's largest |logit| below the row's
# largest logit. The serving path and the teacher-forced one round bf16 at
# other shapes; a token read from the wrong slot's or position's KV lies far
# below that.
SERVE_MARGIN = 0.05


def serving_load(vocab: int, n: int = 128) -> list[tuple[list[int], int]]:
    """(prompt, budget) pairs of the JAX serving probe
    (``scripts/tpu_bench_serving.py:51-90``): prompts of 32-128 ids in
    [1, vocab), budgets of 48-96, drawn in its order from seed 0."""
    rng = np.random.default_rng(SEED)
    return [(rng.integers(1, vocab, size=int(rng.integers(32, 129))).tolist(),
             int(rng.integers(48, 97))) for _ in range(n)]


def serve_engine(model, params, fused: bool = False):
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    return InferenceEngine(model, params, max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                           kv_quant=True, dtype=torch.bfloat16, fused_attention=fused)


def serve(engine, reqs, chunk: int, pipeline: int, prefix=None):
    """Every (prompt, submit kwargs) request through a fresh scheduler whose
    generator is seeded with 0; returns (requests, scheduler, seconds)."""
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(
        engine, generator=torch.Generator(device="cuda").manual_seed(SEED), chunk=chunk,
        pipeline=pipeline)
    if prefix is not None:
        sched.register_prefix(prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [sched.submit(prompt, **kw) for prompt, kw in reqs]
    finished = sched.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(finished) == len(reqs) and all(r.done for r in handles),
          "serving: a request did not finish")
    return handles, sched, seconds


def check_served(label: str, handles, vocab: int, prefix_len: int = 0) -> None:
    """Every output in [0, V), of its budget's length unless it ends on its
    EOS or its sequence reached max_seq."""
    for r in handles:
        total = len(r.prompt) + (prefix_len if r.use_prefix else 0)
        check(all(0 <= t < vocab for t in r.output), f"{label}: a token out of range")
        ended = (r.eos_token_id is not None and r.output[-1] == r.eos_token_id
                 or total + len(r.output) - 1 >= SERVE_MAX_SEQ)
        check(len(r.output) == r.max_new_tokens or (ended and len(r.output) < r.max_new_tokens),
              f"{label}: request {r.request_id} emitted {len(r.output)} of {r.max_new_tokens}")


def serving_figures(label: str, handles, sched, seconds: float, card: str,
                    prefix_len: int = 0) -> float:
    """Prints the arm's rates, occupancy, rounds and latencies; returns its
    generated tok/s."""
    generated = sum(len(r.output) for r in handles)
    ingested = sum(len(r.prompt) + (prefix_len if r.use_prefix else 0) for r in handles)
    stats = sched.stats

    def pct(values, q):
        return float(np.percentile(values, q)) * 1e3

    service = [r.t_finished - r.t_admitted for r in handles]
    total = [r.t_finished - r.t_submitted for r in handles]
    print(f"serving {label} on {card}: {len(handles)} requests, {seconds:.2f} s, generated "
          f"{generated} tok/s {generated / seconds:.1f}, total (generated + {ingested} prompt) "
          f"tok/s {(generated + ingested) / seconds:.1f}, occupancy "
          f"{stats['emitted'] / max(stats['slot_steps'], 1):.4f} ({stats['emitted']} of "
          f"{stats['slot_steps']} slot-steps), rounds {stats['rounds']}, admission rounds "
          f"{stats['admit_rounds']} (planned admissions {stats['planned_admits']}), "
          f"t_finished - t_admitted p50 {pct(service, 50):.1f} ms p99 {pct(service, 99):.1f}, "
          f"t_finished - t_submitted p50 {pct(total, 50):.1f} ms p99 {pct(total, 99):.1f}",
          flush=True)
    return generated / seconds


def teacher_forced(engine, handles) -> tuple[float, float, int]:
    """Feeds up to max_batch requests' prompt + output through the engine's
    decode path at M = max_batch (a one-token prefill, then one gold token a
    step, as ``_score`` does). For each served token: the row's largest
    logit minus the token's, over the row's largest |logit|. Returns (share
    of served tokens that are exactly the argmax, worst margin, tokens)."""
    B = engine.max_batch
    rows = [r.prompt + r.output for r in handles]
    T = max(len(r) for r in rows)
    ids = np.zeros((B, T), np.int64)
    lengths = np.zeros((B,), np.int32)
    first = np.zeros((B,), np.int32)  # the first served position of each row
    for i, (r, row) in enumerate(zip(handles, rows)):
        ids[i, :len(row)] = row
        lengths[i], first[i] = len(row), len(r.prompt)
    ids_t = torch.from_numpy(ids).cuda()
    live = torch.from_numpy(np.arange(T)[None, :] < lengths[:, None]).cuda()
    first_t, lengths_t = torch.from_numpy(first).cuda(), torch.from_numpy(lengths).cuda()
    worst = torch.zeros((B,), dtype=torch.float32, device="cuda")
    exact = torch.zeros((B,), dtype=torch.int64, device="cuda")
    count = torch.zeros((B,), dtype=torch.int64, device="cuda")

    def score(logits, j):  # logits that predict position j
        nonlocal worst, exact, count
        lf = logits.float()
        top = lf.max(dim=-1).values
        tok = lf.gather(1, ids_t[:, j:j + 1])[:, 0]
        valid = (j >= first_t) & (j < lengths_t)
        worst = torch.where(valid, torch.maximum(worst, (top - tok) / lf.abs().max(dim=-1).values),
                            worst)
        exact += (valid & (tok == top)).long()
        count += valid.long()

    cache, logits = engine.prefill(engine.new_cache(), ids[:, :1], np.minimum(lengths, 1))
    score(logits, 1)
    for i in range(1, T - 1):
        cache, logits = engine.decode(cache, ids_t[:, i], active=live[:, i])
        score(logits, i + 1)
    n = int(count.sum())
    return int(exact.sum()) / n, float(worst.max()), n


def run_serving(model, qparams, a8params, card: str, fixed_rate: float) -> dict:
    """Phase 9: the scheduler over phase 4's trees at the JAX serving probe's
    load. Returns the launches of its three arms' serving runs."""
    from onnx_quantize_tpu_torch.engine import SamplingParams
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4a8, matmul_w8a8

    cfg = model.cfg
    V, per_forward = cfg.vocab_size, 4 * cfg.num_layers
    load = serving_load(V)
    launches = {name: 0 for name in kernel_modules()}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernel_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    # (a) the W4 tree, all 128 requests, chunk 16, narrow admission on.
    engine = serve_engine(model, qparams)
    reqs = [(prompt, dict(max_new_tokens=m)) for prompt, m in load]
    outputs = {}
    for pipeline in (1, 4):
        (handles, sched, seconds), counts = counted(lambda: serve(engine, reqs, 16, pipeline))
        label = f"(a) W4 body + W8 head, chunk 16, pipeline {pipeline}"
        check_served(label, handles, V)
        stats = sched.stats
        check(stats["emitted"] == sum(len(r.output) for r in handles),
              f"{label}: stats count {stats['emitted']} emitted tokens, the requests hold "
              f"{sum(len(r.output) for r in handles)}")
        # Every forward ran the kernels: one W8 a forward (the decode steps
        # and one admission prefill a round that admits), 72 W4 beside it.
        forwards = stats["rounds"] * 16 + stats["admit_rounds"]
        check(counts["w8"] == forwards and counts["w4"] == per_forward * forwards
              and sum(counts.values()) == counts["w4"] + counts["w8"],
              f"{label} launched {counts}, expected {forwards} W8 and {per_forward * forwards} "
              "W4 and no other")
        rate = serving_figures(label, handles, sched, seconds, card)
        print(f"serving {label}: launches {counts}; fixed-batch decode (phase 5, W4, B=32) "
              f"{fixed_rate:.1f} tok/s in the same run, serving/fixed "
              f"{rate / fixed_rate:.3f}", flush=True)
        outputs[pipeline] = [r.output for r in handles]
    same = np.mean([a == b for a, b in zip(outputs[1], outputs[4])])
    print(f"serving (a): outputs equal between pipeline 1 and 4 (not gated: the admission "
          f"forwards' shapes, and so the W4 launch plans, differ): {same:.4f}", flush=True)
    share, worst, n = teacher_forced(engine, handles[:16])
    print(f"serving (a) teacher-forced, 16 requests, {n} served tokens: exactly the argmax "
          f"{share:.4f}, worst margin {worst:.4f} of the largest |logit| (bar {SERVE_MARGIN})",
          flush=True)
    check(worst <= SERVE_MARGIN, f"serving (a): a served token {worst:.4f} of the largest "
                                 "|logit| below its row's largest in the teacher-forced decode")
    words = np.unique(np.concatenate([np.asarray(o) for o in outputs[4]]), return_counts=True)
    common = int(words[0][np.argmax(words[1])])

    # (b) the A8 tree, 32 requests: 8 sampled, 4 with arm (a)'s most
    # frequent token as EOS, 8 behind a registered 64-token prefix; with the
    # kernels, then with their plain versions from the same seed.
    prefix = np.random.default_rng(SEED + 2).integers(1, V, 64).tolist()
    reqs = []
    for i, (prompt, m) in enumerate(load[:32]):
        kw = dict(max_new_tokens=m)
        if i < 8:
            kw["sampling"] = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
        elif i < 12:
            kw["eos_token_id"] = common
        elif i < 20:
            kw["use_prefix"] = True
        reqs.append((prompt, kw))
    engine = serve_engine(model, a8params)
    (handles, sched, seconds), counts = counted(lambda: serve(engine, reqs, 8, 2, prefix))
    label = "(b) W4A8 body + W8A8 head, chunk 8, pipeline 2"
    check_served(label, handles, V, prefix_len=64)
    check(counts["w4a8"] > 0 and counts["w8a8"] > 0
          and sum(counts.values()) == counts["w4a8"] + counts["w8a8"],
          f"{label} launched {counts}")
    serving_figures(label, handles, sched, seconds, card, prefix_len=64)
    reset_counts()
    with plain_kernels([matmul_w4a8, matmul_w8a8]):
        plain, plain_sched, plain_s = serve(engine, reqs, 8, 2, prefix)
    torch.cuda.synchronize()
    check(sum(kernel_counts().values()) == 0, f"{label}: the plain run launched kernels")
    print(f"serving {label}: launches {counts}; plain versions {plain_s:.2f} s", flush=True)
    check([r.output for r in handles] == [r.output for r in plain]
          and sched.stats == plain_sched.stats,
          f"{label}: outputs or stats differ from the plain versions' "
          f"({sched.stats} vs {plain_sched.stats})")
    froze = sum(1 for r in handles[8:12] if r.output[-1] == common
                and len(r.output) < r.max_new_tokens)
    print(f"serving {label}: every request's output and the stats equal the plain run's; "
          f"{froze} of 4 froze on EOS {common} (not gated)", flush=True)

    # (c) flash decode in serving: arm (a)'s tree with fused_attention=True,
    # 32 requests, slots at ragged lengths.
    engine = serve_engine(model, qparams, fused=True)
    reqs = [(prompt, dict(max_new_tokens=m)) for prompt, m in load[:32]]
    (handles, sched, seconds), counts = counted(lambda: serve(engine, reqs, 16, 4))
    label = "(c) W4 body + W8 head with flash decode, chunk 16, pipeline 4"
    check_served(label, handles, V)
    steps = sched.stats["rounds"] * 16
    check(counts["flash_decode"] == cfg.num_layers * steps and counts["w4"] > 0
          and counts["w8"] > 0, f"{label} launched {counts}, expected "
                                f"{cfg.num_layers * steps} flash decode")
    serving_figures(label, handles, sched, seconds, card)
    share, worst, n = teacher_forced(engine, handles[:16])
    print(f"serving {label}: launches {counts}; teacher-forced, 16 requests, {n} served tokens: "
          f"exactly the argmax {share:.4f}, worst margin {worst:.4f} (bar {SERVE_MARGIN})",
          flush=True)
    check(worst <= SERVE_MARGIN, f"serving (c): a served token {worst:.4f} of the largest "
                                 "|logit| below its row's largest in the teacher-forced decode")
    return launches


# -- phase 10: speculative decoding at Gemma-3-1B's width ---------------------------

SPEC_BATCH, SPEC_MAX_SEQ, SPEC_K = 8, 512, 4
SPEC_PROMPT, SPEC_NEW = 128, 32
SPEC_A8_BATCH, SPEC_A8_NEW = 4, 16
SPEC_SERVE_REQUESTS, SPEC_SERVE_ROUNDS = 16, 4
# (b)'s bar: a self-draft proposes target-only's own stream, so a live round
# emits k tokens (k - 1 accepted drafts and the target's own) but where the
# verify's argmax and the step's part at a near tie, and where the budget cuts
# the last round; 0.9 k leaves room for that and nothing else.
SPEC_SELF_EMITTED_MIN = 0.9
# The target's depth: the first 6 of Gemma-3-1B's 26 layers (five
# sliding-window, one global), cut to keep the run inside its time limit: its
# rounds are host-bound, so their time follows depth.
SPEC_TARGET_LAYERS = 6


def build_gemma3_1b():
    """Gemma-3-1B (published widths, the first ``SPEC_TARGET_LAYERS`` layers)
    in bf16 from a seeded init at the port's initializer scale (phase 4's),
    W4 g128 body and int8 per-channel lm_head, fused; returns (model, tree)."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.gemma3 import (
        GEMMA3_1B,
        Gemma3,
        fuse_gemma3_projections,
    )

    model = Gemma3(dataclasses.replace(GEMMA3_1B, dtype="bfloat16",
                                       num_layers=SPEC_TARGET_LAYERS))
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    tree, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128), ignore=["lm_head"]))
    del params
    tree, _ = oqt.quantize(model, tree, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
        ignore=[r"^layers\."]))
    return model, fuse_gemma3_projections(tree)


def spec_engine(model, tree, batch: int = SPEC_BATCH, fused: bool = False):
    from onnx_quantize_tpu_torch.engine import InferenceEngine

    return InferenceEngine(model, tree, max_batch=batch, max_seq=SPEC_MAX_SEQ, kv_quant=True,
                           dtype=torch.bfloat16, fused_attention=fused)


def no_host_sync(fn):
    """``fn()`` with any host sync an error (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def prefilled(engine, prompts):
    """A fresh cache with ``prompts`` prefilled; (cache, first tokens on the
    device, host ids, host lengths)."""
    B = engine.max_batch
    ids = np.zeros((B, max(len(p) for p in prompts)), np.int32)
    lengths = np.ones((B,), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        lengths[i] = len(p)
    cache, _, first = engine.prefill(engine.new_cache(), ids, lengths, with_tokens=True)
    return cache, first, ids, lengths


def verify_step_delta(spec, prompts, stream) -> float:
    """The largest |difference| between the target's verify logits over
    [s_0..s_k] (one (B, k+1) forward) and its one-token steps' logits over the
    same prefix (target-only's own stream ``stream``)."""
    eng, k = spec.target, spec.k
    toks = torch.tensor([s[:k + 1] for s in stream], dtype=torch.int64, device="cuda")
    cache, _, _, _ = prefilled(eng, prompts)
    steps = []
    for j in range(k + 1):
        _, logits = eng.decode(cache, toks[:, j])
        steps.append(logits.float())
    cache, _, _, _ = prefilled(eng, prompts)
    with torch.inference_mode():
        verify = spec._verify(cache, toks, torch.ones((len(prompts),), dtype=torch.bool,
                                                      device="cuda"))
    return max(float((verify[:, j].float() - steps[j]).abs().max()) for j in range(k + 1))


def first_divergences(got: list[list[int]], want: list[list[int]]) -> list[tuple[int, int]]:
    """(row, index) of each row's first token where ``got`` leaves ``want``."""
    out = []
    for row, (g, w) in enumerate(zip(got, want)):
        if g != w:
            out.append((row, next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                                  min(len(g), len(w)))))
    return out


def top2_gaps(engine, prefixes: list[list[int]]) -> list[float]:
    """The gap between the two largest next-token logits after each prefix
    (prefilled in batches of the engine's rows)."""
    gaps = []
    B = engine.max_batch
    for start in range(0, len(prefixes), B):
        chunk = prefixes[start:start + B]
        ids = np.zeros((B, max(len(p) for p in chunk)), np.int32)
        lengths = np.ones((B,), np.int32)
        for i, p in enumerate(chunk):
            ids[i, :len(p)] = p
            lengths[i] = len(p)
        _, logits = engine.prefill(engine.new_cache(), ids, lengths)
        top = logits.float().topk(2, dim=-1).values
        gaps += (top[:, 0] - top[:, 1]).cpu().tolist()[:len(chunk)]
    return gaps


def check_delta_rule(label: str, engine, prompts, got, want, delta: float) -> int:
    """Every row of ``got`` equals ``want`` (the target-only stream), or its
    first differing token lies where ``want``'s two largest logits are within
    ``delta``. Prints each divergence and its gap; returns their count."""
    div = first_divergences(got, want)
    gaps = top2_gaps(engine, [list(prompts[r]) + list(want[r][:j]) for r, j in div])
    for (row, j), gap in zip(div, gaps):
        print(f"spec {label}: row {row} leaves the target-only stream at token {j} "
              f"({got[row][j] if j < len(got[row]) else 'end'} vs "
              f"{want[row][j] if j < len(want[row]) else 'end'}), top-2 gap {gap:.5f}, "
              f"delta {delta:.5f}", flush=True)
        check(gap <= delta, f"spec {label}: row {row} diverges at token {j} where the "
                            f"target-only top-2 gap {gap:.5f} exceeds delta {delta:.5f}")
    return len(div)


def window_write_ms(engine, B: int, T: int) -> tuple[float, float]:
    """CUDA-event times of one verify's K/V writes into the int8 cache (every
    layer, B rows of T at per-row offsets): ``write_kv_window`` against the
    masked ``write_kv`` at the same positions."""
    from onnx_quantize_tpu_torch.engine.kv_cache import write_kv, write_kv_window

    cfg = engine.model.cfg
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cache = engine.new_cache()
    k = torch.randn((B, T, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device="cuda").to(torch.bfloat16)
    start = torch.arange(B, dtype=torch.int32, device="cuda") * 37 + 100
    ok = torch.ones((B,), dtype=torch.bool, device="cuda")
    positions = start[:, None] + torch.arange(T, dtype=torch.int32, device="cuda")[None, :]
    mask = ok[:, None].expand(B, T)

    def window():
        for layer in range(cfg.num_layers):
            write_kv_window(cache, layer, k, v, start, ok)

    def masked():
        for layer in range(cfg.num_layers):
            write_kv(cache, layer, k, v, positions, mask)

    return cuda_time_ms(window, 20), cuda_time_ms(masked, 20)


def spec_rate(spec, prompts, budget: int) -> tuple[float, float, float]:
    """Decode alone, CUDA events around it: ``spec.decode`` over the rounds a
    ``budget``-token stream needs at worst, against the target-only engine's
    ``decode_multi`` of the same tokens from the same prefill. Returns
    (speculative ms per round, its generated tok/s, target-only tok/s)."""
    tgt, dft, k = spec.target, spec.draft, spec.k
    B = len(prompts)
    rounds = -(-budget // k)
    budgets = torch.full((tgt.max_batch,), budget, dtype=torch.int32, device="cuda")
    t_cache, first, ids, lengths = prefilled(tgt, prompts)
    d_cache, _ = dft.prefill(dft.new_cache(), ids, lengths)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _, _, blob = spec.decode(t_cache, d_cache, first, rounds, budgets=budgets)
    end.record()
    torch.cuda.synchronize()
    spec_ms = start.elapsed_time(end)
    emitted = int(blob[:B, :, k].sum())
    t_cache, first, _, _ = prefilled(tgt, prompts)
    torch.cuda.synchronize()
    start.record()
    tgt.decode_multi(t_cache, first, budget)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    return spec_ms / rounds, emitted / spec_ms * 1e3, B * budget / plain_ms * 1e3


def run_speculative(draft_model, draft_tree, card: str) -> dict:
    """Phase 10: speculative decoding with Gemma-3-1B as the target, at
    published widths, depth cut to ``SPEC_TARGET_LAYERS``. Returns the
    launches of its arms."""
    from onnx_quantize_tpu_torch.engine import (
        ContinuousBatchingScheduler,
        SpeculativeDecoder,
        SpeculativeScheduler,
    )
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4a8, matmul_w8a8

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, tree = build_gemma3_1b()
    print(f"phase 10 depth cut: the first {SPEC_TARGET_LAYERS} of Gemma-3-1B's 26 layers",
          flush=True)
    cfg, dcfg, k = model.cfg, draft_model.cfg, SPEC_K
    V = cfg.vocab_size
    check(dcfg.vocab_size == V, "the draft and the target must share a vocabulary")
    launches = {name: 0 for name in kernel_modules()}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernel_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    prompts = np.random.default_rng(SEED + 10).integers(
        1, V, (SPEC_BATCH, SPEC_PROMPT)).tolist()
    target = spec_engine(model, tree)
    want, _ = counted(lambda: target.generate(prompts, max_new_tokens=SPEC_NEW))
    check(all(len(o) == SPEC_NEW and all(0 <= t < V for t in o) for o in want),
          "spec: target-only generate returned a short row or an id out of range")

    # (a) the published pairing: the 270M W4 tree with flash decode drafts.
    draft = spec_engine(draft_model, draft_tree, fused=True)
    spec = SpeculativeDecoder(target, draft, k=k)
    delta = 2 * verify_step_delta(spec, prompts, want)
    print(f"spec: delta = 2 x the largest |verify - step| logit difference over the same "
          f"prefix (B={SPEC_BATCH}, {k + 1} positions) = {delta:.5f}", flush=True)
    t_cache, first, ids, lengths = prefilled(target, prompts)
    d_cache, _ = draft.prefill(draft.new_cache(), ids, lengths)
    budgets = torch.full((SPEC_BATCH,), SPEC_NEW, dtype=torch.int32, device="cuda")
    reset_counts()
    no_host_sync(lambda: spec.decode(t_cache, d_cache, first, 1, budgets=budgets))
    torch.cuda.synchronize()
    one_round = kernel_counts()
    draft_step = {"w4": 4 * dcfg.num_layers, "w8": 1, "flash_decode": dcfg.num_layers}
    verify = {"w4": 4 * cfg.num_layers, "w8": 1}
    round_want = {name: k * draft_step.get(name, 0) + verify.get(name, 0)
                  for name in kernel_modules()}
    check(one_round == round_want,
          f"spec (a): one round launched {one_round}, expected {k} draft steps of "
          f"{draft_step} and a verify of {verify}")
    # A draft step and a verify alone, on the same (now advanced) caches.
    reset_counts()
    draft.decode(d_cache, first)
    torch.cuda.synchronize()
    step_counts = {name: n for name, n in kernel_counts().items() if n}
    reset_counts()
    with torch.inference_mode():
        spec._verify(t_cache, first.long()[:, None].expand(-1, k + 1),
                     torch.ones((SPEC_BATCH,), dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    verify_counts = {name: n for name, n in kernel_counts().items() if n}
    check(step_counts == draft_step and verify_counts == verify,
          f"spec (a): a draft step launched {step_counts} (expected {draft_step}), a verify "
          f"{verify_counts} (expected {verify})")
    print(f"spec (a): one round, under sync debug mode 'error' (no host sync), launched "
          f"{one_round}: {k} draft steps of {step_counts} and a verify of {verify_counts}",
          flush=True)
    got, _ = counted(lambda: spec.generate(prompts, max_new_tokens=SPEC_NEW))
    check(all(len(o) == SPEC_NEW and all(0 <= t < V for t in o) for o in got),
          "spec (a): a row missed its budget or an id is out of range")
    div = check_delta_rule("(a)", target, prompts, got, want, delta)
    stats = spec.stats
    round_ms, rate, plain_rate = spec_rate(spec, prompts, SPEC_NEW - 1)
    win_ms, masked_ms = window_write_ms(target, SPEC_BATCH, k + 1)
    print(f"spec (a) Gemma-3-270M W4 + flash decode drafting for Gemma-3-1B W4, k={k}, "
          f"B={SPEC_BATCH}, prompts {SPEC_PROMPT}, {SPEC_NEW} new tokens on {card}: rounds "
          f"{stats['rounds']}, mean emitted per live round "
          f"{stats['emitted'] / stats['live_rounds']:.3f}, rows leaving the target-only "
          f"stream {div} of {SPEC_BATCH}; decode alone (CUDA events) {round_ms:.2f} ms a round, "
          f"generated tok/s {rate:.1f}, target-only decode tok/s {plain_rate:.1f} (ratio "
          f"{rate / plain_rate:.3f}); one verify's K/V writes ({cfg.num_layers} layers, "
          f"B={SPEC_BATCH}, T={k + 1}): write_kv_window {win_ms:.4f} ms, masked write_kv "
          f"{masked_ms:.4f} ms", flush=True)
    del spec, draft, t_cache, d_cache

    # (b) self-draft: two engines over the 1B W4 tree.
    self_draft = spec_engine(model, tree)
    spec = SpeculativeDecoder(target, self_draft, k=k)
    got, _ = counted(lambda: spec.generate(prompts, max_new_tokens=SPEC_NEW))
    div = check_delta_rule("(b)", target, prompts, got, want, delta)
    stats = spec.stats
    mean = stats["emitted"] / stats["live_rounds"]
    round_ms, rate, plain_rate = spec_rate(spec, prompts, SPEC_NEW - 1)
    print(f"spec (b) Gemma-3-1B W4 drafting for itself, k={k}, B={SPEC_BATCH} on {card}: "
          f"rounds {stats['rounds']}, mean emitted per live round {mean:.3f} (bar "
          f"{SPEC_SELF_EMITTED_MIN * k:.1f}), rows leaving the target-only stream {div}; "
          f"decode alone {round_ms:.2f} ms a round, generated tok/s {rate:.1f}, target-only "
          f"{plain_rate:.1f} (ratio {rate / plain_rate:.3f})", flush=True)
    check(mean >= SPEC_SELF_EMITTED_MIN * k,
          f"spec (b): a self-draft emitted {mean:.3f} a live round, under "
          f"{SPEC_SELF_EMITTED_MIN} x k: the verify and the step disagree beyond ties")

    # (c) the A8 trees: W4A8 bodies and W8A8 heads, against the plain versions.
    a8_prompts = prompts[:SPEC_A8_BATCH]
    spec_a8 = SpeculativeDecoder(spec_engine(model, convert_to_w4a8(tree), SPEC_A8_BATCH),
                                 spec_engine(draft_model, convert_to_w4a8(draft_tree),
                                             SPEC_A8_BATCH), k=k)

    def a8_run():
        greedy = spec_a8.generate(a8_prompts, max_new_tokens=SPEC_A8_NEW)
        t_cache, first, ids, lengths = prefilled(spec_a8.target, a8_prompts)
        d_cache, _ = spec_a8.draft.prefill(spec_a8.draft.new_cache(), ids, lengths)
        budgets = torch.full((SPEC_A8_BATCH,), 12, dtype=torch.int32, device="cuda")
        _, _, blob = no_host_sync(lambda: spec_a8.decode(t_cache, d_cache, first, 3,
                                                         budgets=budgets))
        sampled = [spec_a8.generate(a8_prompts, max_new_tokens=SPEC_A8_NEW, temperature=0.8,
                                    generator=torch.Generator(device="cuda").manual_seed(SEED))
                   for _ in range(2)]
        return greedy, blob.cpu(), sampled

    (greedy, blob, sampled), a8_counts = counted(a8_run)
    check(a8_counts["w4a8"] > 0 and a8_counts["w8a8"] > 0
          and sum(a8_counts.values()) == a8_counts["w4a8"] + a8_counts["w8a8"],
          f"spec (c): the A8 arm launched {a8_counts}, expected W4A8 and W8A8 and no other")
    check(sampled[0] == sampled[1], "spec (c): two sampled runs from one seed differ")
    reset_counts()
    with plain_kernels([matmul_w4a8, matmul_w8a8]):
        p_greedy, p_blob, p_sampled = a8_run()
    torch.cuda.synchronize()
    check(kernel_counts()["w4a8"] == 0 and kernel_counts()["w8a8"] == 0,
          "spec (c): the plain run launched an A8 kernel")
    check(greedy == p_greedy and torch.equal(blob, p_blob) and sampled == p_sampled,
          "spec (c): the A8 kernels' streams or blob differ from the plain versions'")
    print(f"spec (c) W4A8/W8A8 target and draft, k={k}, B={SPEC_A8_BATCH}, {SPEC_A8_NEW} new "
          f"tokens: greedy and sampled (temperature 0.8) streams and a 3-round blob equal to "
          f"the plain versions'; two sampled runs from one seed equal; launches "
          f"{a8_counts}", flush=True)
    del spec_a8

    # (d) the speculative scheduler with (b)'s pair over phase 9's load.
    load = serving_load(V)[:SPEC_SERVE_REQUESTS]
    sched = SpeculativeScheduler(spec, rounds=SPEC_SERVE_ROUNDS,
                                 generator=torch.Generator(device="cuda").manual_seed(SEED))

    def serve_spec():
        handles = [sched.submit(p, max_new_tokens=m) for p, m in load]
        sched.run()
        return handles

    (handles, seconds), _ = counted(lambda: timed(serve_spec))
    check(all(r.done for r in handles), "spec (d): a request did not finish")
    for r in handles:
        check(all(0 <= t < V for t in r.output), "spec (d): an id out of range")
        room = len(r.prompt) + len(r.output) + k + 1 > SPEC_MAX_SEQ
        check(len(r.output) == r.max_new_tokens or room,
              f"spec (d): request {r.request_id} emitted {len(r.output)} of {r.max_new_tokens}")
    st = sched.stats
    check(st["emitted"] == sum(len(r.output) - 1 for r in handles)
          and st["live_rounds"] <= st["emitted"] <= k * st["live_rounds"],
          f"spec (d): stats {st} disagree with the outputs")
    cb = ContinuousBatchingScheduler(target, chunk=16)
    cb.narrow_admit = False  # masked admission, as the speculative scheduler's

    def serve_cb():
        cb_handles = [cb.submit(p, max_new_tokens=m) for p, m in load]
        cb.run()
        return cb_handles

    cb_handles, cb_seconds = timed(serve_cb)
    div = check_delta_rule("(d)", target, [r.prompt for r in cb_handles],
                           [r.output for r in handles], [r.output for r in cb_handles], delta)
    generated = sum(len(r.output) for r in handles)
    cb_generated = sum(len(r.output) for r in cb_handles)
    print(f"spec (d) SpeculativeScheduler, (b)'s pair, rounds {SPEC_SERVE_ROUNDS}, k={k}, "
          f"B={SPEC_BATCH}, {SPEC_SERVE_REQUESTS} requests on {card}: {seconds:.2f} s, generated "
          f"tok/s {generated / seconds:.1f}, stats {st} (mean emitted per live round "
          f"{st['emitted'] / st['live_rounds']:.3f}); ContinuousBatchingScheduler over the "
          f"target alone (chunk 16, masked admission) {cb_seconds:.2f} s, generated tok/s "
          f"{cb_generated / cb_seconds:.1f}; requests leaving its stream {div}", flush=True)
    print(f"phase 10 speculative decoding on {card}: {time.perf_counter() - t_phase:.1f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


# -- phase 11: model families and ways in --------------------------------------------

def family_kernel_checks(gen) -> None:
    """Phase 3's cases at this phase's new shapes: W4 (g128) and W8 (uint8
    per channel) at BERT-base's two-class classifier (K=768, N=2) over 512
    [CLS] rows, and Q8 with an int32 bias and W8 (int8 per channel) at GPT-2
    small's Gemm sites (768->768, 768->3072, 3072->768) over a forward's 8192
    rows, all with float32 x (both models are float32), against their plain
    versions, each timed beside its bound (and Q8 beside ``torch._int_mm`` on
    its int32 core)."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_q8

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("bert_classifier", "w4", 768, 2, "uint4", 128, False, 512),
             ("bert_classifier", "w8", 768, 2, "uint8", -1, False, 512),
             *(("gpt2_" + site, "w8", K, N, "int8", -1, True, 8192)
               for site, K, N in (("attn", 768, 768), ("fc_in", 768, 3072),
                                  ("fc_out", 3072, 768)))]
    for name, kernel, K, N, dtype, gs, sym, M in cases:
        qt = random_qtensor(K, N, dtype, gs, sym, gen)
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
            wrapper, plain, ops, kw = kernel_operands(kernel, qt, x)
            y, again, ref = wrapper(*ops, **kw), wrapper(*ops, **kw), plain(*ops, **kw)
            torch.cuda.synchronize()
            err, scale = (y - ref).abs().max().item(), ref.abs().max().item()
            check(bool(torch.isfinite(y).all()), f"{name} {kernel} {xdt}: non-finite output")
            check(err <= REL_TOL * scale, f"{name} {kernel} M={M} {xdt}: max abs err "
                                          f"{err:.3e} > {REL_TOL} * {scale:.3e}")
            check(torch.equal(again, y), f"{name} {kernel} {xdt}: two launches differ")
            plan = kernel_plan(kernel, M, ops[0].shape[1], N, kw, xdt, sms)
            line = (f"kernel {kernel} {name} M={M} K={K} N={N} x={str(xdt)[6:]}: "
                    f"max_abs_err={err:.3e} plan={plan.route} {plan.bm}x{plan.bn} "
                    f"splits={getattr(plan, 'splits', 1)} blocks={plan.blocks}")
            if xdt == torch.float32:
                ms = cuda_time_ms(lambda: wrapper(*ops, **kw), 20)
                plain_ms = cuda_time_ms(lambda: plain(*ops, **kw), 20)
                b_ms, b_by = bound(nbytes(*ops, y), 2 * M * K * N, "float32")
                line += (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
                         f"({b_by})")
            print(line, flush=True)
    for site, K, N in (("attn", 768, 768), ("fc_in", 768, 3072), ("fc_out", 3072, 768)):
        qt, bias = q8_site(K, N, "int8", True, "channel", gen, with_bias=True)
        M = 8192
        x = torch.randn((M, K), generator=gen, device="cuda")
        ops = matmul_q8.q8_operands(x, qt, bias)
        y, again = matmul_q8.q8_matmul(*ops), matmul_q8.q8_matmul(*ops)
        ref = matmul_q8.q8_matmul_plain(*ops)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"q8 gpt2_{site} with bias: non-finite output")
        check(torch.equal(y, ref) and torch.equal(again, y),
              f"q8 gpt2_{site} with bias: not bit-equal to its plain version twice")
        plan = matmul_q8.q8_plan(M, K, N, sms)
        ms = cuda_time_ms(lambda: matmul_q8.q8_matmul(*ops), 20)
        plain_ms = cuda_time_ms(lambda: matmul_q8.q8_matmul_plain(*ops), 20)
        c = ops[3]
        x_q = (torch.clamp(torch.round(x / c.fparams[0]).to(torch.int32) + c.iparams[0], *c.iq)
               - c.x_shift).to(torch.int8)
        lib_ms = cuda_time_ms(lambda: torch._int_mm(x_q, qt.data), 20)
        b_ms, b_by = bound(nbytes(x, qt.data, ops[2], c.wsum, c.wzp, c.req, y), 2 * M * K * N,
                           "int8")
        print(f"kernel q8 gpt2_{site} with int32 bias M={M} K={K} N={N} x=float32: "
              f"max_abs_err=0 (bit-equal twice) plan={plan.route} {plan.bm}x{plan.bn} "
              f"splits={plan.splits} blocks={plan.blocks} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} int_mm_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
              flush=True)


def write_hf_gemma3(tree: dict, cfg, directory: Path, shards: int = 2) -> int:
    """A Gemma-3 param tree as a Hugging Face ``Gemma3ForCausalLM`` checkpoint:
    BF16 safetensors shards under HF's names, projections in HF's (out, in)
    layout, the tied lm_head left out. Returns the bytes written."""
    tensors = {"model.embed_tokens.weight": tree["embed"]["w"],
               "model.norm.weight": tree["final_norm"]["w"]}
    norms = {"input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "pre_ffn_norm": "pre_feedforward_layernorm",
             "post_ffn_norm": "post_feedforward_layernorm"}
    for i in range(cfg.num_layers):
        layer, p = tree[f"layers.{i}"], f"model.layers.{i}"
        for sub, group in (("attn", "self_attn"), ("mlp", "mlp")):
            for key, leaf in layer[sub].items():
                w = leaf["w"]
                tensors[f"{p}.{group}.{key}.weight"] = w.t() if w.ndim == 2 else w
        for key, hf_name in norms.items():
            tensors[f"{p}.{hf_name}.weight"] = layer[key]["w"]
    names = list(tensors)
    per = -(-len(names) // shards)
    written = 0
    for s in range(shards):
        header, blobs, offset = {}, [], 0
        for name in names[s * per:(s + 1) * per]:
            t = tensors[name].to(torch.bfloat16).contiguous().cpu()
            raw = t.view(torch.uint8).numpy().tobytes()
            header[name] = {"dtype": "BF16", "shape": list(t.shape),
                            "data_offsets": [offset, offset + len(raw)]}
            blobs.append(raw)
            offset += len(raw)
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        path = directory / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(blob)) + blob + b"".join(blobs))
        written += path.stat().st_size
    return written


def leaves_equal(a, b, path="") -> list[str]:
    """Paths where two param trees differ (tensors, QTensor fields), bit for bit."""
    from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor

    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [p for k in a for p in leaves_equal(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (QTensor, QBias)):
        fields = ("data", "scale", "zero_point")
        return [f"{path}.{f}" for f in fields
                if not torch.equal(getattr(a, f), getattr(b, f))]
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    ok = (a.dtype == b.dtype and a.shape == b.shape
          and torch.equal(a.view(bits.get(a.dtype, a.dtype)), b.view(bits.get(b.dtype, b.dtype))))
    return [] if ok else [path]


def cli_perplexity(args: list[str]) -> tuple[float, float]:
    """``python -m onnx_quantize_tpu_torch.tools.perplexity ARGS`` run as a
    user runs it, from the checkout; (the printed perplexity, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "onnx_quantize_tpu_torch.tools.perplexity",
                          *args], cwd=REPO, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"perplexity command line {args} exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    match = re.search(r"^perplexity: (\S+)$", out.stdout, re.M)
    check(match is not None, f"perplexity command line printed no result: {out.stdout[-500:]}")
    return float(match.group(1)), secs


def counted_run(fn):
    """(fn's result, the launches it made, seconds), counters reset first."""
    reset_counts()
    out, secs = timed(fn)
    return out, {k: v for k, v in kernel_counts().items() if v}, secs


def run_hf_import_and_cli(model, qparams, card: str) -> dict:
    """Phase 11 (a): phase 4's float Gemma-3-270M (the same seed) written as a
    two-shard BF16 HF checkpoint, read back, quantized and served as phase 4;
    then the perplexity command line on it and on the W4 tree's checkpoint."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.checkpoint import save_checkpoint
    from onnx_quantize_tpu_torch.engine import InferenceEngine
    from onnx_quantize_tpu_torch.models.gemma3 import GEMMA3_270M, Gemma3, fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf
    from onnx_quantize_tpu_torch.tools import perplexity_from_tokens

    cfg = model.cfg
    launches: dict = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "hf").mkdir()
        written, write_s = timed(lambda: write_hf_gemma3(params, cfg, tmp / "hf"))
        loaded, load_s = timed(lambda: load_gemma3_hf(model, str(tmp / "hf"),
                                                      dtype=torch.bfloat16, device="cuda"))
        bad = leaves_equal(params, loaded)
        check(not bad, f"HF round trip: leaves differ from the tree written: {bad[:5]}")
        check(loaded["lm_head"]["w"].data_ptr() == loaded["embed"]["w"].data_ptr(),
              "HF round trip: the lm_head is not tied to the embedding")
        print(f"HF import (Gemma-3-270M, 2 BF16 shards, {written / 2**20:.1f} MiB) on {card}: "
              f"write {write_s:.2f} s, load_gemma3_hf to the card {load_s:.2f} s "
              f"({written / load_s / 2**30:.2f} GiB/s); every leaf bit-equal to the tree "
              "written", flush=True)
        del params
        body = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
                           ignore=["lm_head"])
        head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                           ignore=[r"^layers\."])
        tree = fuse_gemma3_projections(oqt.quantize(model, oqt.quantize(
            model, loaded, body)[0], head)[0])
        del loaded
        bad = leaves_equal(tree, qparams)
        check(not bad, f"the imported checkpoint's W4 tree differs from phase 4's: {bad[:5]}")

        B, T, steps = 32, 128, 16
        ids = np.random.default_rng(SEED).integers(1, cfg.vocab_size, size=(B, T)).astype(
            np.int32)
        lengths = np.full((B,), T, np.int32)

        def serve(t):
            engine = InferenceEngine(model, t, max_batch=B, max_seq=512, kv_quant=True,
                                     dtype=torch.bfloat16)
            cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
            return engine.decode_multi(cache, torch.argmax(logits, dim=-1), steps=steps)[1]

        stream, counts, _ = counted_run(lambda: serve(tree))
        want = {"w4": 4 * cfg.num_layers * (1 + steps), "w8": 1 + steps}
        check(counts == want, f"the imported W4 tree served with launches {counts}, expected "
                              f"{want}")
        add(counts)
        want_stream, counts, _ = counted_run(lambda: serve(qparams))
        check(counts == want, f"phase 4's W4 tree served with launches {counts}, expected "
                              f"{want}")
        add(counts)
        check(torch.equal(stream, want_stream),
              "the imported W4 tree's greedy stream differs from phase 4's")
        print(f"HF import served (W4 g128 body, int8 head, fused; B={B}, prompt {T}, {steps} "
              f"greedy steps) on {card}: stream equal to phase 4's tree; launches {counts}",
              flush=True)
        del tree

        n_tokens, max_length, stride = 4096, 2048, 512
        windows = 1 + (n_tokens - max_length) // stride
        tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, n_tokens)
        np.save(tmp / "tokens.npy", tokens)
        # --hf-weights: the float32 Gemma-3-270M (JAX's default dtype).
        ppl_cli, cli_s = cli_perplexity(["--hf-weights", str(tmp / "hf"), "--tokens",
                                         str(tmp / "tokens.npy")])
        model32 = Gemma3(GEMMA3_270M)
        params32, load32_s = timed(lambda: load_gemma3_hf(model32, str(tmp / "hf"),
                                                          device="cuda"))
        ppl, counts, secs = counted_run(lambda: perplexity_from_tokens(
            model32, params32, tokens, max_length, stride))
        routes = dict(kernel_modules()["flash_attention"].route_launches)
        check(counts == {"flash_attention": cfg.num_layers * windows} and routes["mma"] == 0,
              f"float32 window scoring launched {counts} on the routes {routes}, expected "
              "flash attention in every layer on the CUDA cores")
        add(counts)
        check(abs(ppl_cli - ppl) <= 1e-4 * ppl, f"--hf-weights perplexity {ppl_cli} differs "
                                                f"from the in-process {ppl}")
        print(f"perplexity --hf-weights (float32 Gemma-3-270M, {n_tokens} seeded tokens, "
              f"{windows} windows of {max_length} at stride {stride}) on {card}: command line "
              f"{ppl_cli:.4f} ({cli_s:.1f} s with the interpreter's start and the load), in "
              f"process {ppl:.4f} (float32 load {load32_s:.2f} s, {1e3 * secs / windows:.1f} "
              f"ms a window); launches {counts}, flash attention routes {routes}", flush=True)
        del params32, model32
        # --checkpoint: phase 4's W4 tree through save_checkpoint.
        save_checkpoint(str(tmp / "ckpt"), model, qparams)
        ppl_cli, cli_s = cli_perplexity(["--checkpoint", str(tmp / "ckpt"), "--tokens",
                                         str(tmp / "tokens.npy")])
        ppl, counts, secs = counted_run(lambda: perplexity_from_tokens(
            model, qparams, tokens, max_length, stride))
        routes = dict(kernel_modules()["flash_attention"].route_launches)
        want = {"w4": 4 * cfg.num_layers * windows, "w8": windows,
                "flash_attention": cfg.num_layers * windows}
        check(counts == want and routes["simt"] == 0,
              f"W4 window scoring launched {counts} on the routes {routes}, expected {want} "
              "with flash attention on the tensor cores")
        add(counts)
        check(abs(ppl_cli - ppl) <= 1e-4 * ppl, f"--checkpoint perplexity {ppl_cli} differs "
                                                f"from the in-process {ppl}")
        print(f"perplexity --checkpoint (phase 4's bf16 W4 tree) on {card}: command line "
              f"{ppl_cli:.4f} ({cli_s:.1f} s), in process {ppl:.4f} "
              f"({1e3 * secs / windows:.1f} ms a window); launches {counts}, flash attention "
              f"routes {routes}", flush=True)
    return launches


def w4_site_routes(model, tree, x_dtype, rows) -> dict:
    """Route -> the tree's W4 sites that take it, at ``rows(site name)`` rows
    of ``x_dtype`` (W4 counts no routes itself; its plan names the route)."""
    from onnx_quantize_tpu_torch.nn.qtensor import QTensor
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4
    from onnx_quantize_tpu_torch.utils import tree_get

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes: dict = {}
    for site in model.linear_sites():
        w = tree_get(tree, site.param_path)["w"]
        if isinstance(w, QTensor) and w.meta.packed:
            plan = matmul_w4.w4_plan(rows(site.name), 2 * w.data.shape[0], w.meta.shape[1],
                                     w.meta.pack_group, x_dtype, sms)
            routes.setdefault(plan.route, []).append(site.name)
    return {route: (len(names) if len(names) > 2 else names) for route, names in routes.items()}


@contextlib.contextmanager
def w8_plain_float64():
    """W8's plain version with its dots and sums in float64, rounded to
    float32 once at the end: another summation order than the plain
    version's, the last-bit control of the activation-QDQ arms (reference
    runs only)."""
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w8

    def plain64(x2d, data, scale_rows, zp_rows, *, bk):
        M, K = x2d.shape
        n_k, N = K // bk, data.shape[1]
        xt = x2d.double().reshape(M, n_k, bk).transpose(0, 1)
        dots = torch.bmm(xt, data.double().reshape(n_k, bk, N))
        if zp_rows is not None:
            dots = dots - xt.sum(dim=-1, keepdim=True) * zp_rows.double().reshape(n_k, 1, N)
        return (dots * scale_rows.double().reshape(n_k, 1, N)).sum(dim=0).float()

    saved = matmul_w8.w8_matmul
    matmul_w8.w8_matmul = plain64
    try:
        yield
    finally:
        matmul_w8.w8_matmul = saved


def check_sites_on_plain_inputs(label: str, model, tree, chunks: list) -> tuple[int, str]:
    """Every W8 site of ``tree`` on the plain run's own site inputs, one plain
    forward for each input tuple of ``chunks``. Before the output QDQ, every
    element of the kernel's product is within float32's rounding bound for
    a dot of K products in any order, (K + 2) u (|x| @ |w|) (u = 2^-24), of
    the product summed in float64; after it, every element is within
    ``REL_TOL`` of the largest output of the plain version's, or one output
    step off where the two float32 products straddle a rounding boundary.
    The share of such elements depends on the summation order, so it is
    reported beside the same share of the float64 product. Returns (sites,
    that report)."""
    from onnx_quantize_tpu_torch.nn.module import Context
    from onnx_quantize_tpu_torch.nn.qtensor import QTensor
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w8
    from onnx_quantize_tpu_torch.ops.reference import (
        dequantize_weight,
        qdq_epilogue,
        qdq_prologue,
    )
    from onnx_quantize_tpu_torch.utils import tree_get

    sites = [(site, tree_get(tree, site.param_path)) for site in model.linear_sites()]
    sites = [(site, node) for site, node in sites if isinstance(node["w"], QTensor)]
    # site name -> [elements off a step (kernel), off (float64), elements,
    #               the largest error over its bound, sum |kernel - float64|,
    #               sum |plain - float64|]
    tally = {site.name: [0, 0, 0, 0.0, 0.0, 0.0] for site, _ in sites}
    for inputs in chunks:
        ctx = Context(taps={}, tap_inputs=True)
        with torch.inference_mode(), plain_kernels():
            model(tree, *inputs, ctx=ctx)
        for site, node in sites:
            w, b = node["w"], node.get("b")
            with torch.inference_mode():
                x = qdq_prologue(ctx.taps[site.name]["input"], w)
                y = matmul_w8.w8_dequant_matmul(x, w)
                with plain_kernels():
                    y_plain = matmul_w8.w8_dequant_matmul(x, w)
                    with w8_plain_float64():
                        y_exact = matmul_w8.w8_dequant_matmul(x, w)
                bound = (x.shape[-1] + 2) * 2.0 ** -24 * (x.abs() @ dequantize_weight(w).abs())
                out, ref, out_exact = (qdq_epilogue(t, w, b) for t in (y, y_plain, y_exact))
            over = ((y - y_exact).abs() / bound.clamp(min=torch.finfo(torch.float32).tiny)
                    ).max().item()
            check(over <= 1.0, f"{label} site {site.name}: the kernel's product beyond float32's "
                               f"rounding bound of the float64 one ({over:.2f} of it)")
            peak = ref.abs().max().item()
            # One output step: the static scale, or a dynamic one from the range.
            out_spec, step = w.meta.output_quant, 0.0
            if out_spec.mode == "static":
                step = float(w.output_scale)
            elif out_spec.mode == "dynamic":
                step = (ref.max() - torch.clamp(ref.min(), max=0.0)).item() / 255
            err = (out - ref).abs()
            check(err.max().item() <= REL_TOL * peak + 1.01 * step,
                  f"{label} site {site.name}: kernel vs plain on the plain run's inputs: max "
                  f"{err.max().item():.3e} beyond one output step ({step:.3e}; peak {peak:.3e})")
            counts = tally[site.name]
            counts[0] += int((err > REL_TOL * peak).sum())
            counts[1] += int(((out_exact - ref).abs() > REL_TOL * peak).sum())
            counts[2] += err.numel()
            counts[3] = max(counts[3], over)
            counts[4] += (y - y_exact).abs().sum().item()
            counts[5] += (y_plain - y_exact).abs().sum().item()
        del ctx
    off, off_exact, n, _, e_kernel, e_plain = (sum(c[k] for c in tally.values())
                                               for k in range(6))
    worst = max(tally, key=lambda k: tally[k][0] / tally[k][2])
    w_off, w_exact, w_n, _, w_kernel, w_plain = tally[worst]
    return len(sites), (f"the largest error {max(c[3] for c in tally.values()):.4f} of its "
                        f"bound; mean |product - float64| kernel {e_kernel / n:.3e}, plain "
                        f"{e_plain / n:.3e}; {off / n:.2e} of the elements one output step off "
                        f"plain at a tie, the float64 product {off_exact / n:.2e}; the most on "
                        f"{worst}: {w_off / w_n:.2e}, the float64 product {w_exact / w_n:.2e}, "
                        f"mean |product - float64| kernel {w_kernel / w_n:.3e}, plain "
                        f"{w_plain / w_n:.3e}")


def compare_family_arm(label: str, model, tree, inputs: tuple, sites: dict, exact: bool,
                       card: str, min_agree: float, act_qdq: bool = False,
                       site_chunks: list | None = None,
                       two_class: bool = False) -> tuple[dict, torch.Tensor]:
    """``model(tree, *inputs)`` through the kernels (twice: the second timed)
    against the same with every kernel plain, launching exactly ``sites`` a
    forward. Weight-only and Q8 arms: equal when ``exact``, else within
    ``FAMILY_LOGIT_TOL`` of the largest |logit|, the decisions equal on at
    least ``min_agree`` of the rows. The decision is the argmax, or for a
    ``two_class`` classifier the margin against the plain run's median
    margin, so that half the rows sit on each side of it and a flip can
    show. An arm with activation QDQ on W8 (``act_qdq``) turns a last-bit
    difference into 8-bit code flips that compound through the layers, so
    it is held site by site on the plain run's own inputs (every row of
    ``inputs``, a forward for each of ``site_chunks``) and, as a whole, to a
    last-bit control (the plain run with W8's sums in float64): mean
    |difference| at most twice the control's, decisions equal at most 0.01
    (or three standard deviations of the shares' difference) less often
    than the control's. Returns (the launches of both kernel forwards, as
    counted, and the logits)."""
    with torch.inference_mode():
        logits, counts, _ = counted_run(lambda: model(tree, *inputs))
        _, again, secs = counted_run(lambda: model(tree, *inputs))
        routes = {k: dict(kernel_modules()[k].route_launches) for k in ("w8",) if k in counts}
        check(counts == sites and again == sites,
              f"{label}: the forwards launched {counts} and {again}, expected {sites}")
        with plain_kernels():
            plain, plain_counts, plain_secs = counted_run(lambda: model(tree, *inputs))
        check(not plain_counts, f"{label}: the plain run launched {plain_counts}")
    launches = {k: counts[k] + again[k] for k in counts}
    check(bool(torch.isfinite(logits).all()), f"{label}: logits not finite")
    diff = (logits - plain).abs()
    peak = plain.abs().max().item()
    if two_class:
        margin = plain[:, 1] - plain[:, 0]
        threshold = margin.median()

        def decide(t):
            return (t[:, 1] - t[:, 0]) > threshold

        near = ((margin - threshold).abs() <= diff.max()).float().mean().item()
        spread = (f"; decision at the plain run's median margin {threshold.item():.4e} (margin "
                  f"std {margin.std().item():.4e}, {near:.4f} of the rows within the largest "
                  "difference of it)")
    else:
        def decide(t):
            return t.argmax(-1)
        spread = ""
    agree = (decide(logits) == decide(plain)).float().mean().item()
    line = (f"{label} on {card}: {1e3 * secs:.1f} ms a forward (plain versions "
            f"{1e3 * plain_secs:.1f}); launches a forward {counts}, routes {routes}; logits vs "
            f"plain max_abs_diff={diff.max().item():.4e} mean_abs_diff={diff.mean().item():.4e} "
            f"max|logit|={peak:.4e}{spread}; decisions equal {agree:.5f}")
    if not act_qdq:
        tol = 0.0 if exact else FAMILY_LOGIT_TOL * peak
        print(f"{line}; tol {tol:.4e}", flush=True)
        check(diff.max().item() <= tol, f"{label}: logits through the kernels disagree with "
                                        "plain")
        check(agree >= min_agree, f"{label}: decisions equal on {agree:.5f} of the rows")
        return launches, logits
    n_sites, ties = check_sites_on_plain_inputs(label, model, tree, site_chunks)
    rows = sum(chunk[0].shape[0] for chunk in site_chunks)
    with torch.inference_mode(), plain_kernels(), w8_plain_float64():
        control = model(tree, *inputs)
    c_diff = (control - plain).abs()
    c_agree = (decide(control) == decide(plain)).float().mean().item()
    print(f"{line}; every one of {n_sites} sites within float32's rounding bound before the "
          f"output QDQ and within {REL_TOL} of plain or one output step after it, on the plain "
          f"run's inputs, all {rows} rows in {len(site_chunks)} forwards ({ties}); "
          f"last-bit control (W8 plain summed in float64) vs plain: max_abs_diff="
          f"{c_diff.max().item():.4e} mean_abs_diff={c_diff.mean().item():.4e} decisions "
          f"equal {c_agree:.5f}", flush=True)
    check(diff.mean().item() <= 2 * c_diff.mean().item() + FAMILY_LOGIT_TOL * 1e-3 * peak,
          f"{label}: kernel vs plain mean difference beyond twice the last-bit control's")
    # Flips are counted on few rows (BERT's 512): three standard deviations of
    # the difference of the two shares, at least 0.01.
    slack = max(0.01, 3 * math.sqrt((2 - agree - c_agree) / decide(plain).numel()))
    check(agree >= c_agree - slack, f"{label}: decisions equal on {agree:.5f}, below the "
                                    f"last-bit control's {c_agree:.5f} by more than {slack:.4f}")
    return launches, logits


# W4 and W8 against their plain versions differ by float32 summation order.
# Weight-only, the logits move by rounding only: 1e-3 of the largest |logit|
# bounds that. Q8 is bit-equal site by site and the float ops between sites
# are the same in both runs, so its arms must be equal.
FAMILY_LOGIT_TOL = 1e-3
# GPT-2's and BERT's initializer_range (their config.json): the projections
# are drawn at this std (the port's Linear init, 0.1, scaled); at 0.1 the
# quantized GPT-2 moves its logits by 21-47% of their mean from the float
# model's.
FAMILY_INIT_STD = 0.02


def family_params(model) -> dict:
    """The model's seeded init (seed 0) with every Linear weight scaled from
    the Linear init's 0.1 to ``FAMILY_INIT_STD`` (the embeddings' 0.02 is
    already the published initializer_range)."""
    from onnx_quantize_tpu_torch.utils import tree_get

    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    for site in model.linear_sites():
        node = tree_get(params, site.param_path)
        node["w"] = node["w"] * (FAMILY_INIT_STD / 0.1)
    return params


# GPT-2 small (openai-community/gpt2 config.json: n_embd 768, n_layer 12,
# n_head 12, n_inner null = 4 x 768, n_positions 1024, vocab_size 50257,
# layer_norm_epsilon 1e-5, gelu_new = the tanh GELU).
GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, intermediate_size=3072, num_layers=12,
                  num_heads=12, max_seq=1024, layer_norm_eps=1e-5)
# BERT-base (google-bert/bert-base-uncased config.json: hidden 768, 12
# layers, 12 heads, intermediate 3072, vocab 30522, layer_norm_eps 1e-12) at
# GLUE's usual max_seq_length 128, two classes.
BERT_BASE = dict(vocab_size=30522, hidden_size=768, intermediate_size=3072, num_layers=12,
                 num_heads=12, max_seq=128, num_classes=2, layer_norm_eps=1e-12)


def run_gpt2(card: str) -> dict:
    """Phase 11 (b): TransformerLM at GPT-2 small's widths, BASELINE config 2
    (W8 behind dynamic uint8 inputs) and config 3 (static uint8 in and out,
    percentile 0.995), the latter as the JAX test's QDQ tree (W8 behind the
    static QDQ) and as QLINEAR (Q8 with QBias), over (8, 1024) ids."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from onnx_quantize_tpu_torch.utils import tree_map

    cfg = TransformerConfig(**GPT2_SMALL)
    model = TransformerLM(cfg)
    params = family_params(model)
    leaves: list = []
    tree_map(leaves.append, params)
    n_params = sum(leaf.numel() for leaf in leaves)
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (8, 1024)).astype(np.int32)
    x = torch.from_numpy(ids).to("cuda")
    static = oqt.QActivationArgs(dtype="uint8")
    config3 = dict(weights=oqt.QWeightArgs(dtype="int8", group_size=-1),
                   input_activations=static, output_activations=static,
                   calibration_params=oqt.CalibrationParams(method="percentile",
                                                            percentile=0.995, num_samples=8,
                                                            batch_size=4),
                   calibration_data=ids, ignore=["lm_head"])
    # (label, kernel, Q8 (exact), activation QDQ on W8, QConfig)
    arms = [("config 2 (W8, dynamic uint8 inputs)", "w8", False, True, oqt.QConfig(
                weights=oqt.QWeightArgs(dtype="int8", group_size=-1),
                input_activations=oqt.QActivationArgs(dtype="uint8", is_static=False),
                ignore=["lm_head"])),
            ("config 3 QDQ (W8, static uint8 in and out)", "w8", False, True,
             oqt.QConfig(**config3)),
            ("config 3 QLINEAR (Q8 with QBias)", "q8", True, False,
             oqt.QConfig(format="qlinear", **config3))]
    launches: dict = {}
    with torch.inference_mode():
        fp, _, fp_secs = counted_run(lambda: model(params, x))
    print(f"GPT-2 small TransformerLM (seeded, {n_params / 1e6:.1f} M float32 parameters, "
          f"(8, 1024) ids) on {card}: float forward {1e3 * fp_secs:.1f} ms", flush=True)
    for label, kernel, exact, act_qdq, qconfig in arms:
        (tree, plan), q_s = timed(lambda: oqt.quantize(model, params, qconfig))
        check(len(plan) == 6 * cfg.num_layers, f"GPT-2 {label}: {len(plan)} sites quantized")
        counts, logits = compare_family_arm(
            f"GPT-2 small {label}, quantized in {q_s:.2f} s", model, tree, (x,),
            {kernel: 6 * cfg.num_layers}, exact, card, 0.999, act_qdq,
            [(x[i:i + 2],) for i in range(0, x.shape[0], 2)])
        rel = ((logits - fp).abs().mean() / fp.abs().mean()).item()
        print(f"GPT-2 small {label}: mean |logits - float| / mean |float| = {rel:.4f} (the "
              "JAX test's bar is 0.1, not gated on random weights)", flush=True)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        del tree, logits
    return launches


def run_bert(card: str) -> dict:
    """Phase 11 (c): BertClassifier at BERT-base's widths over 512 sentences
    of synthetic SST-2, four configurations of the JAX grid (and the QLINEAR
    form of its static symmetric one), each against the plain versions."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.models.bert import (
        BertClassifier,
        BertConfig,
        accuracy,
        synthetic_sst2,
    )

    cfg = BertConfig(**BERT_BASE)
    model = BertClassifier(cfg)
    params = family_params(model)
    ids, mask, labels = synthetic_sst2(512, cfg, seed=99)
    calib_ids, calib_mask, _ = synthetic_sst2(128, cfg, seed=41)
    calib = {"input_ids": calib_ids, "attention_mask": calib_mask}
    inputs = (torch.from_numpy(ids).to("cuda"), torch.from_numpy(mask).to("cuda"))

    def act(w, a, sym, static, **extra):
        return oqt.QConfig(weights=oqt.QWeightArgs(dtype=w, symmetric=sym, group_size=-1),
                           input_activations=oqt.QActivationArgs(dtype=a, is_static=static),
                           output_activations=oqt.QActivationArgs(dtype=a, is_static=static),
                           calibration_data=calib, **extra)

    sites = 6 * cfg.num_layers + 2
    # (label, kernel, Q8 (exact), activation QDQ on W8, QConfig)
    arms = [("uint8_channel", "w8", False, False, oqt.QConfig(
                weights=oqt.QWeightArgs(dtype="uint8", symmetric=False, group_size=-1))),
            ("uint4_g128_rtn", "w4", False, False, oqt.QConfig(
                weights=oqt.QWeightArgs(dtype="uint4", strategy="group", group_size=128))),
            ("wio_uint8_dynamic", "w8", False, True, act("uint8", "uint8", False, False)),
            ("wio_int8_static_sym", "w8", False, True, act("int8", "int8", True, True)),
            ("wio_int8_static_sym as QLINEAR (Q8 with QBias)", "q8", True, False,
             act("int8", "int8", True, True, format="qlinear"))]
    launches: dict = {}
    acc = accuracy(model, params, ids, mask, labels)
    print(f"BERT-base classifier (seeded, 2 classes, max_seq 128, 512 synthetic SST-2 "
          f"sentences) on {card}: float accuracy {acc:.4f} (random weights: not gated)",
          flush=True)
    for label, kernel, exact, act_qdq, qconfig in arms:
        (tree, plan), q_s = timed(lambda: oqt.quantize(model, params, qconfig))
        check(len(plan) == sites, f"BERT {label}: {len(plan)} sites quantized")
        routes = w4_site_routes(model, tree, torch.float32,
                                lambda name: 512 if name in ("pooler", "classifier")
                                else 512 * cfg.max_seq)
        counts, _ = compare_family_arm(
            f"BERT-base {label}, quantized in {q_s:.2f} s", model, tree, inputs,
            {kernel: sites}, exact, card, 510 / 512, act_qdq,
            [tuple(t[i:i + 64] for t in inputs) for i in range(0, len(ids), 64)],
            two_class=True)
        reset_counts()
        acc = accuracy(model, tree, ids, mask, labels)
        torch.cuda.synchronize()
        for k, n in kernel_counts().items():
            launches[k] = launches.get(k, 0) + n
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        extra = f"; W4 sites by route {routes}" if routes else ""
        print(f"BERT-base {label}: accuracy {acc:.4f} (not gated){extra}", flush=True)
        del tree
    return launches


def run_families(model, qparams, card: str) -> dict:
    """Phase 11: the HF import and the command line, TransformerLM and BERT.
    Returns the launches of its main-path runs."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches: dict = {}
    for part in (lambda: run_hf_import_and_cli(model, qparams, card), lambda: run_gpt2(card),
                 lambda: run_bert(card)):
        t0 = time.perf_counter()
        for k, n in part().items():
            launches[k] = launches.get(k, 0) + n
        print(f"phase 11 part done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 11 model families and ways in on {card}: "
          f"{time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    return launches


# -- phase 12: parallelism, two ranks sharing the card --------------------------------

# One world of two ranks, both on cuda:0. The backend is gloo, chosen here:
# NCCL refuses two ranks on one device, and this run has one GPU. Times in
# this phase are two ranks time-sharing one card through host-staged gloo
# collectives, not a tensor-parallel speed.
PARALLEL_RANKS = 2
PARALLEL_BACKEND = "gloo"
PARALLEL_TIMEOUT_S = 480
# Each leg against the port's single-device run of the same tree, on bars set
# from this phase's readings on an H100 (PERF.md section 6), which repeat
# to the digit from run to run. PP and DP run every
# kernel at the single-device shapes and sums, so their logits must be the
# single-device ones bit for bit (torch.equal), and their greedy and sampled
# tokens equal. TP and EP change the kernels' local shapes (so their float32
# summation order) and add the row-parallel partials in one float32 sum; a
# flipped bf16 rounding then passes through the layers. Their bars (shares of
# the largest |logit|) lie between their readings (TP 0.00300; EP 0.00714
# stacked, 0.00694 fused) and a control's, which must fail them: the same
# engine with every all-reduce's partials rounded to bf16 first, a collective
# in the stream's precision (TP 0.00450; EP 0.01071 stacked, 0.03516 fused).
PARALLEL_TP_TOL = 0.0037
PARALLEL_EP_TOL = 0.0087
# A greedy token may leave the single-device stream only at a step whose
# single-device top-2 margin (share of the row's largest |logit|) is under
# twice the leg's bar: both logits of the pair may move by the bar.
# tp_ops and collective (leg c): the local kernels and one float32 sum of two
# partials against one kernel over the whole K: 1e-4 of the largest output
# (phase 3's bar for a kernel against its plain version).
PARALLEL_MATMUL_TOL = 1e-4
# a2a_moe_mlp against the one-device MoE MLP: each expert's output rounds to
# bf16 at the site (2^-9) and the token's k contributions add in float32 in
# another order: 1e-2 of the largest output.
PARALLEL_A2A_TOL = 1e-2
# Window perplexity on the CP mesh against the call without one: mean NLL
# within 2e-3 relative (phase 6's bar for two attention implementations).
PARALLEL_NLL_TOL = 2e-3
GEMMA3_4B_TP_LAYERS = 6  # the 5:1 pattern's first global layer is the sixth
QWEN_EP_LAYERS = 2
# CP's runs, (layers, mode, layout): bar. The gather mode attends the
# gathered K/V densely, as the single-device forward does: in the contiguous
# layout its sums run over the keys in the same order, and it gives the
# single-device logits bit for bit (0: torch.equal); the zigzag layout
# reorders the keys in the softmax's sum and in P.V, and the ring adds the
# streaming softmax's rescales. Those differ by about a bf16 step of the
# logits at one layer, as a control with one bf16 ulp on 0.1% of the
# embedding does (0.00852), and the model's 16 layers amplify that about
# 3.5x (the control 0.02924). Their bars sit at 1.25x their readings.
CP_RUNS = {(16, "ring", "zigzag"): 0.0375, (16, "gather", "zigzag"): 0.027,
           (16, "gather", "contiguous"): 0.0, (1, "ring", "zigzag"): 0.0107,
           (1, "gather", "zigzag"): 0.0071, (1, "gather", "contiguous"): 0.0}


@contextlib.contextmanager
def bf16_partials():
    """A control: every ``comm.all_reduce`` with its partials rounded to bf16
    before the sum, as a collective in the stream's precision would."""
    from onnx_quantize_tpu_torch.parallel import comm

    exact = comm.all_reduce
    comm.all_reduce = lambda x, axis: exact(x.to(torch.bfloat16).to(x.dtype), axis)
    try:
        yield
    finally:
        comm.all_reduce = exact


def greedy_reference(engine, ids, lengths, steps: int) -> dict:
    """The single-device engine's prefill logits and greedy stream, with each
    step's top-2 margin as a share of its row's largest |logit|."""
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first_logits = logits.float().cpu()
    tokens, margins = [], []
    for step in range(steps + 1):
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append(((top[:, 0] - top[:, 1]) / logits.float().abs().amax(-1)).cpu())
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok.cpu())
        if step < steps:
            cache, logits = engine.decode(cache, tok)
    return {"logits": first_logits, "tokens": torch.stack(tokens, 1),
            "margins": torch.stack(margins, 1)}


def check_greedy(label: str, got_tokens, want: dict, tie: float) -> str:
    """Rows equal to the single-device stream, or first leaving it at a step
    whose single-device margin is under ``tie``."""
    got_tokens = torch.as_tensor(got_tokens).cpu().long()
    equal, left = 0, []
    for row in range(got_tokens.shape[0]):
        diff = (got_tokens[row] != want["tokens"][row]).nonzero()
        if len(diff) == 0:
            equal += 1
            continue
        j = int(diff[0])
        margin = float(want["margins"][row, j])
        left.append(f"row {row} at step {j}, margin {margin:.4f}")
        check(margin < tie, f"{label}: row {row} leaves the single-device stream at step {j}, "
                            f"where its top-2 margin is {margin:.4f} (tie bar {tie})")
    return (f"{equal}/{got_tokens.shape[0]} rows' greedy streams equal"
            + (f" ({'; '.join(left)}; tie bar {tie})" if left else ""))


def logit_share(got, want) -> tuple[float, float]:
    """(max, mean) |got - want| as shares of the largest |want|."""
    got, want = got.float(), want.float().to(got.device)
    peak = want.abs().max().item()
    diff = (got - want).abs()
    return diff.max().item() / peak, diff.mean().item() / peak


def served_margin(engine, prompt, out, j: int) -> float:
    """The single-device top-2 margin (share of the largest |logit|) of token
    j of a served output, teacher-forced through a prefill of prompt + out[:j]."""
    seq = list(prompt) + list(out[:j])
    B = engine.max_batch
    ids = np.zeros((B, len(seq)), np.int32)
    ids[0] = seq
    lengths = np.ones((B,), np.int32)
    lengths[0] = len(seq)
    _, logits = engine.prefill(engine.new_cache(), ids, lengths)
    top = torch.topk(logits[0].float(), 2).values
    return ((top[0] - top[1]) / logits[0].float().abs().max()).item()


def check_served_outputs(label: str, got, want, engine, prompts, tie: float) -> str:
    same = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            same += 1
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        margin = served_margin(engine, prompts[i], w, j)
        check(margin < tie, f"{label}: request {i} leaves the single-device output at token "
                            f"{j}, margin {margin:.4f} (tie bar {tie})")
    return f"{same}/{len(want)} served outputs equal"


def probe_gloo_cuda(rank: int) -> dict:
    """A measurement: which gloo collectives accept a CUDA tensor on this
    torch, each tried once on a small tensor on the card, its result checked.
    The port stages every CUDA tensor itself under gloo (``parallel.comm``),
    so nothing depends on the answer."""
    import torch.distributed as dist

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        return x, torch.full((4,), 3.0)

    def all_gather():
        parts = [torch.empty(4, device="cuda") for _ in range(PARALLEL_RANKS)]
        dist.all_gather(parts, torch.full((4,), float(rank), device="cuda"))
        return torch.cat(parts), torch.tensor([0.0] * 4 + [1.0] * 4)

    def all_to_all():
        out = torch.empty(2, device="cuda")
        dist.all_to_all_single(out, torch.tensor([10.0 * rank, 10.0 * rank + 1], device="cuda"))
        return out, torch.tensor([float(rank), 10.0 + rank])

    def broadcast():
        x = torch.full((4,), float(rank), device="cuda")
        dist.broadcast(x, src=1)
        return x, torch.ones(4)

    found = {}
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_to_all", all_to_all), ("broadcast", broadcast)):
        try:
            got, want = fn()
            torch.cuda.synchronize()
            found[name] = "ok" if torch.equal(got.cpu(), want) else "wrong result"
        except (RuntimeError, ValueError) as exc:
            found[name] = f"raises: {str(exc).splitlines()[0][:120]}"
    return found


def leg_run(name: str, fn, results: dict) -> None:
    """Run one leg in a rank: its seconds, collectives and kernel launches."""
    from onnx_quantize_tpu_torch.parallel import comm

    comm.reset_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stats = {k: v for k, v in comm.stats.items() if k != "ops"} | {"ops": dict(comm.stats["ops"])}
    results[name] = {"out": out, "seconds": time.perf_counter() - t0, "comm": stats,
                     "launches": {k: v for k, v in kernel_counts().items() if v}}
    if results["rank"] == 0:
        print(f"phase 12 rank 0: leg ({name}) done in {results[name]['seconds']:.2f} s",
              flush=True)


def sampled_stream(engine, ids, lengths, steps: int) -> torch.Tensor:
    """Prefill, then ``steps`` tokens sampled at temperature 1 from a
    generator seeded SEED on the card: (B, 1 + steps) on the host."""
    from onnx_quantize_tpu_torch.engine import SamplingParams, sample

    sp = SamplingParams(temperature=1.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = sample(logits, gen, sp)
    _, out = engine.decode_multi(cache, first, steps=steps, sampling=sp, generator=gen)
    return torch.cat([first[:, None].int(), out], 1).cpu()


def parallel_rank(rank: int, payload: dict, workdir: str) -> None:
    """One rank of phase 12's world: every leg on this rank's shards."""
    import datetime

    import torch.distributed as dist

    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3
    from onnx_quantize_tpu_torch.parallel import collective, cp, pp, tp_ops
    from onnx_quantize_tpu_torch.parallel.ep import a2a_moe_mlp
    from onnx_quantize_tpu_torch.parallel.mesh import Mesh, make_mesh, use_mesh
    from onnx_quantize_tpu_torch.parallel.tp import build_param_specs, shard_params_local
    from onnx_quantize_tpu_torch.tools.perplexity import perplexity_from_tokens

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(PARALLEL_BACKEND, init_method=f"file://{workdir}/store", rank=rank,
                            world_size=PARALLEL_RANKS,
                            timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S // 2))
    results = {"rank": rank, "probe": probe_gloo_cuda(rank)}
    tp_mesh = make_mesh(model_parallel=2)                # (data 1, model 2)
    dp_mesh = make_mesh(model_parallel=1)                # (data 2, model 1)
    ep_mesh = Mesh(np.arange(PARALLEL_RANKS), ("ep",))
    pipe_mesh = pp.make_pipeline_mesh(PARALLEL_RANKS)
    seq_mesh = cp.make_cp_mesh(PARALLEL_RANKS)
    try:
        # (a) TP engine: Gemma-3-4B.
        a = payload["a"]
        model = Gemma3(a["cfg"])

        def leg_a():
            engine = InferenceEngine(model, a["tree"], max_batch=8, max_seq=256, kv_quant=True,
                                     dtype=torch.bfloat16, fused_attention=True, mesh=tp_mesh)
            cache, logits = engine.prefill(engine.new_cache(), a["ids"], a["lengths"])
            first = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            before = kernel_counts()
            cache, gen = engine.decode_multi(cache, first, steps=a["steps"])
            torch.cuda.synchronize()
            decode = {k: v - before[k] for k, v in kernel_counts().items() if v - before[k]}
            sched = ContinuousBatchingScheduler(engine, chunk=2, pipeline=2)
            reqs = [sched.submit(p, max_new_tokens=a["new_tokens"]) for p in a["prompts"]]
            sched.run()
            with bf16_partials():
                _, control = engine.prefill(engine.new_cache(), a["ids"], a["lengths"])
            return {"logits": logits.float().cpu(), "control": control.float().cpu(),
                    "tokens": torch.cat([first[:, None].int(), gen], 1).cpu(),
                    "decode_launches": decode, "served": [r.output for r in reqs]}

        leg_run("a", leg_a, results)
        del model

        # (b) EP: Qwen1.5-MoE-A2.7B, two layers, stacked and fused experts; a2a.
        b = payload["b"]
        model = Gemma3(b["cfg"])

        def leg_b():
            out = {}
            for layout, tree in b["trees"].items():
                engine = InferenceEngine(model, tree, max_batch=8, max_seq=256, kv_quant=True,
                                         dtype=torch.bfloat16, mesh=tp_mesh)
                cache, logits = engine.prefill(engine.new_cache(), b["ids"], b["lengths"])
                first = torch.argmax(logits, dim=-1)
                cache, gen = engine.decode_multi(cache, first, steps=b["steps"])
                out[layout] = {"logits": logits.float().cpu(),
                               "tokens": torch.cat([first[:, None].int(), gen], 1).cpu()}
                with bf16_partials():
                    _, control = engine.prefill(engine.new_cache(), b["ids"], b["lengths"])
                out[layout]["control"] = control.float().cpu()
                del engine, cache
            stacked = b["a2a_experts"]
            local = shard_params_local(stacked, build_param_specs(stacked, [(r".*", "expert")],
                                                                  axis="ep"), ep_mesh)
            m = b["x"].shape[0] // PARALLEL_RANKS
            rows = slice(rank * m, (rank + 1) * m)
            with use_mesh(ep_mesh):
                for cap in (None, b["small_capacity"], m * b["top_i"].shape[1]):
                    y = a2a_moe_mlp(b["x"][rows], local, b["top_p"][rows], b["top_i"][rows],
                                    axis="ep", num_experts=b["cfg"].num_experts,
                                    activation=b["cfg"].mlp_activation, capacity=cap)
                    out[f"a2a_{cap}"] = y.cpu()
            out["a2a_rows"] = (rows.start, rows.stop)
            return out

        leg_run("b", leg_b, results)
        del model

        # (c) tp_ops and collective at Gemma-3-4B's MLP shapes.
        c = payload["c"]
        gelu = (lambda h: torch.nn.functional.gelu(h, approximate="tanh"))

        def leg_c():
            x, h, up, down = c["x"], c["h"], c["up"], c["down"]
            got = {
                "column": tp_ops.column_parallel_matmul(x, up, tp_mesh, gather_output=True),
                "column_local": tp_ops.column_parallel_matmul(x, up, tp_mesh,
                                                              gather_output=False),
                "row": tp_ops.row_parallel_matmul(h, down, tp_mesh),
                "pair": tp_ops.tp_pair_matmul(x, up, down, tp_mesh, activation=gelu),
                "allgather": collective.allgather_matmul(x, up, tp_mesh),
                "reduce_scatter": collective.matmul_reduce_scatter(h, down, tp_mesh),
                "sp_pair": collective.sequence_parallel_pair(x, up, down, tp_mesh,
                                                             activation=gelu),
            }
            return {k: v.float().cpu() for k, v in got.items()}

        leg_run("c", leg_c, results)

        # (d) PP: Llama-3.2-1B, 16 layers in 2 stages, 4 microbatches of 2 x 512.
        d = payload["d"]
        model = Gemma3(d["cfg"])

        def leg_d():
            stage_tree, shared = pp.pipeline_stage_params(model, d["tree"], PARALLEL_RANKS)
            logits = pp.pp_logits(model, stage_tree, shared, d["ids"], pipe_mesh,
                                  microbatches=4, use_flash=True)
            equal = torch.equal(logits.float(), d["want"].float())
            return logit_share(logits, d["want"]) + (equal,)

        leg_run("d", leg_d, results)

        # (e) CP: one 2048-token window, CP_RUNS; then perplexity.
        e = payload["e"]
        models = {16: model, 1: Gemma3(dataclasses.replace(d["cfg"], num_layers=1))}

        def leg_e():
            out = {}
            for layers, mode, layout in CP_RUNS:
                logits = cp.cp_logits(models[layers], e["tree"], e["ids"], seq_mesh, mode=mode,
                                      layout=layout)
                want = e["want"][layers]
                out[(layers, mode, layout)] = (logit_share(logits, want)
                                               + (torch.equal(logits.float(), want.float()),))
                del logits
            out["ppl"] = perplexity_from_tokens(model, e["tree"], e["tokens"], mesh=seq_mesh)
            return out

        leg_run("e", leg_e, results)
        del model, models

        # (f) DP: the main path's Gemma-3-270M, 16 rows a rank, greedy and sampled.
        f = payload["f"]
        model = Gemma3(f["cfg"])

        def leg_f():
            engine = InferenceEngine(model, f["tree"], max_batch=32, max_seq=512, kv_quant=True,
                                     dtype=torch.bfloat16, mesh=dp_mesh)
            cache, logits = engine.prefill(engine.new_cache(), f["ids"], f["lengths"])
            first = torch.argmax(logits, dim=-1)
            _, gen = engine.decode_multi(cache, first, steps=f["steps"])
            return {"logits": logits.float().cpu(),
                    "tokens": torch.cat([first[:, None].int(), gen], 1).cpu(),
                    "sampled": sampled_stream(engine, f["ids"], f["lengths"], f["steps"])}

        leg_run("f", leg_f, results)
        results["meshes"] = {name: (dict(mesh.shape), dict(mesh.coords), mesh.backend)
                             for name, mesh in (("tp", tp_mesh), ("dp", dp_mesh))}
        torch.save(results, f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_payload(model270, tree270, card: str) -> tuple[dict, dict]:
    """Every leg's global tree and inputs, and the single-device references,
    all computed here in the parent: (payload for the ranks, references)."""
    import onnx_quantize_tpu_torch as oqt
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.models.gemma3 import GEMMA3_4B, Gemma3, fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.llama import LLAMA32_1B
    from onnx_quantize_tpu_torch.models.moe import (
        QWEN15_MOE_A27B,
        fuse_moe_experts,
        stack_moe_experts,
    )
    from onnx_quantize_tpu_torch.ops import quantized_matmul
    from onnx_quantize_tpu_torch.tools.perplexity import perplexity_from_tokens

    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])

    def w4_tree(model, params, gs=128, ignore=("lm_head",)):
        q, _ = oqt.quantize(model, params, oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", group_size=gs), ignore=list(ignore)))
        q, _ = oqt.quantize(model, q, head)
        return fuse_gemma3_projections(q)

    rng = np.random.default_rng(SEED)
    payload, refs = {}, {}
    # (a) Gemma-3-4B at full width, 6 layers.
    cfg = dataclasses.replace(GEMMA3_4B, dtype="bfloat16", num_layers=GEMMA3_4B_TP_LAYERS)
    model = Gemma3(cfg)
    tree = w4_tree(model, model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    ids = rng.integers(1, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    lengths = np.full((8,), 128, np.int32)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(16, 97, size=8)]
    engine = InferenceEngine(model, tree, max_batch=8, max_seq=256, kv_quant=True,
                             dtype=torch.bfloat16, fused_attention=True)
    refs["a"] = greedy_reference(engine, ids, lengths, 16)
    sched = ContinuousBatchingScheduler(engine, chunk=2, pipeline=2)
    reqs = [sched.submit(p, max_new_tokens=8) for p in prompts]
    sched.run()
    refs["a"].update(served=[r.output for r in reqs], engine=engine, prompts=prompts)
    payload["a"] = dict(cfg=cfg, tree=tree, ids=ids, lengths=lengths, steps=16, prompts=prompts,
                        new_tokens=8)
    # (b) Qwen1.5-MoE-A2.7B at full width, 2 layers: g128 stacked, g64 fused.
    cfg = dataclasses.replace(QWEN15_MOE_A27B, dtype="bfloat16", num_layers=QWEN_EP_LAYERS)
    model = Gemma3(cfg)
    params = moe_params(model)
    trees = {}
    for layout, gs in (("stacked", 128), ("fused", 64)):
        t = w4_tree(model, params, gs, ("lm_head", r"\.router$", r"\.shared_gate$"))
        trees[layout] = stack_moe_experts(fuse_moe_experts(prepare_kernel_scales(t)))
    del params
    check("_stacked_experts" in trees["stacked"]["layers.0"]["mlp"]
          and "_fused_experts" in trees["fused"]["layers.0"]["mlp"], "phase 12 (b) layouts")
    ids_b = rng.integers(1, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    refs["b"] = {}
    with ragged_prefill(model, False):
        for layout, t in trees.items():
            engine = InferenceEngine(model, t, max_batch=8, max_seq=256, kv_quant=True,
                                     dtype=torch.bfloat16)
            refs["b"][layout] = greedy_reference(engine, ids_b, lengths, 8)
            del engine
    mlp = model.layers[0].mlp
    mlp_params = trees["stacked"]["layers.0"]["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn((2 * 64, cfg.hidden_size), generator=gen, device="cuda")).to(torch.bfloat16)
    top_p, top_i = mlp._routing(mlp_params, x)
    from onnx_quantize_tpu_torch.models.gemma3 import stacked_expert_mlp

    combine = mlp._combine_weights(top_p, top_i, cfg.num_experts)
    routed = torch.zeros((x.shape[0], cfg.hidden_size), dtype=torch.float32, device="cuda")
    for ex in range(cfg.num_experts):
        w_e = combine[:, ex]
        ye = stacked_expert_mlp(mlp_params["_stacked_experts"], ex,
                                x * (w_e > 0).to(x.dtype)[:, None], mlp.activation)
        routed += ye.float() * w_e[:, None]
    refs["b"]["a2a"] = routed.cpu()
    payload["b"] = dict(cfg=cfg, trees=trees, ids=ids_b, lengths=lengths, steps=8, x=x,
                        top_p=top_p, top_i=top_i, small_capacity=4,
                        a2a_experts=mlp_params["_stacked_experts"])
    # (c) Gemma-3-4B's MLP shapes: M = 256, K = 2560, intermediate 10240, W4 g128.
    up = random_qtensor(2560, 10240, "uint4", 128, False, gen)
    down = random_qtensor(10240, 2560, "uint4", 128, False, gen)
    xc = torch.randn((256, 2560), generator=gen, device="cuda").to(torch.bfloat16)

    def gelu(t):
        return torch.nn.functional.gelu(t, approximate="tanh")

    hc = gelu(quantized_matmul(xc, up)).to(torch.bfloat16)
    y_up = quantized_matmul(xc, up)
    refs["c"] = {"column": y_up, "row": quantized_matmul(hc, down),
                 "pair": quantized_matmul(gelu(y_up), down),
                 "sp_pair": quantized_matmul(gelu(y_up).to(torch.bfloat16), down)}
    refs["c"] = {k: v.float().cpu() for k, v in refs["c"].items()}
    payload["c"] = dict(x=xc, h=hc, up=up, down=down)
    # (d, e) Llama-3.2-1B at full width and depth.
    cfg = dataclasses.replace(LLAMA32_1B, dtype="bfloat16")
    model = Gemma3(cfg)
    tree = w4_tree(model, llama_params(model))
    ids_d = rng.integers(1, cfg.vocab_size, size=(8, 512)).astype(np.int32)
    model.use_flash = True
    with torch.inference_mode():
        want_d = model(tree, torch.as_tensor(ids_d, dtype=torch.int64, device="cuda"))
    payload["d"] = dict(cfg=cfg, tree=tree, ids=ids_d, want=want_d)
    ids_e = rng.integers(1, cfg.vocab_size, size=(1, 2048)).astype(np.int32)
    tokens = rng.integers(1, cfg.vocab_size, size=4096)
    # The ring attends in plain torch; so do these references.
    models = {16: model, 1: Gemma3(dataclasses.replace(cfg, num_layers=1))}
    bumped, n_bumped = bump_embedding(tree)
    want_e, control_e = {}, {}
    with torch.inference_mode():
        ids_t = torch.as_tensor(ids_e, dtype=torch.int64, device="cuda")
        for layers, m in models.items():
            m.use_flash = False
            want_e[layers] = m(tree, ids_t)
            control_e[layers] = logit_share(m(bumped, ids_t), want_e[layers])
    del bumped
    model.use_flash = "auto"
    refs["e"] = {"ppl": perplexity_from_tokens(model, tree, tokens), "control": control_e,
                 "bumped": n_bumped}
    payload["e"] = dict(tree=tree, ids=ids_e, want=want_e, tokens=tokens)
    # (f) the main path's tree, B = 32; rows 0 and 16 (the first of each data
    # rank) hold one prompt, and must still sample different streams.
    ids_f = rng.integers(1, model270.cfg.vocab_size, size=(32, 128)).astype(np.int32)
    ids_f[16] = ids_f[0]
    lengths_f = np.full((32,), 128, np.int32)
    engine = InferenceEngine(model270, tree270, max_batch=32, max_seq=512, kv_quant=True,
                             dtype=torch.bfloat16)
    refs["f"] = greedy_reference(engine, ids_f, lengths_f, 16)
    refs["f"]["sampled"] = sampled_stream(engine, ids_f, lengths_f, 16)
    del engine
    payload["f"] = dict(cfg=model270.cfg, tree=tree270, ids=ids_f, lengths=lengths_f, steps=16)
    torch.cuda.synchronize()
    return payload, refs


def run_parallel(model270, tree270, card: str) -> dict:
    """Phase 12: tensor, expert, pipeline, context and data parallelism on a
    world of two ranks sharing the card (gloo), each leg held to the port's
    single-device path on the same global tree. Returns the ranks' kernel
    launches, summed."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    payload, refs = parallel_payload(model270, tree270, card)
    t_refs = time.perf_counter() - t0
    print(f"phase 12: trees and single-device references built in {t_refs:.1f} s; world of "
          f"{PARALLEL_RANKS} ranks on cuda:0, backend {PARALLEL_BACKEND} (chosen: NCCL refuses "
          f"two ranks on one device, and this run has one GPU)", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        t1 = time.perf_counter()
        ctx = mp.start_processes(parallel_rank, args=(payload, workdir), nprocs=PARALLEL_RANKS,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                check(time.monotonic() < deadline,
                      f"phase 12's world still running after {PARALLEL_TIMEOUT_S} s")
        except mp.ProcessRaisedException as exc:
            raise SmokeFailure(f"a phase 12 rank failed:\n{exc}") from None
        except mp.ProcessExitedException as exc:
            raise SmokeFailure(f"a phase 12 rank exited: {exc}") from None
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        world_s = time.perf_counter() - t1
        ranks = [torch.load(f"{workdir}/rank{r}.pt", weights_only=False)
                 for r in range(PARALLEL_RANKS)]
    del payload
    torch.cuda.ipc_collect()  # the ranks' handles on the shared trees are gone
    print(f"gloo on CUDA tensors ({torch.__version__}), one call each (a measurement: the port "
          f"stages every CUDA tensor under gloo): "
          + ", ".join(f"{k} {v}" for k, v in ranks[0]["probe"].items())
          + "; send/recv not tried", flush=True)
    print(f"meshes: {ranks[0]['meshes']}, {ranks[1]['meshes']}", flush=True)

    def header(leg: str, what: str) -> str:
        secs = max(r[leg]["seconds"] for r in ranks)
        comm_ = ranks[0][leg]["comm"]
        return (f"phase 12 ({leg}) {what}, two ranks sharing {card}: {secs:.2f} s (the slower "
                f"rank); rank 0's collectives {comm_['calls']} ({comm_['bytes']} B; "
                f"{comm_['ops']}), staged {comm_['staged_calls']} calls {comm_['staged_bytes']} B; "
                f"launches per rank {[r[leg]['launches'] for r in ranks]}")

    def held(label: str, got, want, control, tol: float) -> str:
        """Logits within ``tol`` of the largest, and the bf16-partials control
        outside it."""
        share, mean = logit_share(got, want)
        ctrl, _ = logit_share(control, want)
        check(share <= tol, f"{label}: prefill logits {share:.5f} of the largest from "
                            f"single-device (tol {tol})")
        check(ctrl > tol, f"{label}: the bf16-partials control ({ctrl:.5f}) passes the bar {tol}")
        return (f"{label} prefill logits max {share:.5f} mean {mean:.6f} of max|logit| (tol "
                f"{tol}; bf16-partials control {ctrl:.5f})")

    # (a)
    want = refs["a"]
    lines = []
    for r, res in enumerate(ranks):
        out = res["a"]["out"]
        lines.append(held(f"rank {r}", out["logits"], want["logits"], out["control"],
                          PARALLEL_TP_TOL))
        lines.append(check_greedy(f"(a) rank {r}", out["tokens"], want, 2 * PARALLEL_TP_TOL))
        lines.append(check_served_outputs(f"(a) rank {r}", out["served"], want["served"],
                                          want["engine"], want["prompts"], 2 * PARALLEL_TP_TOL))
        layers = GEMMA3_4B_TP_LAYERS
        check(out["decode_launches"] == {"w4": 16 * 4 * layers, "w8": 16,
                                         "flash_decode": 16 * layers},
              f"(a) rank {r}: 16 decode steps launched {out['decode_launches']}")
    print(header("a", f"TP engine, Gemma-3-4B ({GEMMA3_4B_TP_LAYERS} layers, full width, "
                      "W4 g128 + int8 head, int8 KV, flash decode) on (data 1, model 2): "
                      "prefill B=8 T=128, 16 greedy steps, 8 served requests, a control prefill")
          + ": " + "; ".join(lines), flush=True)
    del want["engine"]
    # (b)
    lines = []
    for r, res in enumerate(ranks):
        out = res["b"]["out"]
        for layout in ("stacked", "fused"):
            lines.append(held(f"rank {r} {layout}", out[layout]["logits"],
                              refs["b"][layout]["logits"], out[layout]["control"],
                              PARALLEL_EP_TOL)
                         + ", " + check_greedy(f"(b) {layout} rank {r}", out[layout]["tokens"],
                                               refs["b"][layout], 2 * PARALLEL_EP_TOL))
        lo, hi = out["a2a_rows"]
        exact = out["a2a_None"]
        want_rows = refs["b"]["a2a"][lo:hi]
        err = (exact - want_rows).abs().max().item() / refs["b"]["a2a"].abs().max().item()
        check(err <= PARALLEL_A2A_TOL, f"(b) a2a rank {r}: {err:.4e} of the largest output")
        worst = out[f"a2a_{(hi - lo) * 4}"]
        dropped = out["a2a_4"]
        check(torch.equal(worst, exact), f"(b) a2a rank {r}: worst-case capacity differs from "
                                         "capacity None")
        check(bool(torch.isfinite(dropped).all()) and not torch.equal(dropped, exact),
              f"(b) a2a rank {r}: capacity 4 dropped nothing")
        lines.append(f"rank {r} a2a_moe_mlp (64 rows) max {err:.5f} of the largest output "
                     f"(tol {PARALLEL_A2A_TOL}), worst-case capacity bit-equal, capacity 4 drops")
    print(header("b", f"EP, Qwen1.5-MoE-A2.7B ({QWEN_EP_LAYERS} layers, full width, 30 experts "
                      "a rank) on (data 1, model 2): prefill B=8 T=128, 8 greedy steps, "
                      "stacked g128 and fused g64, a control prefill each; a2a_moe_mlp over "
                      "2 x 64 rows") + ": " + "; ".join(lines), flush=True)
    # (c)
    lines = []
    for r, res in enumerate(ranks):
        out = res["c"]["out"]
        wc = refs["c"]
        blocks = {"column": wc["column"], "column_local": wc["column"].chunk(2, 1)[r],
                  "row": wc["row"], "pair": wc["pair"],
                  "allgather": wc["column"].chunk(2, 1)[r],
                  "reduce_scatter": wc["row"].chunk(2, 0)[r],
                  "sp_pair": wc["sp_pair"].chunk(2, 0)[r]}
        errs = {}
        for name, want_block in blocks.items():
            check(out[name].shape == want_block.shape,
                  f"(c) {name} rank {r}: shape {tuple(out[name].shape)}")
            errs[name] = ((out[name] - want_block).abs().max().item()
                          / want_block.abs().max().item())
            check(errs[name] <= PARALLEL_MATMUL_TOL, f"(c) {name} rank {r}: {errs[name]:.3e} "
                                                     "of the largest output")
        lines.append(f"rank {r} " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    print(header("c", "tp_ops and collective at Gemma-3-4B's MLP shapes (M=256, K=2560, "
                      "intermediate 10240, W4 g128) on (data 1, model 2)")
          + f"; max err as a share of the largest output, tol {PARALLEL_MATMUL_TOL}: "
          + "; ".join(lines), flush=True)
    # (d)
    lines = []
    for r, res in enumerate(ranks):
        share, mean, equal = res["d"]["out"]
        check(equal, f"(d) rank {r}: pp logits not bit-equal to single-device ({share:.5f} of "
                     "the largest)")
        check(res["d"]["launches"].get("flash_attention", 0) == 4 * 8,
              f"(d) rank {r}: launches {res['d']['launches']}")
        lines.append(f"rank {r} logits bit-equal (max {share:.5f})")
    print(header("d", "PP, Llama-3.2-1B (16 layers, full width, W4 g128 + int8 head) in 2 "
                      "stages, 4 microbatches of 2 x 512, flash attention in the stages")
          + "; against the single-device forward, torch.equal: " + "; ".join(lines), flush=True)
    # (e)
    lines = [f"control ({refs['e']['bumped']} embedding entries one bf16 ulp up) "
             + ", ".join(f"{k} layers max {v[0]:.5f} mean {v[1]:.6f}"
                         for k, v in refs["e"]["control"].items())]
    for r, res in enumerate(ranks):
        out = res["e"]["out"]
        for run, tol in CP_RUNS.items():
            share, mean, equal = out[run]
            check(equal if tol == 0 else share <= tol,
                  f"(e) {run} rank {r}: {share:.5f} of the largest logit (bar {tol or 'equal'})")
            lines.append(f"rank {r} {run[0]} layers {run[1]} {run[2]} "
                         + ("bit-equal" if equal else f"max {share:.5f} mean {mean:.6f}")
                         + f" (bar {tol or 'torch.equal'})")
        nll, want_nll = math.log(out["ppl"]), math.log(refs["e"]["ppl"])
        check(abs(nll - want_nll) <= PARALLEL_NLL_TOL * abs(want_nll),
              f"(e) rank {r}: perplexity {out['ppl']:.4f} vs {refs['e']['ppl']:.4f}")
        lines.append(f"rank {r} window ppl {out['ppl']:.4f} (single-device "
                     f"{refs['e']['ppl']:.4f})")
    print(header("e", "CP, Llama-3.2-1B, one 2048-token window in 2 shards, at 16 layers and "
                      "at 1; perplexity_from_tokens over 4,096 tokens (5 windows)")
          + f"; logits against the single-device forward with plain attention, mean NLL tol "
          f"{PARALLEL_NLL_TOL}: " + "; ".join(lines),
          flush=True)
    # (f)
    lines = []
    want = refs["f"]
    check(not torch.equal(want["sampled"][0], want["sampled"][16]),
          "(f) single-device: rows 0 and 16 sampled one stream")
    for r, res in enumerate(ranks):
        out = res["f"]["out"]
        check(torch.equal(out["logits"], want["logits"]),
              f"(f) rank {r}: prefill logits not bit-equal to single-device")
        check(torch.equal(out["tokens"].long(), want["tokens"].long()),
              f"(f) rank {r}: greedy tokens differ from single-device")
        check(torch.equal(out["sampled"], want["sampled"]),
              f"(f) rank {r}: sampled tokens differ from single-device")
        lines.append(f"rank {r} prefill logits bit-equal, 32/32 greedy and sampled streams equal")
    print(header("f", "DP, the main path (Gemma-3-270M W4 + int8 head, int8 KV) on (data 2, "
                      "model 1): 16 rows a rank, 16 greedy steps, then 16 sampled at "
                      "temperature 1 (rows 0 and 16 one prompt, two streams)")
          + "; torch.equal: " + "; ".join(lines), flush=True)

    launches = {}
    for res in ranks:
        for leg in "abcdef":
            for key, n in res[leg]["launches"].items():
                launches[key] = launches.get(key, 0) + n
    for key in ("w4", "w8", "flash_decode", "flash_attention"):
        check(launches.get(key, 0) > 0, f"phase 12's ranks launched no {key} kernel")
    print(f"phase 12 parallel on {card}: {time.perf_counter() - t0:.1f} s (references "
          f"{t_refs:.1f} s, the world {world_s:.1f} s with the spawn and both CUDA contexts); "
          f"the ranks' launches {launches}", flush=True)
    return launches


# -- phase 13: the kernel benchmark tool and the examples -----------------------------

# The tool's cases: (label, kernel, M, K, N, phase 3's case at M = 32 with
# the same kernel and shape, or None); the last one runs the command line's
# defaults (w4, 1024 x 2048 x 2048) and passes no shape.
TOOL_CASES = [
    ("w4 at the 270M's fused gate_up", "w4", 32, 640, 4096, "gate_up"),
    ("w4 at the 270M's down", "w4", 32, 2048, 640, "down"),
    ("w8 at the 270M's lm_head", "w8", 32, 640, 262144, "lm_head"),
    ("w4a8 at the 270M's fused gate_up", "w4a8", 32, 640, 4096, "gate_up"),
    ("the command line's defaults", "w4", 1024, 2048, 2048, None),
]
TOOL_REPORT_KEYS = {"shape", "quant", "time_us", "tflops", "hbm_gbps", "bound", "pct_roofline",
                    "chip", "dense_time_us", "dense_hbm_gbps", "pct_of_dense_control",
                    "speedup_vs_dense", "device", "card"}
TOOL_GROUP = 128  # the command line's default group size


def tool_bytes(kernel: str, M: int, K: int, N: int, gs: int = TOOL_GROUP) -> int:
    """Bytes the tool's matmul must move, from the shapes of the weight it
    builds (RTN per group, asymmetric; 4-bit in group pairs with the
    engine's baked float32 scales and zero points, 8-bit with float32 scales
    and int8 zero points), bf16 x and the float32 output."""
    groups = -(-K // gs)
    if kernel in ("w4", "w4a8"):
        pairs = -(-groups // 2)
        weight = pairs * gs * N + 2 * (2 * pairs * N * 4)
    else:
        weight = K * N + groups * N * (4 + 1)
    return weight + M * K * 2 + M * N * 4


def run_tool_case(label: str, kernel: str, M: int, K: int, N: int, flags: list[str]) -> dict:
    """The tool as a user runs it, from the checkout: exit 0, one JSON line
    with the report's keys, 0 < pct_roofline <= 100 and a time no lower than
    the bound computed here from the shapes."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "onnx_quantize_tpu_torch.tools.benchmark",
                          *flags, "--control"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"benchmark tool ({label}) exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 1, f"benchmark tool ({label}) printed {len(lines)} lines")
    report = json.loads(lines[0])
    check(set(report) == TOOL_REPORT_KEYS, f"benchmark tool ({label}) keys {sorted(report)}")
    check(report["shape"] == f"{M}x{K}x{N}", f"benchmark tool ({label}) shape {report['shape']}")
    check(0 < report["pct_roofline"] <= 100,
          f"benchmark tool ({label}) read {report['pct_roofline']}% of its roofline")
    bound_ms, bound_by = bound(tool_bytes(kernel, M, K, N), 2 * M * K * N,
                               "int8" if kernel == "w4a8" else "bf16")
    check(report["time_us"] >= 1e3 * bound_ms, f"benchmark tool ({label}) read "
                                               f"{report['time_us']} us, under its bound")
    report.update(bound_ms=bound_ms, bound_by=bound_by, seconds=secs)
    return report


def run_tools(kernel_results: dict, card: str) -> None:
    """Phase 13 (a): ``python -m onnx_quantize_tpu_torch.tools.benchmark
    --control`` at the 270M's shapes and at its defaults, each time beside
    phase 3's for the same kernel and shape."""
    for label, kernel, M, K, N, case in TOOL_CASES:
        flags = (["--kernel", kernel, "--m", str(M), "--k", str(K), "--n", str(N)]
                 if case else [])
        r = run_tool_case(label, kernel, M, K, N, flags)
        what = {"w4": "uint4 g128", "w8": "int8 symmetric per channel",
                "w4a8": "uint4 g128, the kernel alone: the tool times the whole A8 site, "
                        "its activation quantizer and pad too"}[kernel]
        phase3 = (f"{kernel_results[kernel]['case_ms'][(case, M)] * 1e3:.1f} us (phase 3: "
                  f"{what}; L2 flushed, one call timed alone)" if case else "no phase 3 case")
        print(f"phase 13 (a) benchmark tool, {label} ({r['shape']}, {r['quant']}) on "
              f"{r['card']}: {r['time_us']} us (slope between trip counts of a CUDA graph over "
              f"copies past twice L2), {r['pct_roofline']}% of the roofline ({r['bound']} "
              f"bound; bound here {1e3 * r['bound_ms']:.2f} us by {r['bound_by']}), "
              f"{r['tflops']} TFLOP/s, {r['hbm_gbps']} GB/s; dense bf16 control "
              f"{r['dense_time_us']} us, pct_of_dense_control {r['pct_of_dense_control']}, "
              f"speedup_vs_dense {r['speedup_vs_dense']}; phase 3's time {phase3}; "
              f"{r['seconds']:.1f} s with the interpreter's start", flush=True)
        check(r["card"] == card, f"benchmark tool read the card as {r['card']!r}")


# Phase 13 (b)'s check of a checkpoint: prefill B x T seeded ids, then greedy steps.
EXAMPLE_B, EXAMPLE_T, EXAMPLE_STEPS = 8, 128, 8
# Qwen1.5-MoE-A2.7B's example runs this many of its 24 layers.
MOE_EXAMPLE_LAYERS = 1


def kernel_sites(tree) -> dict:
    """Launches a forward makes, from a tree's quantized sites: W4 for each
    packed site, W8 for each 8-bit one, a stacked site once per expert."""
    from onnx_quantize_tpu_torch.nn.qtensor import QTensor
    from onnx_quantize_tpu_torch.utils import tree_map

    counts = {name: 0 for name in kernel_modules()}

    def visit(leaf):
        if isinstance(leaf, QTensor):
            counts["w4" if leaf.meta.packed else "w8"] += (
                leaf.data.shape[0] if leaf.data.ndim == 3 else 1)

    tree_map(visit, tree)
    return counts


def serve_checkpoint(label: str, path: str, card: str) -> dict:
    """A saved example checkpoint loaded on the card (its online rotations
    stamped again, an MoE in the example's engine layout with the ragged
    prefill off, so every forward runs every expert site), prefilled and
    decoded: exactly the tree's W4 and W8 sites launched a forward, logits
    finite and within 5% of the largest logit of the plain run. Returns the
    launches."""
    from onnx_quantize_tpu_torch.checkpoint import load_checkpoint
    from onnx_quantize_tpu_torch.engine import InferenceEngine, prepare_kernel_scales
    from onnx_quantize_tpu_torch.models.gemma3 import fuse_gemma3_projections
    from onnx_quantize_tpu_torch.models.moe import stack_moe_experts
    from onnx_quantize_tpu_torch.prepasses.rotate import stamp_online_rotations

    (model, tree), load_s = timed(lambda: load_checkpoint(path, device="cuda"))
    cfg = model.cfg
    online = json.loads((Path(path) / "meta.json").read_text())["extra"]["online_rotations"]
    if any(online.values()):
        stamp_online_rotations(model, qk=online["qk"], down=online["down"], seed=0)
    if cfg.num_experts:
        tree = stack_moe_experts(prepare_kernel_scales(fuse_gemma3_projections(tree)))
        for layer in model.layers:
            layer.mlp.use_ragged_prefill = False
    per_forward = kernel_sites(tree)
    engine = InferenceEngine(model, tree, max_batch=EXAMPLE_B, max_seq=2 * EXAMPLE_T,
                             kv_quant=True, dtype=cfg.torch_dtype)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, cfg.vocab_size, size=(EXAMPLE_B, EXAMPLE_T)).astype(np.int32)
    lengths = np.full((EXAMPLE_B,), EXAMPLE_T, np.int32)

    def served():
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        prefill = kernel_counts()
        _, tokens = engine.decode_multi(cache, torch.argmax(logits, dim=-1), steps=EXAMPLE_STEPS)
        return logits, tokens, prefill

    reset_counts()
    (logits, tokens, prefill), serve_s = timed(served)
    total = kernel_counts()
    with plain_kernels():
        (plain_logits, plain_tokens, _), plain_s = timed(served)
    check(kernel_counts() == total, f"{label}: the plain run launched kernels")
    want = {k: n * (1 + EXAMPLE_STEPS) for k, n in per_forward.items()}
    check(prefill == per_forward and total == want,
          f"{label}: a prefill launched {prefill} and it with {EXAMPLE_STEPS} steps {total}, "
          f"expected {per_forward} a forward (the tree's sites) and no other")
    check(tuple(logits.shape) == (EXAMPLE_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{label}: prefill logits {logits.shape}, "
                                                  "or not finite")
    diff = (logits.float() - plain_logits.float()).abs().max().item()
    peak = plain_logits.float().abs().max().item()
    agree = (tokens == plain_tokens).float().mean().item()
    print(f"phase 13 (b) {label} served on {card}: loaded in {load_s:.2f} s, online rotations "
          f"{online}; launches a forward {({k: v for k, v in per_forward.items() if v})}; "
          f"prefill B={EXAMPLE_B} T={EXAMPLE_T} and {EXAMPLE_STEPS} greedy steps {serve_s:.2f} "
          f"s (plain {plain_s:.2f}); prefill logits kernel vs plain max_abs_diff {diff:.4e}, "
          f"max|logit| {peak:.4e} (bar 5%); greedy tokens equal {agree:.4f} (not gated)",
          flush=True)
    check(diff <= 0.05 * peak, f"{label}: logits through the kernels {diff:.4e} from plain")
    return total


def run_examples(card: str) -> dict:
    """Phase 13 (b): each example in process through its ``main(argv)``, at
    full width (the MoE's depth cut), its checkpoint served; the serving and
    BERT examples with their defaults. Returns the launches."""
    from onnx_quantize_tpu_torch.examples import llama_rotate_w4, llama_rtn, moe_rtn, serving
    from onnx_quantize_tpu_torch.examples.bert import bert_sst2
    from onnx_quantize_tpu_torch.examples.gemma3 import gemma3_awq, gemma3_rtn
    from onnx_quantize_tpu_torch.models.moe import MoE

    launches = {name: 0 for name in kernel_modules()}

    def add(counts):
        for key, n in counts.items():
            launches[key] += n

    full = moe_rtn.QWEN15_MOE_A27B
    body = sum(s.in_features * s.out_features for s in MoE(full).linear_sites()
               if s.name != "lm_head" and not s.name.endswith(("router", "shared_gate")))
    floats = 4 * (full.vocab_size * full.hidden_size * 2 + body)
    print(f"phase 13 (b) moe_rtn depth cut: {MOE_EXAMPLE_LAYERS} of Qwen1.5-MoE-A2.7B's "
          f"{full.num_layers} layers at full width; at full depth its float32 tree would take "
          f"{floats / 1e9:.1f} GB of device memory and its uint4 checkpoint about "
          f"{(body / 2 + 4 * full.vocab_size * full.hidden_size * 2) / 1e9:.1f} GB of disk",
          flush=True)
    examples = [("gemma3_rtn (Gemma-3-270M, int8 g128)", gemma3_rtn, []),
                ("gemma3_awq (Gemma-3-270M, AWQ uint4 g128)", gemma3_awq, []),
                ("llama_rtn (Llama-3.2-1B, int8 g128)", llama_rtn, []),
                ("llama_rotate_w4 (Llama-3.2-1B, Hadamard R1, RTN uint4 g128)",
                 llama_rotate_w4, []),
                (f"moe_rtn (Qwen1.5-MoE-A2.7B, {MOE_EXAMPLE_LAYERS} of 24 layers, uint4 g128)",
                 moe_rtn, [])]
    moe_rtn.QWEN15_MOE_A27B = dataclasses.replace(full, num_layers=MOE_EXAMPLE_LAYERS)
    try:
        for label, module, flags in examples:
            with tempfile.TemporaryDirectory() as tmp:
                out = str(Path(tmp) / "ckpt")
                reset_counts()
                _, secs = timed(lambda: module.main(["--output", out, *flags]))
                check(sum(kernel_counts().values()) == 0,
                      f"{label}: quantizing launched {kernel_counts()}")
                size = sum(f.stat().st_size for f in Path(out).iterdir())
                print(f"phase 13 (b) {label}: main() quantized and saved in {secs:.2f} s, "
                      f"checkpoint {size / 1e9:.2f} GB", flush=True)
                add(serve_checkpoint(label, out, card))
            torch.cuda.empty_cache()
    finally:
        moe_rtn.QWEN15_MOE_A27B = full

    reset_counts()
    (finished, stats), secs = timed(lambda: serving.main([]))
    counts = kernel_counts()
    add(counts)
    reqs = serving.workload(serving.config(False).vocab_size, 32)
    check(len(finished) == len(reqs), f"serving example: {len(finished)} of 32 finished")
    for r in finished:
        kw = reqs[r.request_id][1]
        ended = kw["eos_token_id"] is not None and r.output[-1] == kw["eos_token_id"]
        check(len(r.output) == kw["max_new_tokens"]
              or (ended and len(r.output) < kw["max_new_tokens"]),
              f"serving example: request {r.request_id} emitted {len(r.output)} of "
              f"{kw['max_new_tokens']}")
    forwards = stats["rounds"] * 16 + stats["admit_rounds"]
    per_forward = 4 * serving.config(False).num_layers
    check(counts["w8"] == forwards and counts["w4"] == per_forward * forwards
          and sum(counts.values()) == counts["w4"] + counts["w8"],
          f"serving example launched {counts}, expected {forwards} W8 and "
          f"{per_forward * forwards} W4 and no other")
    generated = sum(len(r.output) for r in finished)
    print(f"phase 13 (b) serving example (Gemma-3-270M bf16, W4 g128, int8 head, int8 KV, 8 "
          f"slots, chunk 16, pipeline 8) on {card}: 32 requests finished within their budgets, "
          f"{generated} tokens in {secs:.2f} s with the build of its trees, rounds "
          f"{stats['rounds']}, admission rounds {stats['admit_rounds']}, launches {counts} "
          f"(one W8 and {per_forward} W4 a forward)", flush=True)
    del finished
    torch.cuda.empty_cache()

    reset_counts()
    rows, secs = timed(lambda: bert_sst2.main([]))
    add(kernel_counts())
    check(len(rows) == 6 and all(0.0 <= acc <= 1.0 for _, acc in rows),
          f"bert_sst2 example printed {rows}")
    print(f"phase 13 (b) bert_sst2 example (400 steps, 512 sentences) on {card} in {secs:.2f} "
          f"s: " + ", ".join(f"{name} {acc:.4f}" for name, acc in rows)
          + f"; launches {({k: v for k, v in kernel_counts().items() if v})}", flush=True)
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
    from onnx_quantize_tpu_torch.tools.benchmark import card_line

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
    kernel_results["mlp_w4"] = mlp = run_mlp_checks(gen, log)
    print(f"fused MLP, one layer at the 270M widths (bf16 x, L2 cold) on {card}: "
          + "; ".join(f"M={M} kernel {r['ms']:.4f} ms, the first design {r['before_ms']:.4f}, "
                      f"unfused W4 pair {r['unfused_ms']:.4f}, bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}), plain {r['plain_ms']:.4f}"
                      for M, r in sorted(mlp["by_m"].items())), flush=True)
    family_kernel_checks(gen)
    phase_done("3 kernels")

    # Phase 4: the main path: W4, A8, Q8 and MLP arms.
    from onnx_quantize_tpu_torch.ops import convert_to_w4a8
    from onnx_quantize_tpu_torch.ops.kernels import matmul_q8

    model, params, qparams, fparams, q8params, q8_s = build_models()
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

    # Phase 4b: the quantizer algorithms on the card, each tree served.
    for counts in run_quantizer_algorithms(model, params, qparams, fparams, card).values():
        for key, n in counts.items():
            if n:
                launches[key] += n
    del params
    phase_done("4b quantizer algorithms")

    # Phase 4c: QuaRot on Llama-3.2-1B at full width; its kernels at its shapes.
    llama = run_kernel_checks(gen, LLAMA_KERNEL_CASES)
    llama["flash_attention"] = run_window_flash_attention(gen, "fa_llama_T2048_g4_D64", 32, 8,
                                                          64, 16)
    for kernel, big, what in (("w4", "m2048", "W4, a layer's four body sites"),
                              ("w4a8", "m4096", "W4A8, a layer's four body sites"),
                              ("w8", "m2048", "W8, the lm_head"),
                              ("w8a8", "m2048", "W8A8, the lm_head")):
        res = llama[kernel]
        print(f"Llama-3.2-1B {what} (L2 cold) on {card}: "
              + "; ".join(f"M={M} kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} "
                          f"({r['bound_by']}), plain {r['plain_ms']:.4f}, library "
                          f"{r['library_ms']:.4f}"
                          for M, r in ((32, res), (int(big[1:]), res[big])))
              + f"; max_abs_err {res['max_abs_err']:.3e}", flush=True)
    for key, n in run_llama_quarot(card).items():
        launches[key] = launches.get(key, 0) + n
    phase_done("4c Llama-3.2-1B QuaRot")

    # Phase 4d: Mixture-of-Experts at Qwen1.5-MoE-A2.7B's width, full depth.
    for key, n in run_moe(card)["launches"].items():
        launches[key] = launches.get(key, 0) + n
    phase_done("4d Qwen1.5-MoE-A2.7B")

    # Phase 5: rates.
    # The loop is host-bound and the host is shared, so the arms take turns
    # (the order rotates each round) and each reports the median of 3 samples.
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
    for r in range(3):
        for name in names[r % len(names):] + names[:r % len(names)]:
            rates[name].append(arms[name]())
    rate_q, rate_f, rate_a8, rate_q8, rate_mlp, rate_bf16 = (float(np.median(rates[n]))
                                                             for n in names)
    samples = {n: [round(v, 1) for v in r] for n, r in rates.items()}
    print(f"decode tok/s samples: {json.dumps(samples)}")
    print(f"decode tok/s (B=32, prompt 128, slope 16->48 steps, CUDA events, median of 3) on "
          f"{card}: quantized W4+int8 head+int8 KV {rate_q:.1f}, with flash decode "
          f"{rate_f:.1f}, W4A8+W8A8 head+int8 KV {rate_a8:.1f}, Q8+int8 head+int8 KV "
          f"{rate_q8:.1f}, quantized with fused MLP {rate_mlp:.1f}, bf16 {rate_bf16:.1f}, ratio "
          f"quantized/bf16 {rate_q / rate_bf16:.3f}, fused/unfused {rate_f / rate_q:.3f}, "
          f"w4a8/quantized {rate_a8 / rate_q:.3f}, q8/quantized {rate_q8 / rate_q:.3f}, "
          f"mlp/quantized {rate_mlp / rate_q:.3f}", flush=True)
    phase_done("5 rates")

    # Phase 6: window scoring (the flash-attention path), W4 and A8 models.
    w4_scoring, a8_scoring = run_window_scoring(model, qparams, a8params, fparams, card)
    launches["flash_attention"] += w4_scoring["flash_attention"]
    check(a8_scoring["flash_attention"] == w4_scoring["flash_attention"],
          "the A8 model's window scoring launched another flash-attention count")
    phase_done("6 window scoring")

    # Phase 7: decode-path scoring (the flash-decode path).
    launches["flash_decode"] = (launches.get("flash_decode", 0)
                                + run_decode_scoring(model, qparams, card)["flash_decode"])
    phase_done("7 decode scoring")

    # Launches of one A8 site: the activation quantizer alone, the zero pad of
    # its codes to the packed K (640 -> 768), and the whole site through the
    # dispatch (quantizer, pad, kernel), beside the W4 and Q8 sites', at the
    # qkv shape of a decode step with the engine's baked scales.
    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
    from onnx_quantize_tpu_torch.ops import quantized_matmul
    from onnx_quantize_tpu_torch.ops.kernels import pad_to_multiple
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4a8 import quantize_activation_int8

    x = torch.randn((32, 640), generator=gen, device="cuda").to(torch.bfloat16)
    qkv = {arm: prepare_kernel_scales(params)["layers.0"]["attn"]["_fused_qkv"]["w"]
           for arm, params in (("a8", a8params), ("w4", qparams))}
    q8_q = q8params["layers.0"]["attn"]["q_proj"]["w"]
    x_q, _ = quantize_activation_int8(x)
    calls = {"activation quantizer": lambda: quantize_activation_int8(x),
             "A8 input pad": lambda: pad_to_multiple(x_q, 1, 2 * qkv["a8"].data.shape[0]),
             "A8 qkv site": lambda: quantized_matmul(x, qkv["a8"]),
             "W4 qkv site": lambda: quantized_matmul(x, qkv["w4"]),
             "Q8 q site": lambda: quantized_matmul(x, q8_q)}
    counted = {name: count_graph_nodes(fn) for name, fn in calls.items()}
    print("device operations per call at M=32, K=640, bf16 x (CUDA graph nodes): "
          + ", ".join(f"{k} {n} ({', '.join(kinds)})" for k, (n, kinds) in counted.items()),
          flush=True)
    print("the same calls through torch.profiler, one session each (not gated): "
          + ", ".join(f"{k} {count_launches(fn)[0]}" for k, fn in calls.items()), flush=True)
    for name, (n, _) in counted.items():
        check(n > 0, f"no device operation captured for the {name}")
    a8_parts = counted["activation quantizer"][0] + counted["A8 input pad"][0] + 1
    check(counted["A8 qkv site"][0] == a8_parts,
          f"the A8 qkv site launched {counted['A8 qkv site'][0]} device operations, expected "
          f"the quantizer's, the pad's and one W4A8 kernel ({a8_parts})")
    for arm, params, mega in (("W4+int8 head", qparams, False),
                              ("W4A8+W8A8 head", a8params, False),
                              ("Q8+int8 head", q8params, False),
                              ("W4+int8 head with fused MLP", qparams, True)):
        prof = profile_decode(model, params, mega=mega)
        print(f"decode step profile, {arm} (B=32, int8 KV, torch.profiler, mean of 4 steps) on "
              f"{card}: launches {prof['launches']:.0f}, device busy {prof['busy_ms']:.3f} ms "
              f"(quantized matmul kernels {prof['matmul_ms']:.3f}, Q8 among them "
              f"{prof['q8_ms']:.3f}, the fused MLP among them {prof['mlp_ms']:.3f}, other "
              f"{prof['other_ms']:.3f}), wall {prof['wall_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}", flush=True)
    prof = profile_window(model, qparams)
    print(f"window profile, W4+int8 head (one 2048-token window, torch.profiler) on {card}: "
          f"launches {prof['launches']}, device busy {prof['busy_ms']:.3f} ms (W4 kernels "
          f"{prof['w4_ms']:.3f}, W8 {prof['w8_ms']:.3f}, flash attention "
          f"{prof['flash_attention_ms']:.3f}), wall {prof['wall_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.3f}", flush=True)
    phase_done("8 launch counts")

    # Phase 9: continuous-batching serving at the JAX serving probe's load.
    for key, n in run_serving(model, qparams, a8params, card, rate_q).items():
        launches[key] += n
    phase_done("9 serving")

    # Phase 10: speculative decoding, phase 4's 270M W4 tree drafting for
    # Gemma-3-1B at full width (depth cut).
    for key, n in run_speculative(model, qparams, card).items():
        launches[key] += n
    phase_done("10 speculative decoding")

    # Phase 11: the HF import and the perplexity command line at Gemma-3-270M's
    # width, TransformerLM at GPT-2 small's and BERT at BERT-base's.
    for key, n in run_families(model, qparams, card).items():
        launches[key] += n
    phase_done("11 model families and ways in")

    # Phase 12: tensor, expert, pipeline, context and data parallelism on a
    # world of two ranks sharing the card (gloo), after phase 2's build.
    for key, n in run_parallel(model, qparams, card).items():
        launches[key] += n
    phase_done("12 parallel")

    # Phase 13: the kernel benchmark tool (subprocesses) and the examples (in
    # process, under the launch counters).
    run_tools(kernel_results, card)
    for key, n in run_examples(card).items():
        launches[key] += n
    phase_done("13 tools and examples")

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
