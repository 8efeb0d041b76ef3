"""Serve a quantized Gemma-3 with continuous batching.

Port of the repository's ``examples/serving.py``: quantize (W4 g128 body,
int8 per-channel lm_head, fused q/k/v and gate/up), build the engine over an
int8 KV cache, and stream a mixed workload (prompts, budgets, greedy and
sampled requests, some ending on an EOS id) through the chunked scheduler.
With ``chunk > 1`` a scheduler round is one ``engine.serve_chunk``: the
admission prefill, per-slot sampling and ``chunk`` decode steps, with one
host fetch per group of ``pipeline`` rounds.

Usage:
    python -m onnx_quantize_tpu_torch.examples.serving [--chunk 16] [--requests 32] [--tiny] \
        [--cpu]

``--tiny`` runs a toy config (CPU-friendly); the default builds Gemma-3-270M
in bfloat16.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine
from onnx_quantize_tpu_torch.engine.sampling import SamplingParams
from onnx_quantize_tpu_torch.examples import add_cpu_flag, device_of, seeded_params
from onnx_quantize_tpu_torch.models.gemma3 import (
    GEMMA3_270M,
    Gemma3,
    Gemma3Config,
    fuse_gemma3_projections,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chunk", type=int, default=16)
    parser.add_argument("--pipeline", type=int, default=8,
                        help="serve rounds dispatched before reading results (hides the "
                             "host round trip behind device work; admissions are planned "
                             "from budgets so freed slots refill mid-group, and the group's "
                             "results come back in one fetch)")
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--max-seq", type=int, default=256)
    parser.add_argument("--tiny", action="store_true")
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config(tiny: bool) -> Gemma3Config:
    if tiny:
        return Gemma3Config.tiny(hidden_size=128, intermediate_size=256, num_layers=2,
                                 num_heads=2, num_kv_heads=1, head_dim=64, vocab_size=512)
    return dataclasses.replace(GEMMA3_270M, dtype="bfloat16")


def build(tiny: bool, device: str):
    """(model, params): seeded weights, W4 g128 body, int8 per-channel
    symmetric lm_head, fused projections."""
    model = Gemma3(config(tiny))
    params = seeded_params(model, device)
    body = oqt.QConfig(weights=oqt.QWeightArgs(dtype="uint4", group_size=32 if tiny else 128),
                       ignore=["lm_head"])
    params, _ = oqt.quantize(model, params, body)
    head = oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=-1, symmetric=True),
                       ignore=[r"^layers\."])
    params, _ = oqt.quantize(model, params, head)
    return model, fuse_gemma3_projections(params)


def workload(vocab_size: int, requests: int) -> list[tuple[list[int], dict]]:
    """(prompt, submit keywords) per request, drawn from ``default_rng(0)``:
    prompts of 8-63 ids, budgets of 16-47; every third request greedy, the
    others sampled (temperature 0.7, top-k 40, top-p 0.95); the even ones end
    on one drawn EOS id."""
    rng = np.random.default_rng(0)
    eos = int(rng.integers(1, vocab_size))
    out = []
    for i in range(requests):
        prompt = [int(t) for t in rng.integers(1, vocab_size, size=int(rng.integers(8, 64)))]
        out.append((prompt, dict(
            max_new_tokens=int(rng.integers(16, 48)),
            sampling=(SamplingParams() if i % 3 == 0 else
                      SamplingParams(temperature=0.7, top_k=40, top_p=0.95)),
            eos_token_id=eos if i % 2 == 0 else None)))
    return out


def run(model, params: dict, args: argparse.Namespace):
    """Serve the workload; returns (the finished requests, the scheduler's
    stats)."""
    engine = InferenceEngine(model, params, max_batch=args.slots, max_seq=args.max_seq,
                             kv_quant=True, dtype=model.cfg.torch_dtype)
    sched = ContinuousBatchingScheduler(engine, chunk=args.chunk, pipeline=args.pipeline)
    for prompt, kwargs in workload(model.cfg.vocab_size, args.requests):
        sched.submit(prompt, **kwargs)
    t0 = time.perf_counter()
    finished = sched.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    generated = sum(len(r.output) for r in finished)
    print(f"{len(finished)} requests, {generated} tokens in {wall:.2f}s "
          f"({generated / wall:.0f} tok/s on {engine.device.type}, with the kernels' build "
          "on first use)")
    for r in finished[:3]:
        print(f"  request {r.request_id}: {len(r.output)} tokens, first 8: {r.output[:8]}")
    return finished, sched.stats


def main(argv=None):
    """Returns (the finished requests, the scheduler's stats)."""
    args = parse_args(argv)
    model, params = build(args.tiny, device_of(args))
    return run(model, params, args)


if __name__ == "__main__":
    main()
