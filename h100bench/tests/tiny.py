"""A tiny MoE configuration and cells for the CPU tests: Qwen1.5-MoE's
structure (q/k/v biases, a gated shared expert, no top-k renormalization)
at head_dim 128 (flash decode's width) and group size 32 (even group
counts, so the experts take the fused layout)."""

from __future__ import annotations

import copy
import json
import time
import types
from pathlib import Path

from h100bench.benchlib import trace as tr
from h100bench.benchlib.cells import BENCH, _module
from h100bench.benchlib.outcome import Context

TINY = {
    "hidden_size": 64, "intermediate_size": 128, "moe_intermediate_size": 128,
    "shared_expert_intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 2, "head_dim": 128, "num_experts": 4, "num_experts_per_tok": 2,
    "norm_topk_prob": False, "vocab_size": 256, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
    "qkv_bias": True, "torch_dtype": "bfloat16", "tie_word_embeddings": False,
    "recipe": {"body": {"dtype": "uint4", "group_size": 32,
                        "ignore": ["lm_head", "\\.router$", "\\.shared_gate$"]},
               "lm_head": {"dtype": "int8", "symmetric": True}, "kv_cache": "int8"},
}

# Limits of the tiny cell, set as the benchmark's are (PERF.md): above the
# program's readings over seeds (max_gap at most 0.0032, mean_gap 3.1e-5 on
# six seeds), below the controls' (kv4 max_gap at least 0.0178, fp8
# mean_gap 1.3e-4).
TINY_LIMITS = {"max_gap": 0.004, "mean_gap": 7e-5}


def chat_cell(**over) -> types.SimpleNamespace:
    traffic = json.loads((BENCH / "traffic" / "chat-conv-c64.json").read_text())
    traffic.update(clients=8, prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
                   output={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
                   warmup={"join_clients": 4, "join_tokens": 256, "settle_groups": 1}, trace_groups=1,
                   check={"served_tokens": 96, "max_requests": 4})
    traffic["engine"] = dict(traffic["engine"], max_seq=256)
    traffic.update(over)
    return types.SimpleNamespace(config=copy.deepcopy(TINY), traffic=traffic,
                                 limits=dict(TINY_LIMITS), name="tiny.chat")


def driver(kind: str):
    return _module(Path(BENCH / "drivers" / f"{kind}.py"), f"h100bench_test_driver_{kind}")


def host_traced(fn):
    """A stand-in for ``trace.traced`` on the CPU: no device timeline, so
    the reading holds the host window only."""
    t0 = time.perf_counter()
    out = fn()
    return out, tr.TraceReading(window_s=time.perf_counter() - t0, kernels=[], host=[])


def run(kind: str, cell, seed: int, seconds: float = 1.5, trace: bool = False, fault=None,
        controls=(), device: str = "cpu"):
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=time.monotonic(), fault=fault, controls=controls)
    return driver(kind).run(ctx)
