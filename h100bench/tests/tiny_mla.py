"""A tiny DeepSeek-V2 configuration and cell for the CPU tests: latent
attention (rank 32, 32 + 16 query/key dims and 32 value dims a head) with
YaRN, a dense first layer, 8 routed experts top-3 with 2 shared, at group
size 32 (even group counts, so the experts take the fused layout), behind
a 64-token shared prefix. The stream is float32, so that the program's
readings are the int8 cache's and not bf16's, which at this width would
hide the controls."""

from __future__ import annotations

import copy
import json
import types

from h100bench.benchlib.cells import BENCH

TINY_MLA = {
    "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 64,
    "num_hidden_layers": 3, "num_attention_heads": 2, "num_key_value_heads": 2,
    "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
    "v_head_dim": 32, "n_routed_experts": 8, "num_experts_per_tok": 3, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False, "routed_scaling_factor": 1,
    "vocab_size": 256, "rope_theta": 10000, "rms_norm_eps": 1e-6, "torch_dtype": "float32",
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "recipe": {"body": {"dtype": "uint4", "group_size": 32,
                        "ignore": ["lm_head", "\\.router$", "\\.kv_b_proj$"]},
               "lm_head": {"dtype": "int8", "symmetric": True}},
}

# Limits of the tiny cell, set as the benchmark's are (PERF.md): above the
# program's readings over seeds (the float32 stream serves the reference's
# own greedy tokens: max_gap and mean_gap 0 on eight seeds), below the
# controls' (over eight requests and up to 256 served tokens: kv4 max_gap
# 0.0021-0.0159, fp8 mean_gap 4.0e-5 to 2.2e-4 on three seeds at windows of
# one and two seconds).
TINY_MLA_LIMITS = {"max_gap": 1e-3, "mean_gap": 1e-5}


def ctx_cell(**over) -> types.SimpleNamespace:
    traffic = json.loads((BENCH / "traffic" / "chat-ctx16k-c64.json").read_text())
    traffic.update(clients=8, prefix={"tokens": 64},
                   prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
                   output={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
                   warmup={"join_clients": 4, "join_tokens": 256, "settle_groups": 1},
                   trace_groups=1, check={"served_tokens": 256, "max_requests": 8})
    traffic["engine"] = dict(traffic["engine"], max_seq=256)
    traffic.update(over)
    return types.SimpleNamespace(config=copy.deepcopy(TINY_MLA), traffic=traffic,
                                 limits=dict(TINY_MLA_LIMITS), name="tiny.ctxchat")
