"""Quantize an MoE model (the Mixtral and Qwen-MoE family) with RTN uint4
group-128.

Port of the repository's ``examples/moe_rtn.py``. An MoE model is a model
with E times more Linear sites (each expert's gate, up and down, and a small
router), so the standard recipe carries over: W4 g128 on every expert
projection, the router, the shared expert's gate and the lm_head left in
float (the router decides the routing and holds ~0.01% of the bytes).

Usage:
    python -m onnx_quantize_tpu_torch.examples.moe_rtn --output qmoe_rtn \
        [--hf-weights DIR] [--tiny] [--cpu]
    # --hf-weights: a local Qwen1.5-MoE-A2.7B safetensors directory
"""

from __future__ import annotations

import argparse

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.examples import (
    add_cpu_flag,
    device_of,
    quantize_and_save,
    seeded_params,
)
from onnx_quantize_tpu_torch.models.moe import (
    QWEN15_MOE_A27B,
    MoE,
    load_qwen_moe_hf,
    tiny_moe_config,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output", default="qmoe_rtn")
    parser.add_argument(
        "--hf-weights", default=None,
        help="Directory with HF safetensors for Qwen/Qwen1.5-MoE-A2.7B; seeded init if "
             "omitted.",
    )
    parser.add_argument("--tiny", action="store_true",
                        help="Toy config (CPU-friendly smoke run).")
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config(tiny: bool):
    return tiny_moe_config(moe_intermediate_size=128) if tiny else QWEN15_MOE_A27B


def load_params(model, args: argparse.Namespace) -> dict:
    if args.hf_weights:
        return load_qwen_moe_hf(model, args.hf_weights, device=device_of(args))
    return seeded_params(model, device_of(args))


def qconfig(tiny: bool) -> oqt.QConfig:
    return oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=16 if tiny else 128),
        ignore=["lm_head", r"\.router$", r"\.shared_gate$"],
    )


def main(argv=None):
    """Returns (quantized params, plan)."""
    args = parse_args(argv)
    model = MoE(config(args.tiny))
    out = quantize_and_save(model, load_params(model, args), qconfig(args.tiny), args.output)
    print(f"saved quantized checkpoint to {args.output}")
    print("engine layout: fuse_gemma3_projections + stack_moe_experts at load")
    return out


if __name__ == "__main__":
    main()
