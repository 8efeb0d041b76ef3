"""Quantize a Llama-3.2 model with RTN int8 group-128, lm_head ignored.

Port of the repository's ``examples/llama_rtn.py``: the Gemma-3 example's
recipe on the Llama family, which shares the decoder, the kernels and the
engine (``models/llama.py``).

Usage:
    python -m onnx_quantize_tpu_torch.examples.llama_rtn --output qllama_rtn \
        [--hf-weights DIR] [--tiny] [--cpu]
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
from onnx_quantize_tpu_torch.models.llama import (
    LLAMA32_1B,
    Llama,
    load_llama_hf,
    tiny_llama_config,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output", default="qllama_rtn")
    parser.add_argument(
        "--hf-weights", default=None,
        help="Directory with HF safetensors for meta-llama/Llama-3.2-1B; seeded init if "
             "omitted.",
    )
    parser.add_argument("--tiny", action="store_true",
                        help="Toy config (CPU-friendly smoke run).")
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config(tiny: bool):
    return tiny_llama_config() if tiny else LLAMA32_1B


def load_params(model, args: argparse.Namespace) -> dict:
    if args.hf_weights:
        return load_llama_hf(model, args.hf_weights, device=device_of(args))
    return seeded_params(model, device_of(args))


def qconfig() -> oqt.QConfig:
    return oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=128),
                       ignore=["lm_head"])


def main(argv=None):
    """Returns (quantized params, plan)."""
    args = parse_args(argv)
    model = Llama(config(args.tiny))
    out = quantize_and_save(model, load_params(model, args), qconfig(), args.output)
    print(f"saved quantized checkpoint to {args.output}")
    return out


if __name__ == "__main__":
    main()
