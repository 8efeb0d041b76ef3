"""Quantize Gemma-3-270M with RTN int8 group-128, lm_head ignored.

Port of the repository's ``examples/gemma3/gemma3_rtn.py``: load (or draw
from seed 0) the Gemma-3 params, run ``quantize()`` and save a checkpoint
the engine serves.

Usage:
    python -m onnx_quantize_tpu_torch.examples.gemma3.gemma3_rtn --output qgemma3_rtn \
        [--hf-weights DIR] [--cpu]
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
from onnx_quantize_tpu_torch.models.gemma3 import GEMMA3_270M, Gemma3


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output", default="qgemma3_rtn")
    parser.add_argument(
        "--hf-weights", default=None,
        help="Directory with HF safetensors for google/gemma-3-270m; seeded init if omitted.",
    )
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config():
    return GEMMA3_270M


def load_params(model, args: argparse.Namespace) -> dict:
    if args.hf_weights:
        from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf

        return load_gemma3_hf(model, args.hf_weights, device=device_of(args))
    return seeded_params(model, device_of(args))


def qconfig() -> oqt.QConfig:
    return oqt.QConfig(weights=oqt.QWeightArgs(dtype="int8", group_size=128),
                       ignore=["lm_head"])


def main(argv=None):
    """Returns (quantized params, plan)."""
    args = parse_args(argv)
    model = Gemma3(config())
    out = quantize_and_save(model, load_params(model, args), qconfig(), args.output)
    print(f"saved quantized checkpoint to {args.output}")
    return out


if __name__ == "__main__":
    main()
