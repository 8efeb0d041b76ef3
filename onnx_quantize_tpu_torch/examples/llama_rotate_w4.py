"""W4 Llama with the rotation pre-pass: low-bit quantization that outliers
do not break.

Port of the repository's ``examples/llama_rotate_w4.py``, the QuaRot recipe:
fold a randomized-Hadamard basis change into the weights first (the logits
are unchanged and it costs nothing at run time, ``prepasses/rotate.py``),
then RTN-quantize to 4 bits, or GPTQ in the rotated basis with ``--gptq``.
Works on pre-norm models (Llama, Qwen, Mixtral).

Usage:
    python -m onnx_quantize_tpu_torch.examples.llama_rotate_w4 --output qllama_rot \
        [--hf-weights DIR] [--tiny] [--gptq] [--calib-tokens tokens.npy] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.examples import add_cpu_flag, quantize_and_save
from onnx_quantize_tpu_torch.examples.llama_rtn import load_params
from onnx_quantize_tpu_torch.models.llama import LLAMA32_1B, Llama, tiny_llama_config


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output", default="qllama_rot")
    parser.add_argument(
        "--hf-weights", default=None,
        help="Directory with HF safetensors; seeded init if omitted.",
    )
    parser.add_argument("--tiny", action="store_true",
                        help="Toy config (CPU-friendly smoke run).")
    parser.add_argument("--gptq", action="store_true",
                        help="Run GPTQ (in the rotated basis) instead of RTN.")
    parser.add_argument("--calib-tokens", default=None,
                        help=".npy token array for GPTQ calibration.")
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config(tiny: bool):
    return tiny_llama_config() if tiny else LLAMA32_1B


def qconfig(gptq: bool, calib: np.ndarray | None) -> oqt.QConfig:
    weights = oqt.QWeightArgs(dtype="uint4", group_size=128,
                              **({"algorithm": oqt.GPTQConfig()} if gptq else {}))
    return oqt.QConfig(
        weights=weights,
        preprocessors=[oqt.RotateConfig(mode="hadamard", seed=0)],
        calibration_data=calib,
        ignore=["lm_head"],
    )


def calibration_ids(args: argparse.Namespace, vocab_size: int) -> np.ndarray | None:
    """GPTQ's calibration rows: the ``--calib-tokens`` array, or 8 x 128 ids
    drawn from ``default_rng(0)``; RTN needs none."""
    if not args.gptq:
        return None
    if args.calib_tokens:
        return np.load(args.calib_tokens)
    return np.random.default_rng(0).integers(1, vocab_size, size=(8, 128)).astype(np.int32)


def main(argv=None):
    """Returns (quantized params, plan)."""
    args = parse_args(argv)
    model = Llama(config(args.tiny))
    calib = calibration_ids(args, model.cfg.vocab_size)
    out = quantize_and_save(model, load_params(model, args), qconfig(args.gptq, calib),
                            args.output)
    print(f"saved rotated {'GPTQ' if args.gptq else 'RTN'} uint4 checkpoint to {args.output}")
    return out


if __name__ == "__main__":
    main()
