"""Quantize Gemma-3-270M with AWQ uint4 group-128 using calibration tokens.

Port of the repository's ``examples/gemma3/gemma3_awq.py``: 32 calibration
rows of 256 token ids (a pre-tokenized ``.npy`` stream, or ids drawn from
``default_rng(0)``) drive the AWQ scale search before 4-bit RTN.

Usage:
    python -m onnx_quantize_tpu_torch.examples.gemma3.gemma3_awq --output qgemma3_awq \
        [--hf-weights DIR] [--calib-tokens tokens.npy] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.examples import add_cpu_flag, quantize_and_save
from onnx_quantize_tpu_torch.examples.gemma3.gemma3_rtn import load_params
from onnx_quantize_tpu_torch.models.gemma3 import GEMMA3_270M, Gemma3


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output", default="qgemma3_awq")
    parser.add_argument("--hf-weights", default=None)
    parser.add_argument("--calib-tokens", default=None,
                        help="Pre-tokenized wikitext .npy for calibration.")
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config():
    return GEMMA3_270M


def calibration_ids(calib_tokens: str | None, vocab_size: int, num_samples: int = 32,
                    seq_len: int = 256) -> np.ndarray:
    if calib_tokens:
        tokens = np.load(calib_tokens)
        usable = (len(tokens) // seq_len) * seq_len
        return tokens[:usable].reshape(-1, seq_len)[:num_samples].astype(np.int32)
    rng = np.random.default_rng(0)
    return rng.integers(1, min(vocab_size, 100), size=(num_samples, seq_len)).astype(np.int32)


def qconfig(calib: np.ndarray) -> oqt.QConfig:
    return oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=128),
        preprocessors=[oqt.AwqConfig()],
        ignore=["lm_head"],
        calibration_data=calib,
        calibration_params=oqt.CalibrationParams(num_samples=len(calib), batch_size=4),
    )


def main(argv=None):
    """Returns (quantized params, plan)."""
    args = parse_args(argv)
    model = Gemma3(config())
    calib = calibration_ids(args.calib_tokens, model.cfg.vocab_size)
    out = quantize_and_save(model, load_params(model, args), qconfig(calib), args.output)
    print(f"saved quantized checkpoint to {args.output}")
    return out


if __name__ == "__main__":
    main()
