"""Runnable examples: quantize a model and save a checkpoint, serve a
quantized model, quantize a trained classifier.

Each mirrors the script of the same name under the repository's
``examples/``, keeps its flags and adds ``--cpu``; without it the example
runs on the CUDA device::

    python -m onnx_quantize_tpu_torch.examples.gemma3.gemma3_rtn --output qgemma3_rtn
    python -m onnx_quantize_tpu_torch.examples.gemma3.gemma3_awq --output qgemma3_awq
    python -m onnx_quantize_tpu_torch.examples.llama_rtn --output qllama_rtn [--tiny]
    python -m onnx_quantize_tpu_torch.examples.llama_rotate_w4 --output qllama_rot [--gptq]
    python -m onnx_quantize_tpu_torch.examples.moe_rtn --output qmoe_rtn [--tiny]
    python -m onnx_quantize_tpu_torch.examples.serving [--chunk 16] [--requests 32] [--tiny]
    python -m onnx_quantize_tpu_torch.examples.bert.bert_sst2 [--steps 400] [--eval 512]

Each splits into small functions (the model's config, its params, the
QConfig, the run) behind ``main(argv)``: ``--hf-weights DIR`` gives the
weights, and the module's config constant (``GEMMA3_270M``, ``LLAMA32_1B``,
``QWEN15_MOE_A27B``) the shapes. Without ``--hf-weights`` the weights are
drawn from seed 0.
"""

from __future__ import annotations

import argparse

import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.checkpoint import save_checkpoint

__all__ = ["add_cpu_flag", "device_of", "seeded_params", "quantize_and_save"]


def add_cpu_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU, not the CUDA device.")


def device_of(args: argparse.Namespace) -> str:
    return "cpu" if args.cpu else "cuda"


def seeded_params(model, device: str, seed: int = 0) -> dict:
    """The model's params drawn from ``seed`` on ``device``."""
    return model.init(torch.Generator(device=device).manual_seed(seed))


def quantize_and_save(model, params: dict, qconfig, output: str):
    """``quantize`` then ``save_checkpoint``; returns (qparams, plan)."""
    qparams, plan = oqt.quantize(model, params, qconfig)
    save_checkpoint(output, model, qparams, plan)
    return qparams, plan
