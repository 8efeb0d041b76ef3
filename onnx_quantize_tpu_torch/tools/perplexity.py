"""Sliding-window perplexity evaluation (the Hugging Face method).

Counterpart of ``onnx_quantize_tpu/tools/perplexity.py``: window
``max_length=2048`` advanced by ``stride=512``, log-softmax over shifted
logits, counting only the newly revealed tokens of each window, and
``ppl = exp(total_nll / tokens)``. Each window is one full-sequence forward
with no cache, padded to ``max_length`` so every window has one shape; at
T >= 512 on a CUDA device that forward runs the flash-attention kernel.

The log-softmax and the NLL gather run in float32 on the model's device, so
only one NLL sum per window stays there and a single number crosses to the
host at the end, never the (max_length, vocab) logits.

Token sources: a pre-tokenized ``.npy`` array, a text file with a tokenizer,
or the wikitext-2 test split (the last two need ``transformers`` or
``datasets``, imported only when used).

Command line (on the CUDA device unless ``--cpu``)::

    python -m onnx_quantize_tpu_torch.tools.perplexity --hf-weights DIR --tokens T.npy
    python -m onnx_quantize_tpu_torch.tools.perplexity --checkpoint CKPT --tokens T.npy

``--hf-weights`` scores the float32 Gemma-3-270M from a local HF safetensors
directory; ``--checkpoint`` a framework checkpoint (``checkpoint.py``), such
as a quantized tree. ``--text`` tokenizes a text file with the tokenizer of
``--model-id`` (a local path: nothing is downloaded). It prints
``perplexity: X.XXXX``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["perplexity_eval", "perplexity_from_tokens", "load_wikitext_tokens", "main"]


def load_wikitext_tokens(model_id: str | None = None, tokenizer=None) -> np.ndarray:
    """Tokenize the wikitext-2-raw test split (needs a datasets cache)."""
    from datasets import load_dataset  # gated import: optional dependency

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_id)
    text = "\n\n".join(load_dataset("wikitext", "wikitext-2-raw-v1", split="test")["text"])
    return tokenizer(text, return_tensors="np").input_ids[0]


@torch.inference_mode()
def perplexity_from_tokens(model, params, input_ids, max_length: int = 2048,
                           stride: int = 512, mesh=None, cp_mode: str = "ring") -> float:
    """Sliding-window perplexity of a causal LM over a token stream, on the
    device that holds ``params``.

    ``mesh``: a context-parallel mesh (``parallel.cp.make_cp_mesh``, its first
    axis the sequence): every rank calls with the same stream, each window's
    tokens are split over the ranks and scored with ring attention
    (``cp_mode`` "ring") or gathered K/V ("gather"), zigzag where
    ``max_length`` allows it; the windowing and NLL are unchanged, and every
    rank returns the same perplexity."""
    if mesh is not None:
        from onnx_quantize_tpu_torch.parallel.cp import make_cp_forward

        axis = mesh.axis_names[0]
        shards = mesh.shape[axis]
        layout = "zigzag" if max_length % (2 * shards) == 0 else "contiguous"
        forward = make_cp_forward(model, mesh, max_length, axis=axis, mode=cp_mode,
                                  layout=layout)
    else:
        forward = model
    device = params["embed"]["w"].device
    input_ids = np.asarray(input_ids)
    seq_len = len(input_ids)
    total_nll = torch.zeros((), dtype=torch.float64, device=device)
    total_tokens = 0
    prev_end = 0
    for begin in range(0, seq_len, stride):
        end = min(begin + max_length, seq_len)
        trg_len = end - prev_end
        n = end - begin
        # Pad to max_length so every window has one shape; the pad sits past
        # `end` and is never counted (causal attention keeps it out).
        window = np.zeros((1, max_length), np.int64)
        window[0, :n] = input_ids[begin:end]
        ids = torch.from_numpy(window).to(device)
        logits = forward(params, ids)[0, : n - 1]
        log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
        targets = ids[0, 1:n]
        nll = -torch.gather(log_probs[-trg_len:], 1, targets[-trg_len:, None])[:, 0]
        total_nll += nll.sum().to(torch.float64)
        total_tokens += nll.shape[0]
        prev_end = end
        if end == seq_len:
            break
    return float(torch.exp(total_nll / total_tokens))


def perplexity_eval(model, params, model_id: str | None = None, tokens_path: str | None = None,
                    text_path: str | None = None, max_length: int = 2048, stride: int = 512,
                    mesh=None) -> float:
    """Resolve a token stream (.npy / text file / dataset) and evaluate."""
    if tokens_path is not None:
        input_ids = np.load(tokens_path)
    elif text_path is not None:
        try:
            from transformers import AutoTokenizer
        except ImportError as exc:
            raise ImportError("--text needs the transformers package for its tokenizer; "
                              "pass a pre-tokenized --tokens .npy file instead") from exc

        tokenizer = AutoTokenizer.from_pretrained(model_id, local_files_only=True)
        with open(text_path) as f:
            input_ids = tokenizer(f.read(), return_tensors="np").input_ids[0]
    else:
        input_ids = load_wikitext_tokens(model_id)
    return perplexity_from_tokens(model, params, input_ids, max_length, stride, mesh=mesh)


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint", help="Path to a framework checkpoint (checkpoint.py).")
    source.add_argument("--hf-weights",
                        help="HF safetensors dir for google/gemma-3-270m: score the float32 "
                             "model without a checkpoint.")
    parser.add_argument("--model-id", default="google/gemma-3-270m",
                        help="Local tokenizer path for --text.")
    parser.add_argument("--tokens", default=None, help="Pre-tokenized .npy file.")
    parser.add_argument("--text", default=None, help="Raw text file to tokenize.")
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--stride", type=int, default=512)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU, not the CUDA device.")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    if args.hf_weights:
        from onnx_quantize_tpu_torch.models.gemma3 import GEMMA3_270M, Gemma3
        from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf

        model = Gemma3(GEMMA3_270M)
        params = load_gemma3_hf(model, args.hf_weights, device=device)
    else:
        from onnx_quantize_tpu_torch.checkpoint import load_checkpoint

        model, params = load_checkpoint(args.checkpoint, device=device)
    ppl = perplexity_eval(model, params, model_id=args.model_id, tokens_path=args.tokens,
                          text_path=args.text, max_length=args.max_length, stride=args.stride)
    print(f"perplexity: {ppl:.4f}")
    return ppl


if __name__ == "__main__":
    main()
