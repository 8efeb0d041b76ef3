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
``datasets``, imported only when used). The command-line entry point waits
for the checkpoint loader and the Hugging Face importer (ROADMAP.md, Queue A
items 10 and 11).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["perplexity_eval", "perplexity_from_tokens", "load_wikitext_tokens"]


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
                           stride: int = 512, mesh=None) -> float:
    """Sliding-window perplexity of a causal LM over a token stream, on the
    device that holds ``params``. ``mesh`` (context-parallel scoring) is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "context-parallel scoring (mesh=) is not ported yet; see ROADMAP.md, "
            "Queue A item 14"
        )
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
        logits = model(params, ids)[0, : n - 1]
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
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_id)
        with open(text_path) as f:
            input_ids = tokenizer(f.read(), return_tensors="np").input_ids[0]
    else:
        input_ids = load_wikitext_tokens(model_id)
    return perplexity_from_tokens(model, params, input_ids, max_length, stride, mesh=mesh)
