"""Token sampling: greedy, temperature, top-k, top-p.

Counterpart of ``sample`` in ``onnx_quantize_tpu/engine/sampling.py``. Logits
are cast to float32 first, so a bf16 stream never changes the argmax or the
top-p cutoff. Random draws come from a ``torch.Generator``; they differ from
JAX's random streams, so only the greedy path is held to the JAX package.
The per-row serving sampler waits with the scheduler (ROADMAP.md, Queue A
item 9).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingParams", "sample"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams) -> torch.Tensor:
    """Next tokens (B,) int32 from (B, V) logits."""
    logits = logits.to(torch.float32)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(_masked_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _masked_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """float32 (B, V) logits over the temperature, -inf outside the top-k and
    outside the top-p nucleus."""
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest prefix with cumulative mass >= top_p. When the
        # float32 mass ends below top_p the count reaches V: the clamp makes
        # the cutoff the row's smallest logit, which masks nothing, as the
        # reference's out-of-range gather (NaN) does.
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits
