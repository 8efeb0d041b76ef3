"""Token sampling: greedy, temperature, top-k, top-p; scalar and per-row.

Counterpart of ``onnx_quantize_tpu/engine/sampling.py``. ``sample`` applies
one SamplingParams to the whole batch. ``sample_batch`` is the serving
path's sampler: per-row parameter tensors, so requests with different
settings sample in one round. Logits are cast to float32 first, so a bf16
stream never changes the argmax or the top-p cutoff. Random draws come from a
``torch.Generator``; they differ from JAX's random streams, so only the
greedy path and the masks are held to the JAX package. Every draw is
Gumbel-max, one uniform per position of the (B, V) matrix, as JAX's
``categorical``: a row's noise depends on its position in the batch only. A
``window`` (rows, batch) draws the noise of the whole (batch, V) matrix and
keeps ``rows``, so a data rank of a mesh engine samples its rows as one
device samples them in the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "sample", "sample_batch", "batch_sampling_arrays", "gumbel_argmax"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams, window: tuple[slice, int] | None = None) -> torch.Tensor:
    """Next tokens (B,) int32 from (B, V) logits."""
    logits = logits.to(torch.float32)
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return gumbel_argmax(_masked_logits(logits, params), generator, window).to(torch.int32)


def _masked_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """float32 (B, V) logits over the temperature, -inf outside the top-k and
    outside the top-p nucleus."""
    logits = logits / params.temperature
    if params.top_k > 0:
        # A top_k past the vocabulary keeps every logit: the reference's
        # index into the sorted row clamps to its smallest entry.
        kth = torch.topk(logits, min(params.top_k, logits.shape[-1]), dim=-1).values[:, -1:]
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


def batch_sampling_arrays(params_list: list[SamplingParams]):
    """Pack per-slot SamplingParams into host (temps, top_ks, top_ps) arrays
    plus the static variant flags ``(need_temp, need_topk, need_topp)``.

    The flags gate whole blocks of ``sample_batch``, so an all-greedy batch
    runs a bare argmax: top-k and top-p sort a (B, V) matrix, which a round
    should not pay blind."""
    temps = np.array([p.temperature for p in params_list], np.float32)
    top_ks = np.array([p.top_k for p in params_list], np.int32)
    top_ps = np.array([p.top_p for p in params_list], np.float32)
    sampled = temps > 0
    variant = (
        bool(sampled.any()),
        bool((sampled & (top_ks > 0)).any()),
        bool((sampled & (top_ps < 1.0)).any()),
    )
    return (temps, top_ks, top_ps), variant


def sample_batch(logits: torch.Tensor, generator: torch.Generator | None,
                 temps: torch.Tensor, top_ks: torch.Tensor, top_ps: torch.Tensor, *,
                 need_temp: bool = True, need_topk: bool = True,
                 need_topp: bool = True,
                 window: tuple[slice, int] | None = None) -> torch.Tensor:
    """Per-row sampling from (B, V) logits; returns (B,) int64 on the device.

    ``temps`` (B,) float32 (<= 0: a greedy row), ``top_ks`` (B,) int32 (0:
    off), ``top_ps`` (B,) float32 (>= 1: off), on the logits' device. Rows
    with a feature off take no mask from it, so one call serves a mixed
    batch. The draw is Gumbel-max over the whole (B, V) matrix, one uniform
    per position from ``generator``, as JAX's ``categorical`` draws: a row's
    noise depends on its position in the batch and not on the other rows'
    logits, and nothing waits on the host.
    """
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    if not need_temp:
        return greedy
    x = _masked_rows(logits, temps, top_ks, top_ps, need_topk, need_topp)
    return torch.where(temps <= 0.0, greedy, gumbel_argmax(x, generator, window))


def gumbel_argmax(x: torch.Tensor, generator: torch.Generator | None,
                  window: tuple[slice, int] | None = None) -> torch.Tensor:
    """One categorical draw per row of float32 (B, V) logits: Gumbel-max,
    one uniform per position from ``generator``; (B,) int64. With ``window``
    = (rows, batch), ``x`` holds ``rows`` of a (batch, V) matrix: the whole
    matrix's uniforms are drawn and the rows' kept."""
    if window is None:
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    else:
        rows, batch = window
        u = torch.rand((batch, x.shape[-1]), generator=generator, device=x.device,
                       dtype=torch.float32)[rows]
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


def _masked_rows(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                 top_ps: torch.Tensor, need_topk: bool, need_topp: bool) -> torch.Tensor:
    """float32 (B, V) logits over each row's temperature, -inf outside the
    row's top-k and outside its top-p nucleus."""
    x = logits / temps.clamp(min=1e-6)[:, None]
    sorted_desc = None
    if need_topk or need_topp:
        sorted_desc = torch.sort(x, dim=-1, descending=True).values
    V = x.shape[-1]
    if need_topk:
        idx = (top_ks.to(torch.int64) - 1).clamp(0, V - 1)
        kth = torch.gather(sorted_desc, -1, idx[:, None])
        on = (top_ks > 0)[:, None]
        x = torch.where(on & (x < kth), float("-inf"), x)
        # The masked entries are the sorted tail below the kth value, so the
        # masked descending sort needs no second sort.
        sorted_desc = torch.where(on & (sorted_desc < kth), float("-inf"), sorted_desc)
    if need_topp:
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # Clamped as in _masked_logits: a row whose float32 mass ends below
        # top_p keeps every finite logit.
        cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1, keepdim=True).clamp(max=V - 1)
        cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
        x = torch.where((top_ps < 1.0)[:, None] & (x < cutoff), float("-inf"), x)
    return x
