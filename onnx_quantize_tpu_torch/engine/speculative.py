"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``onnx_quantize_tpu/engine/speculative.py``. At small batch a
decode step is bound by reading the weights, so verifying ``k`` drafted
tokens in ONE target forward reads the target's weights once instead of
``k`` times. The draft (a smaller or lower-bit family member, e.g. a
quantized Gemma-3-270M drafting for 1B) runs ``k`` one-token steps; the
target then scores all ``k + 1`` positions in a single (B, k+1) forward at
each row's length and keeps the longest matching prefix plus its own next
token.

Greedy decoding emits the target-only greedy stream token for token,
whatever the draft (a bad draft only costs speed); sampled decoding
(:func:`sampled_accept`) emits a stream whose distribution is target-only
sampling's.

* Rollback is free: rejected positions' K/V rows stay stale in the cache,
  where ``kv_positions`` (slot >= lengths) masks them until the next rounds
  overwrite them, so an undo is one per-row lengths assignment.
* Every row accepts its own prefix length, with per-row EOS, budget and
  capacity freezes, as ``InferenceEngine.serve_chunk`` does.
* Acceptance is capped at ``k - 1`` drafts a round, so the draft cache never
  falls behind the target's: each round emits 1..k tokens.

Where the JAX package runs all rounds in one ``lax.scan``, the port runs them
as an eager loop over device tensors with no host sync inside it, and
:meth:`SpeculativeDecoder.decode` returns the rounds' packed blob on the
device: :meth:`SpeculativeDecoder.generate` fetches it once a call.
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_quantize_tpu_torch._logging import get_logger
from onnx_quantize_tpu_torch.engine.engine import _FAR, InferenceEngine
from onnx_quantize_tpu_torch.engine.kv_cache import read_kv, read_kv_quantized, write_kv_window
from onnx_quantize_tpu_torch.engine.sampling import (
    SamplingParams,
    gumbel_argmax,
    sample,
    sample_batch,
)

logger = get_logger(__name__)

__all__ = ["SpeculativeDecoder", "sampled_accept", "accept_core"]


def accept_core(p_logits: torch.Tensor, q_logits: torch.Tensor, drafts: torch.Tensor,
                temps: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rejection scheme's arithmetic, given its accept draws ``u`` (B, kp)
    in [0, 1): returns (``n`` (B,) accepted drafts, the residual distribution
    (B, V) that the final token is drawn from).

    Draft ``i`` is accepted when ``u[:, i] < min(1, p(d_i) / q(d_i))``, and
    ``n`` counts the accepted prefix. The residual is ``relu(p - q)`` at
    position ``n`` (unnormalized), or ``p`` at position kp when every draft
    accepts, or ``p`` where the residual is numerically empty."""
    B, kp, V = q_logits.shape
    t = temps.to(torch.float32).clamp(min=1e-6)[:, None, None]
    logp = torch.log_softmax(p_logits.to(torch.float32) / t, dim=-1)
    logq = torch.log_softmax(q_logits.to(torch.float32) / t, dim=-1)
    d = drafts.to(torch.int64)[..., None]
    lp = torch.gather(logp[:, :kp], -1, d)[..., 0]
    lq = torch.gather(logq, -1, d)[..., 0]
    accept = u < torch.exp(torch.clamp(lp - lq, max=0.0))
    n = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # 0..kp
    at_n = n.to(torch.int64)[:, None, None].expand(B, 1, V)
    p_n = torch.gather(torch.exp(logp), 1, at_n)[:, 0]
    q_pad = torch.cat([torch.exp(logq), logq.new_zeros((B, 1, V))], dim=1)
    q_n = torch.gather(q_pad, 1, at_n)[:, 0]
    resid = torch.where((n == kp)[:, None], p_n, torch.clamp(p_n - q_n, min=0.0))
    mass = resid.sum(dim=-1, keepdim=True)
    return n.to(torch.int32), torch.where(mass > 1e-9, resid, p_n)


def sampled_accept(p_logits: torch.Tensor, q_logits: torch.Tensor, drafts: torch.Tensor,
                   temps: torch.Tensor, generator: torch.Generator | None):
    """Speculative-sampling acceptance (the rejection scheme of Leviathan et
    al. and Chen et al., 2023).

    ``p_logits`` (B, kp+1, V): the target's logits at the kp verified
    positions plus the bonus position; ``q_logits`` (B, kp, V): the draft's
    logits at its kp sampling steps; ``drafts`` (B, kp): the tokens the draft
    sampled; ``temps`` (B,) > 0: temperatures, applied alike to both models.
    ``generator`` supplies the accept draws and the final token's draw. At
    the first rejection the token is drawn from the residual
    ``norm(relu(p - q))``; when every draft accepts, the bonus token from
    ``p`` at position kp (:func:`accept_core`). Returns ``(tokens (B, kp+1),
    n (B,))``: ``n`` accepted drafts in ``tokens[:, :n]`` and the final token
    at column ``n``. The emitted stream's marginal distribution is
    target-only sampling's, for any draft."""
    B, kp = drafts.shape
    u = torch.rand((B, kp), generator=generator, device=drafts.device, dtype=torch.float32)
    n, resid = accept_core(p_logits, q_logits, drafts, temps, u)
    final = gumbel_argmax(torch.log(resid + 1e-30), generator)
    cols = torch.arange(kp + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts.to(torch.int64), drafts.new_zeros((B, 1), dtype=torch.int64)],
                           dim=1)
    n64 = n.to(torch.int64)[:, None]
    tokens = torch.where(cols == n64, final[:, None],
                         torch.where(cols < n64, drafts_pad, 0))
    return tokens, n


class SpeculativeDecoder:
    """Speculative decoding over a (target, draft) engine pair, greedy or
    sampled."""

    def __init__(self, target: InferenceEngine, draft: InferenceEngine, k: int = 4):
        if target.max_batch != draft.max_batch or target.max_seq != draft.max_seq:
            raise ValueError(
                "target and draft engines must share max_batch/max_seq "
                f"(got {target.max_batch}/{target.max_seq} vs "
                f"{draft.max_batch}/{draft.max_seq})")
        if target.mesh is not None or draft.mesh is not None:
            raise NotImplementedError("speculative decoding is single-chip for now")
        if k < 2:
            raise ValueError(f"k must be >= 2 (the acceptance cap is k - 1), got {k}")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device} and draft on {draft.device}")
        self.target = target
        self.draft = draft
        self.k = k
        # generate's host-side counts: rounds run, (prompt, round) pairs that
        # emitted, and the tokens they emitted (emitted / live_rounds is the
        # mean a live round emits: 1 with no draft accepted, k at most).
        self.stats = {"rounds": 0, "live_rounds": 0, "emitted": 0}

    # -- the rounds, on the device -----------------------------------------

    def _verify(self, cache: dict, ids: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """The target over ``ids`` (B, k+1) appended at each row's length, its
        K/V written through :func:`write_kv_window` (rows not ``act`` keep
        theirs); returns logits (B, k+1, V). Lengths are not advanced here:
        the acceptance assigns them."""
        eng = self.target
        B, T = ids.shape
        L = cache["lengths"]
        positions = L[:, None] + torch.arange(T, dtype=torch.int32, device=eng.device)[None, :]
        positions = torch.where(act[:, None], positions, eng.max_seq)
        slot = torch.arange(eng.max_seq, dtype=torch.int32, device=eng.device)[None, :]
        visible = (L + T * act.to(torch.int32))[:, None]
        kv_positions = torch.where(slot < visible, slot, _FAR)

        def kv_write(layer, k, v):
            write_kv_window(cache, layer, k, v, L, act)
            if eng.cache_cfg.quantized:
                return read_kv_quantized(cache, layer)
            return read_kv(cache, layer, dtype=eng.dtype)

        # An MoE target's experts stay dense-masked: its ragged path fetches
        # each layer's group sizes to the host.
        with eng._without_auto_ragged():
            return eng._forward(cache, ids, positions, kv_positions, None, kv_write=kv_write)

    @torch.inference_mode()
    def _rounds(self, tgt_cache: dict, dft_cache: dict, toks: torch.Tensor,
                budgets: torch.Tensor, eos: torch.Tensor, temps: torch.Tensor | None,
                generator: torch.Generator | None, rounds: int) -> torch.Tensor:
        """``rounds`` speculative rounds over device tensors, with no host sync:
        returns the blob (B, rounds, k+3) int32 on the device."""
        k, max_seq = self.k, self.target.max_seq
        sampled = temps is not None
        eos_on = eos >= 0
        done = budgets <= 0
        if sampled:
            top_ks = torch.zeros_like(temps, dtype=torch.int32)
            top_ps = torch.ones_like(temps)
        outs = []
        for _ in range(rounds):
            L = tgt_cache["lengths"]
            # Rows without room for the whole k+1 window freeze (capacity).
            cap = L + k + 1 > max_seq
            act = ~(done | cap)

            # 1) The draft's k one-token steps (greedy, or sampled at each
            #    row's temperature: the acceptance needs the draft's logits).
            t, drafts, q_all = toks, [], []
            for _ in range(k):
                logits = self.draft._decode_step(dft_cache, t, act)
                if sampled:
                    t = sample_batch(logits, generator, temps, top_ks, top_ps, need_temp=True,
                                     need_topk=False, need_topp=False)
                    q_all.append(logits)
                else:
                    t = torch.argmax(logits, dim=-1)
                drafts.append(t)
            drafts = torch.stack(drafts, dim=1)  # (B, k)

            # 2) The target verifies [t0, d_1..d_k] in one forward.
            logits = self._verify(tgt_cache, torch.cat([toks[:, None], drafts], dim=1), act)

            if sampled:
                # 3s) The rejection scheme over the first k-1 drafts (the cap
                #     keeps the draft cache in step).
                emitted_toks, n = sampled_accept(
                    logits[:, :k], torch.stack(q_all[:k - 1], dim=1), drafts[:, :k - 1],
                    temps, generator)
            else:
                # 3g) The longest matching prefix (capped at k-1) and the
                #     target's own next token.
                greedy = torch.argmax(logits, dim=-1)
                match = (drafts[:, :k - 1] == greedy[:, :k - 1]).to(torch.int32)
                n = torch.cumprod(match, dim=1).sum(dim=1)  # 0..k-1
                emitted_toks = greedy[:, :k]
            m = n.to(torch.int32) + 1  # this round's tokens before the cuts

            # The first EOS among the emitted prefix ends the row there.
            emit_mask = torch.arange(k, device=m.device)[None, :] < m[:, None]
            is_eos = emit_mask & eos_on[:, None] & (emitted_toks == eos[:, None])
            any_eos = is_eos.any(dim=1)
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
            m = torch.where(any_eos, first_eos + 1, m)
            m = torch.minimum(m, budgets)
            m = torch.where(act, m, 0)

            last = (m - 1).clamp(min=0).to(torch.int64)[:, None]
            next_tok = torch.gather(emitted_toks, 1, last)[:, 0]
            toks = torch.where(m > 0, next_tok, toks)
            new_len = torch.where(act, L + m, L)
            tgt_cache["lengths"] = new_len
            # The draft's steps advanced (and rebound) its lengths by k: they
            # rewind to the accepted length.
            dft_cache["lengths"] = torch.where(act, new_len, dft_cache["lengths"])
            budgets = budgets - m
            done = done | (any_eos & act) | (budgets <= 0) | cap
            cols = [emitted_toks, m[:, None], done[:, None], new_len[:, None]]
            outs.append(torch.cat([c.to(torch.int32) for c in cols], dim=1))
        return torch.stack(outs, dim=1)

    # -- host API ------------------------------------------------------------

    def decode(self, tgt_cache: dict, dft_cache: dict, tokens, rounds: int, *, budgets,
               eos=None, temps=None, generator: torch.Generator | None = None):
        """Run ``rounds`` speculative rounds, the caches updated in place.

        ``tokens`` (B,): each row's next input token; ``budgets`` (B,): its
        remaining tokens (0: the row is inactive); ``eos`` (B,): its EOS id or
        -1. ``temps``: None for greedy, or (B,) per-row temperatures, which
        run the rejection scheme (:func:`sampled_accept`) with draws from
        ``generator`` (top-k and top-p have no speculative variant). Host
        arrays or device tensors. Returns ``(tgt_cache, dft_cache, blob)``:
        blob (B, rounds, k+3) int32 on the device, each round's columns
        ``[tok_1..tok_k, emitted, done, lengths]``, of which the first
        ``emitted`` toks are the round's tokens.
        """
        tgt = self.target
        B = tgt.max_batch
        toks = tgt._token_ids(tokens)
        budgets = tgt._tensor(budgets, torch.int32)
        eos = (torch.full((B,), -1, dtype=torch.int64, device=tgt.device) if eos is None
               else tgt._tensor(eos, torch.int64))
        temps = None if temps is None else tgt._tensor(temps, torch.float32)
        blob = self._rounds(tgt_cache, dft_cache, toks, budgets, eos, temps, generator, rounds)
        return tgt_cache, dft_cache, blob

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_token_id: int | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> list[list[int]]:
        """Batched generation: greedy (the target-only greedy stream), or with
        ``temperature > 0`` speculative sampling (target-only sampling's
        distribution) from ``generator``."""
        tgt, dft = self.target, self.draft
        B = tgt.max_batch
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts exceed max_batch={B}")
        ids = np.zeros((B, max(max(len(p) for p in prompts), 1)), np.int32)
        lengths = np.ones((B,), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
            lengths[i] = max(len(p), 1)

        tgt_cache, logits, first = tgt.prefill(tgt.new_cache(), ids, lengths, with_tokens=True)
        if temperature > 0:
            first = sample(logits, generator, SamplingParams(temperature=temperature))
        # The draft needs only its cache filled; its logits are unused.
        dft_cache, _ = dft.prefill(dft.new_cache(), ids, lengths)
        first = first.cpu().numpy()

        outputs: list[list[int]] = [[int(first[i])] for i in range(len(prompts))]
        budgets = np.zeros((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        tokens = np.zeros((B,), np.int32)
        for i in range(len(prompts)):
            budgets[i] = max_new_tokens - 1
            if eos_token_id is not None:
                eos[i] = eos_token_id
                if first[i] == eos_token_id:
                    budgets[i] = 0
            tokens[i] = first[i]
        temps = np.full((B,), temperature, np.float32) if temperature > 0 else None
        k = self.k
        # At worst one token a round; a good draft needs up to k times fewer.
        while budgets.max() > 0:
            rounds = max(-(-int(budgets.max()) // k), 1)
            tgt_cache, dft_cache, blob = self.decode(
                tgt_cache, dft_cache, tokens, rounds, budgets=budgets, eos=eos, temps=temps,
                generator=generator)
            blob = blob.cpu().numpy()  # the call's one host fetch
            emitted_rows = blob[:len(prompts), :, k]
            self.stats["rounds"] += rounds
            self.stats["live_rounds"] += int((emitted_rows > 0).sum())
            self.stats["emitted"] += int(emitted_rows.sum())
            for i in range(len(prompts)):
                for r in range(rounds):
                    outputs[i].extend(int(t) for t in blob[i, r, :blob[i, r, k]])
            emitted = blob[:, :, k].sum(axis=1)
            done = blob[:, -1, k + 1].astype(bool)
            budgets = np.where(done, 0, budgets - emitted).astype(np.int32)
            for i in range(len(prompts)):
                tokens[i] = outputs[i][-1]
        return outputs
