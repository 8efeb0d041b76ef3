"""The numbers that decide ``correct`` for a DeepSeek-V2 cell whose requests
share one prefix, from ``deepseek_v2.ReferenceMLA``'s logits.

The same readings as ``judge.py``: the reference runs once over each sampled
request's prompt (the shared prefix, then its suffix) with its served tokens
(teacher-forced), and at each served position reads the gap by which the
served token's logit lies below the reference's best. ``max_gap`` is the
widest of those gaps, ``mean_gap`` their mean, ``argmax_share`` the share of
served tokens that are the reference's own best. A control (the reference
in a precision below the configuration's) is read the same way: at each
position the token the control puts first, and its gap under the reference.
"""

from __future__ import annotations

import torch

from h100bench.reference.deepseek_v2 import ReferenceMLA

__all__ = ["served_gaps"]

_ROWS = 512  # logits rows at a time: (512, vocab) float32


def _served_rows(ref: ReferenceMLA, prefix, samples):
    """Per sample, (reference logits at its served positions, served ids)."""
    hidden = ref.final_hidden(list(prefix), [list(p) + list(s[:-1]) for p, s in samples])
    head = ref.lm_head()
    out = []
    for (p, s), h in zip(samples, hidden):
        rows = h[len(p) - 1: len(p) - 1 + len(s)]
        logits = torch.cat([ref.logits(rows[i:i + _ROWS], head)
                            for i in range(0, rows.shape[0], _ROWS)])
        out.append((logits, torch.as_tensor(s, dtype=torch.long, device=logits.device)))
    del hidden, head
    return out


@torch.no_grad()
def served_gaps(cfg: dict, seed: int, device, prefix, samples, controls=()) -> dict:
    """``samples``: (suffix, served tokens) of greedy requests behind
    ``prefix``. Returns the reference's readings and, per control
    precision, the control's."""
    ref_rows = _served_rows(ReferenceMLA(cfg, seed, device), prefix, samples)
    gaps, hits = [], 0
    for logits, served in ref_rows:
        best = logits.max(dim=-1)
        gaps.append(best.values - logits.gather(1, served[:, None])[:, 0])
        hits += int((best.indices == served).sum())
    gap = torch.cat(gaps)
    result = {"max_gap": float(gap.max()), "mean_gap": float(gap.mean()),
              "argmax_share": hits / gap.numel(), "tokens": int(gap.numel()),
              "requests": len(samples)}
    for precision in controls:
        ctl_rows = _served_rows(ReferenceMLA(cfg, seed, device, precision), prefix, samples)
        cgaps, chits = [], 0
        for (logits, served), (clogits, _) in zip(ref_rows, ctl_rows):
            pick = clogits.argmax(dim=-1)
            cgaps.append(logits.max(dim=-1).values - logits.gather(1, pick[:, None])[:, 0])
            chits += int((pick == logits.argmax(dim=-1)).sum())
        cgap = torch.cat(cgaps)
        result[f"control_{precision}"] = {"max_gap": float(cgap.max()),
                                          "mean_gap": float(cgap.mean()),
                                          "argmax_share": chits / cgap.numel()}
    return result
