"""The work a DeepSeek-V2 cell's inputs need, for ``latent_attn_roofline``,
``w4_roofline`` and ``mfu`` (the card's peaks are ``roofline.H100``).

Counted from what the inputs need, not from the calls the port makes, so a
later kernel or layout leaves the counts alone:

* The latent attention reads, at each attend, every live latent row of the
  attending sequence once: ``rank + rope`` int8 codes and two float32
  scales (584 bytes at DeepSeek-V2-Lite's widths). Its operations, in the
  absorbed form, are per head and visible (query, key) pair ``2 x (rank +
  rope)`` for the score and ``2 x rank`` for the output. The least time of
  the attends is the larger of the rows' bytes over the memory rate and the
  pairs' operations over the bf16 dense peak.
* A W4 site's least time is ``roofline.Work``'s: its 4-bit codes, one
  2-byte scale and one 4-bit zero point a group, its bf16 input and output
  rows, every expert's weights once a forward and the routed top-k
  products only. ``q_proj`` and ``kv_a_proj_with_mqa`` count as one site
  (their input is read once); ``kv_b_proj`` and the router are bf16.
* Model FLOPs (``mfu``): 2 x the active parameters of every token processed
  (attention's four projections with ``kv_b_proj``, the dense MLP of the
  first layers, the routed top-k experts, the shared experts and the
  router; the lm_head where the token's logits are computed) plus, per
  layer, head and visible pair, attention's two products in the published
  form: ``2 x (nope + rope)`` for the score and ``2 x v`` for the output.
"""

from __future__ import annotations

from h100bench.benchlib.roofline import H100, ChipSpec, bound
from h100bench.benchlib.weights_mla import ShapesMLA

__all__ = ["WorkMLA"]


class WorkMLA:
    def __init__(self, cfg: dict, chip: ChipSpec = H100):
        self.s = ShapesMLA(cfg)
        self.gs = cfg["recipe"]["body"]["group_size"]
        self.chip = chip

    @property
    def latent_row_bytes(self) -> int:
        """An int8 latent row with its two float32 scales."""
        return self.s.rank + self.s.rope + 2 * 4

    def latent_least_s(self, rows: int, pairs: int) -> float:
        """Least seconds of attends that read ``rows`` latent rows and score
        ``pairs`` visible pairs in all (summed over layers)."""
        s = self.s
        ops = pairs * s.heads * 2 * ((s.rank + s.rope) + s.rank)
        return bound(rows * self.latent_row_bytes, ops, "bf16", self.chip)

    def w4_sites(self) -> list[tuple[int, int, int, int, int]]:
        """(layers, K, N per expert or site, experts stored, experts a token
        uses) of the W4 sites."""
        s = self.s
        moe = s.layers - s.first_dense
        return [(s.layers, s.hidden, s.heads * (s.nope + s.rope) + s.rank + s.rope, 1, 1),
                (s.layers, s.heads * s.v_dim, s.hidden, 1, 1),
                (s.first_dense, s.hidden, 2 * s.dense_width, 1, 1),
                (s.first_dense, s.dense_width, s.hidden, 1, 1),
                (moe, s.hidden, 2 * s.expert_width, s.experts, s.top_k),
                (moe, s.expert_width, s.hidden, s.experts, s.top_k),
                (moe, s.hidden, 2 * s.shared_width, 1, 1),
                (moe, s.shared_width, s.hidden, 1, 1)]

    def w4_least_s(self, tokens: int) -> float:
        """All W4 sites over one forward of ``tokens`` rows."""
        total = 0.0
        for layers, k, n, stored, used in self.w4_sites():
            by = stored * (k * n / 2 + k / self.gs * n * 2.5) + tokens * used * (k + n) * 2
            total += layers * bound(by, 2.0 * tokens * used * k * n, "bf16", self.chip)
        return total

    def active_params(self) -> int:
        """A token's body parameters through all layers (no lm_head)."""
        s = self.s
        attn = (s.hidden * s.heads * (s.nope + s.rope) + s.hidden * (s.rank + s.rope)
                + s.rank * s.heads * (s.nope + s.v_dim) + s.heads * s.v_dim * s.hidden)
        dense = 3 * s.hidden * s.dense_width
        moe = (s.hidden * s.experts + s.top_k * 3 * s.hidden * s.expert_width
               + 3 * s.hidden * s.shared_width)
        return s.layers * attn + s.first_dense * dense + (s.layers - s.first_dense) * moe

    def flops(self, tokens: int, pairs: int, with_logits: int) -> float:
        """Model FLOPs of ``tokens`` tokens that see ``pairs`` keys in all
        (per layer), ``with_logits`` of them through the lm_head."""
        s = self.s
        return (2.0 * tokens * self.active_params() + 2.0 * with_logits * s.hidden * s.vocab
                + 2.0 * pairs * s.heads * ((s.nope + s.rope) + s.v_dim) * s.layers)
