"""The card's peaks and the work the cells' inputs need, for the rooflines
and ``mfu``.

``ChipSpec``/``H100`` and ``bound`` are frozen copies of the port's
``tools/benchmark.py`` (``ChipSpec``, ``H100``) and of ``chip_smoke.bound``
(the larger of the bytes over the memory rate and the operations over the
peak of their type), kept here so that a change to the port cannot move
the yardstick.

Work is counted from what a forward over the given tokens needs, not from
the calls the port makes, so a later change of layout leaves the counts
alone:

* A W4 site's least time is max(bytes / HBM rate, operations / bf16 peak),
  where the bytes are its 4-bit codes, one 2-byte scale and one 4-bit zero
  point a group, its bf16 input rows and its bf16 output rows. q, k and v
  count as one site (their input is read once). The experts' gate/up and
  down count as one site each over all experts: at these batches every
  expert is routed to, so a forward reads every expert's weights once, and
  the operations are those of the routed top-k products only.
* Flash decode reads, at each step and layer, the live int8 cache rows of
  each active slot with their float32 scales, and its queries and outputs;
  its operations are QK and PV over those rows (float32, CUDA cores).
* Model FLOPs (``mfu``): 2 x the active parameters of every token processed
  (attention, the top-k experts, the shared expert; the lm_head where the
  token's logits are computed) plus 4 x context x heads x head_dim a layer
  for attention's two products. An expert a token did not route to counts
  nothing.
"""

from __future__ import annotations

import dataclasses

from h100bench.benchlib.weights import Shapes

__all__ = ["ChipSpec", "H100", "bound", "Work"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float
    peak_int8_tops: float
    hbm_gbps: float
    peak_f32_tflops: float

    def peak_ops_per_s(self, kind: str) -> float:
        return 1e12 * {"bf16": self.peak_bf16_tflops, "int8": self.peak_int8_tops,
                       "float32": self.peak_f32_tflops}[kind]

    @property
    def hbm_bytes_per_s(self) -> float:
        return 1e9 * self.hbm_gbps


# NVIDIA's data sheet, H100 SXM, dense rates at 700 W.
H100 = ChipSpec(name="h100", peak_bf16_tflops=989.0, peak_int8_tops=1979.0, hbm_gbps=3350.0,
                peak_f32_tflops=67.0)


def bound(bytes_moved: float, ops: float, kind: str, chip: ChipSpec = H100) -> float:
    """Least seconds for work of ``bytes_moved`` bytes and ``ops``
    operations of type ``kind``."""
    return max(bytes_moved / chip.hbm_bytes_per_s, ops / chip.peak_ops_per_s(kind))


class Work:
    """Least times and model FLOPs of one configuration's forwards."""

    BF16 = 2

    def __init__(self, cfg: dict, chip: ChipSpec = H100):
        self.s = Shapes(cfg)
        self.gs = cfg["recipe"]["body"]["group_size"]
        self.chip = chip

    def _w4_bytes(self, k: int, n: int) -> float:
        return k * n / 2 + (k / self.gs) * n * 2.5

    def w4_sites(self) -> list[tuple[int, int, int, int]]:
        """(K, N per expert or site, experts stored, experts a token uses) of
        one layer's W4 sites."""
        s = self.s
        qkv = (s.heads + 2 * s.kv_heads) * s.head_dim
        sites = [(s.hidden, qkv, 1, 1), (s.heads * s.head_dim, s.hidden, 1, 1),
                 (s.hidden, 2 * s.expert_width, s.experts, s.top_k),
                 (s.expert_width, s.hidden, s.experts, s.top_k)]
        if s.shared_width:
            sites += [(s.hidden, 2 * s.shared_width, 1, 1), (s.shared_width, s.hidden, 1, 1)]
        return sites

    def w4_least_s(self, tokens: int) -> float:
        """All layers' W4 sites over one forward of ``tokens`` rows."""
        total = 0.0
        for k, n, stored, used in self.w4_sites():
            by = stored * self._w4_bytes(k, n) + tokens * used * (k + n) * self.BF16
            total += bound(by, 2.0 * tokens * used * k * n, "bf16", self.chip)
        return self.s.layers * total

    def flash_decode_least_s(self, rows: int, slots: int) -> float:
        """All layers of one decode step: ``rows`` live cache rows summed over
        its ``slots`` active slots."""
        s = self.s
        by = rows * s.kv_heads * (2 * s.head_dim + 2 * 4) + slots * s.heads * s.head_dim * 2 * 4
        return s.layers * bound(by, 4.0 * rows * s.heads * s.head_dim, "float32", self.chip)

    def active_params(self) -> int:
        """A token's body parameters through all layers (no lm_head)."""
        s = self.s
        attn = s.hidden * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.hidden
        experts = s.top_k * 3 * s.hidden * s.expert_width
        shared = 3 * s.hidden * s.shared_width
        return s.layers * (attn + experts + shared)

    def flops(self, tokens: int, context: int, with_logits: int) -> float:
        """Model FLOPs of ``tokens`` tokens that attend to ``context`` keys
        in all (a token at 0-based position p attends to p + 1), with
        ``with_logits`` of them through the lm_head."""
        s = self.s
        return (2.0 * tokens * self.active_params() + 2.0 * with_logits * s.hidden * s.vocab
                + 4.0 * context * s.heads * s.head_dim * s.layers)

    @staticmethod
    def causal_context(n: int) -> int:
        """Keys attended by a prompt of n tokens at positions 0..n-1."""
        return n * (n + 1) // 2
