"""QuantPlan: the per-site quantization state.

Counterpart of ``onnx_quantize_tpu/plan.py``: one :class:`PlanEntry` per
quantizable linear site, keyed by site name, with the group size resolved
against the site's ``in_features``, filled by calibration with the site's
static activation qparams and then stamped with the qconfig the transform
reads. The raw captured inputs of GPTQ, AWQ and SmoothQuant wait with those
algorithms (ROADMAP.md, Queue A item 10).
"""

from __future__ import annotations

import dataclasses
import logging
import re

import torch

from onnx_quantize_tpu_torch.core.qconfig import QConfig

logger = logging.getLogger(__name__)

__all__ = ["LinearSite", "PlanEntry", "QuantPlan", "build_plan", "resolve_group_size",
           "get_target_sites", "stamp_qconfig"]


@dataclasses.dataclass(frozen=True)
class LinearSite:
    """A quantizable matmul site discovered in a model.

    ``op_type`` follows the reference vocabulary: a Linear with bias is a
    "Gemm" site, without bias a "MatMul" site.
    """

    name: str
    op_type: str  # "MatMul" | "Gemm"
    param_path: tuple[str, ...]  # path of the site's param dict in the tree
    in_features: int
    out_features: int


@dataclasses.dataclass
class PlanEntry:
    """Per-site quantization state."""

    site: LinearSite
    qconfig: QConfig
    group_size: int | None = None  # resolved against in_features

    # Calibrated static activation qparams (0-dim tensors).
    input_scale: torch.Tensor | None = None
    input_zero_point: torch.Tensor | None = None
    output_scale: torch.Tensor | None = None
    output_zero_point: torch.Tensor | None = None

    @property
    def name(self) -> str:
        return self.site.name


@dataclasses.dataclass
class QuantPlan:
    entries: dict[str, PlanEntry] = dataclasses.field(default_factory=dict)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def __getitem__(self, name: str) -> PlanEntry:
        return self.entries[name]

    def __iter__(self):
        return iter(self.entries.values())

    def __len__(self) -> int:
        return len(self.entries)


def resolve_group_size(in_channels: int, group_size: int | None) -> int | None:
    """Clamp the group size against the site's in_channels.

    A group size larger than in_channels, or one that does not divide it,
    falls back to ``in_channels`` (one group).
    """
    if not group_size:
        return group_size
    if group_size > in_channels or in_channels % group_size != 0:
        logger.debug("Adjusting group size from %d to %d.", group_size, in_channels)
        return in_channels
    return group_size


def get_target_sites(sites: list[LinearSite], ignore_patterns=()) -> list[LinearSite]:
    """Drop the sites whose name matches an ignore regex."""
    compiled = [re.compile(p) for p in ignore_patterns]

    def is_ignored(name: str) -> bool:
        return bool(name) and any(p.search(name) for p in compiled)

    return [s for s in sites if not is_ignored(s.name)]


def build_plan(sites: list[LinearSite], qconfig: QConfig) -> QuantPlan:
    """One entry per target site, group size resolved per site."""
    plan = QuantPlan()
    gs = qconfig.weights.group_size if qconfig.weights is not None else None
    for site in get_target_sites(sites, qconfig.ignore):
        plan.entries[site.name] = PlanEntry(
            site=site, qconfig=qconfig, group_size=resolve_group_size(site.in_features, gs)
        )
    return plan


def stamp_qconfig(plan: QuantPlan, qconfig: QConfig) -> None:
    """Stamp the qconfig on every entry, without its calibration data (as the
    reference stamps it)."""
    stamped = dataclasses.replace(qconfig, calibration_data=None)
    for entry in plan:
        entry.qconfig = stamped
