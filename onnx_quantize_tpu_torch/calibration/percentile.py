"""Percentile calibrator (histogram-based).

Counterpart of ``onnx_quantize_tpu/calibration/percentile.py``: the
activation range is clipped to the central ``percentile`` mass of the
observed distribution. A fixed-width histogram per tap accumulates across
batches; when a batch falls outside its range the histogram is rebuilt 5%
wider on each side, the old counts moved by their bin centres.

The counts live on the activations' device and equal the JAX package's:
the bin of a value is the same float32 arithmetic, ``(x - lo) / (hi - lo)
* bins`` truncated and clipped, and the rebuild and the percentile read run
the JAX package's float64 numpy arithmetic on the host (a histogram's
``bins + 1`` edges).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from onnx_quantize_tpu_torch.calibration.base import Calibrator

logger = logging.getLogger(__name__)

__all__ = ["PercentileCalibrator", "bin_index"]


def bin_index(values: torch.Tensor, lo: float, span: float, bins: int) -> torch.Tensor:
    """The bin of each float32 value: ``(values - lo) / span * bins`` in
    float32 (``lo`` and ``span`` rounded to float32 first, as numpy reads
    Python floats in a float32 expression), truncated, clipped to the bins."""
    f32 = dict(dtype=torch.float32, device=values.device)
    pos = (values - torch.tensor(lo, **f32)) / torch.tensor(span, **f32) * bins
    return torch.clamp(pos.to(torch.int64), 0, bins - 1)


def rebin(counts: torch.Tensor, centers: np.ndarray, lo: float, hi: float) -> torch.Tensor:
    """Counts moved to the bins of ``[lo, hi]`` by their old bin centres
    (float64 on the host, as the JAX package)."""
    bins = counts.numel()
    idx = np.clip(((centers - lo) / (hi - lo) * bins).astype(np.int64), 0, bins - 1)
    new = torch.zeros_like(counts)
    return new.index_add_(0, torch.from_numpy(idx).to(counts.device), counts)


class _Hist:
    def __init__(self, bins: int, lo: float, hi: float, device: torch.device):
        self.bins = bins
        self.lo = lo
        self.hi = max(hi, lo + 1e-12)
        self.counts = torch.zeros(bins, dtype=torch.int64, device=device)

    def _rebuild(self, lo: float, hi: float) -> None:
        old_edges = np.linspace(self.lo, self.hi, self.bins + 1)
        centers = (old_edges[:-1] + old_edges[1:]) / 2
        self.counts = rebin(self.counts, centers, lo, hi)
        self.lo, self.hi = lo, max(hi, lo + 1e-12)

    def add(self, array: torch.Tensor) -> None:
        amin, amax = float(array.min()), float(array.max())
        if amin < self.lo or amax > self.hi:
            span = max(amax, self.hi) - min(amin, self.lo)
            self._rebuild(min(amin, self.lo) - 0.05 * span, max(amax, self.hi) + 0.05 * span)
        idx = bin_index(array.reshape(-1), self.lo, self.hi - self.lo, self.bins)
        self.counts += torch.bincount(idx, minlength=self.bins)

    def percentile_range(self, pct: float) -> tuple[float, float]:
        counts = self.counts.cpu().numpy()
        total = counts.sum()
        if total == 0:
            return 0.0, 0.0
        cdf = np.cumsum(counts) / total
        edges = np.linspace(self.lo, self.hi, self.bins + 1)
        lo_q = (1.0 - pct) / 2.0
        hi_q = 1.0 - lo_q
        lo_idx = int(np.searchsorted(cdf, lo_q))
        hi_idx = int(np.searchsorted(cdf, hi_q))
        return float(edges[lo_idx]), float(edges[min(hi_idx + 1, self.bins)])


class PercentileCalibrator(Calibrator):
    """Range = central ``percentile`` mass of the observed distribution."""

    def __init__(self, percentile: float = 0.999, bins: int = 2048, momentum: float = 0.0):
        super().__init__()
        assert 0 < percentile <= 1.0, "percentile must be in (0, 1]"
        del momentum  # accepted for CalibrationParams compatibility; unused
        self.percentile = percentile
        self.bins = bins
        self._hists: dict[str, _Hist] = {}

    def collect(self, name: str, array) -> None:
        array = torch.as_tensor(array).to(torch.float32)
        if name not in self._hists:
            self._hists[name] = _Hist(self.bins, float(array.min()), float(array.max()),
                                      array.device)
        self._hists[name].add(array)
        self.data[name] = self._hists[name]  # presence marker

    def counts(self, name: str) -> torch.Tensor:
        """The histogram's counts for ``name``."""
        return self._hists[name].counts

    def compute_range(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        if name not in self._hists:
            raise KeyError(f"No calibration data collected for '{name}'")
        h = self._hists[name]
        lo, hi = h.percentile_range(self.percentile)
        # Zero stays representable, as in MinMax.
        f32 = dict(dtype=torch.float32, device=h.counts.device)
        return torch.tensor(min(lo, 0.0), **f32), torch.tensor(max(hi, 0.0), **f32)
