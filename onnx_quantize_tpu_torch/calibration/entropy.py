"""Entropy (KL-divergence) calibrator.

Counterpart of ``onnx_quantize_tpu/calibration/entropy.py``: a fixed-width
histogram of |x| accumulates across batches (rebuilt 5% past a new
maximum, the old counts moved by their bin centres); the clip threshold is
the candidate ``T = edge[i]`` that minimises KL(P || Q) between the
distribution saturated at T and its re-binned (``num_quantized_bins``
chunks) re-expansion. The range is (−T, T) when negative values were
seen, (0, T) otherwise.

The counts live on the activations' device and equal the JAX package's
(the same float32 binning, the same float64 rebuild). The threshold search
reads the counts on the host and runs the JAX package's float64 numpy
loop over the candidates (a few thousand vector operations a site), so it
picks the same threshold.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from onnx_quantize_tpu_torch.calibration.base import Calibrator
from onnx_quantize_tpu_torch.calibration.percentile import bin_index, rebin

logger = logging.getLogger(__name__)

__all__ = ["EntropyCalibrator"]


class _AbsHist:
    """Fixed-width histogram over magnitudes [0, hi], rebinned on growth."""

    def __init__(self, bins: int, hi: float, device: torch.device):
        self.bins = bins
        self.hi = max(hi, 1e-12)
        self.counts = torch.zeros(bins, dtype=torch.int64, device=device)
        self.has_neg = False

    def _rebuild(self, hi: float) -> None:
        centers = (np.arange(self.bins) + 0.5) * (self.hi / self.bins)
        self.counts = rebin(self.counts, centers, 0.0, hi)
        self.hi = hi

    def add(self, array: torch.Tensor) -> None:
        self.has_neg = self.has_neg or bool((array < 0).any())
        mags = array.reshape(-1).abs()
        amax = float(mags.max()) if mags.numel() else 0.0
        if amax > self.hi:
            self._rebuild(amax * 1.05)
        self.counts += torch.bincount(bin_index(mags, 0.0, self.hi, self.bins),
                                      minlength=self.bins)


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """KL(P || Q) over the support of P; Q floored to avoid log(0)."""
    mask = p > 0
    pm = p[mask] / p.sum()
    qm = np.maximum(q[mask] / max(q.sum(), 1e-300), 1e-300)
    return float(np.sum(pm * np.log(pm / qm)))


def _entropy_threshold(counts: np.ndarray, hi: float, num_quantized_bins: int) -> float:
    """Clip threshold minimising KL(saturated P || re-expanded quantized Q)."""
    bins = len(counts)
    total = counts.sum()
    if total == 0:
        return 0.0
    n = num_quantized_bins
    if bins <= n:
        return hi
    counts = counts.astype(np.float64)
    tail = counts[::-1].cumsum()[::-1]  # tail[i] = sum(counts[i:])
    best_i, best_kl = bins, np.inf
    for i in range(n, bins + 1):
        raw = counts[:i]
        # P: the slice with the clipped tail saturated into the last kept
        # bin. Q: the raw slice re-binned into n chunks and spread uniformly
        # over each chunk's nonzero support (Q never sees the saturated
        # mass, so clipping hard pays a KL penalty at the clip bin).
        p = raw.copy()
        p[i - 1] += tail[i] if i < bins else 0.0
        bounds = (np.arange(n + 1) * i) // n
        chunk_mass = np.add.reduceat(raw, bounds[:-1])
        nonzero = (raw > 0).astype(np.float64)
        chunk_support = np.add.reduceat(nonzero, bounds[:-1])
        chunk_id = np.repeat(np.arange(n), np.diff(bounds))
        q = nonzero * (chunk_mass / np.maximum(chunk_support, 1.0))[chunk_id]
        kl = _kl_divergence(p, q)
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i * hi / bins


class EntropyCalibrator(Calibrator):
    """Range = symmetric clip at the KL-minimising saturation threshold."""

    def __init__(self, bins: int = 2048, num_quantized_bins: int = 128, momentum: float = 0.0):
        super().__init__()
        assert bins > num_quantized_bins > 0, "need bins > num_quantized_bins > 0"
        if momentum:
            logger.warning(
                "EntropyCalibrator ignores momentum=%s: KL calibration accumulates histograms "
                "over all batches (no EMA).", momentum)
        self.bins = bins
        self.num_quantized_bins = num_quantized_bins
        self._hists: dict[str, _AbsHist] = {}

    def collect(self, name: str, array) -> None:
        array = torch.as_tensor(array).to(torch.float32)
        if name not in self._hists:
            self._hists[name] = _AbsHist(self.bins, float(array.abs().max()), array.device)
        self._hists[name].add(array)
        self.data[name] = self._hists[name]  # presence marker

    def counts(self, name: str) -> torch.Tensor:
        """The histogram's counts for ``name``."""
        return self._hists[name].counts

    def compute_range(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        if name not in self._hists:
            raise KeyError(f"No calibration data collected for '{name}'")
        h = self._hists[name]
        t = _entropy_threshold(h.counts.cpu().numpy(), h.hi, self.num_quantized_bins)
        lo = -t if h.has_neg else 0.0
        # Zero stays representable, as in MinMax.
        f32 = dict(dtype=torch.float32, device=h.counts.device)
        return torch.tensor(min(lo, 0.0), **f32), torch.tensor(max(t, 0.0), **f32)
