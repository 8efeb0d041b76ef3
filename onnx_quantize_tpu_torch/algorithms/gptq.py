"""GPTQ: Hessian-based error-corrected weight quantization.

Counterpart of ``onnx_quantize_tpu/algorithms/gptq.py``, on torch tensors on
the weight's device: the Hessian ``H = 2/n · XᵀX`` with its running
renormalization, dead channels masked, optional (group-aligned) actorder,
the damped Cholesky inverse ``Hinv`` (upper triangular) with an RTN
fallback when a factorisation fails, and the blocked sweep: columns
quantized one at a time inside each block with their error propagated to
the block's later columns, the block's error to all later rows, group
qparams recomputed at each group edge from the block-updated weight, ragged
last groups, the in-sweep MSE search.

The sweep follows the JAX package's host sweep (``_gptq_sweep_host``)
operation for operation, so with the same ``Hinv`` it gives the same codes.
It keeps the JAX package's deliberate deviation from the reference: the
error propagates through the *row* ``Hinv[i, i:]`` (the GPTQ paper's
update; the reference's column slice of an upper-triangular ``Hinv`` is
zero and propagates nothing).

On the card the sweep is a Python loop over columns, each a handful of
kernel launches; group edges are Python integers and nothing in the loop
reads a device value back, so the host queues the whole sweep without
waiting. The factorisations run in float32, as in the JAX package; a
failed one (``cholesky_ex``'s ``info``, or a non-finite factor) falls back
to RTN, which costs one host sync per site.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from onnx_quantize_tpu_torch.core.dtypes import QuantType
from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
from onnx_quantize_tpu_torch.core.numerics import compute_qparams_from_array, sum_f64, true_div

logger = logging.getLogger(__name__)

__all__ = ["gptq_quantize", "accumulate_hessian", "quantize_weights"]


def quantize_weights(config, weight: torch.Tensor, qconfig, entry=None):
    """GPTQ of one site's weight on its captured inputs (``GPTQConfig``'s entry)."""
    if entry is None or entry.captured_input is None:
        raise ValueError("GPTQ requires a plan entry with calibration inputs (captured_input).")
    w = qconfig.weights
    group_size = entry.group_size if entry.group_size is not None else w.group_size
    return gptq_quantize(
        weight, entry.captured_input, quant_type=w.dtype, strategy=w.strategy,
        group_size=group_size if group_size is not None else -1, is_symmetric=w.symmetric,
        reduce_range=w.reduce_range, clip_ratio=w.clip_ratio, block_size=config.block_size,
        percdamp=config.percdamp, actorder=config.actorder, mse=w.mse,
    )


def accumulate_hessian(inp: torch.Tensor, H: torch.Tensor, num_samples: int):
    """Running Hessian accumulation ``H += 2/n · XᵀX`` over the first axis's
    samples (float32, as the JAX package)."""
    num_added = inp.shape[0]
    inp = inp.reshape(-1, inp.shape[-1])
    H = H * (num_samples / (num_samples + num_added))
    num_samples += num_added
    inp = math.sqrt(2 / num_samples) * inp.to(torch.float32)
    return H + inp.T @ inp, num_samples


def _cholesky_inverse_sweep(H: torch.Tensor, percdamp: float) -> torch.Tensor | None:
    """Damped upper-triangular Cholesky factor of H⁻¹, or None when a
    factorisation fails (float32, as the JAX package)."""
    K = H.shape[0]
    damp = (percdamp * true_div(sum_f64(torch.diagonal(H)), K)).to(H.dtype)
    H = H + damp * torch.eye(K, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H)
    eye = torch.eye(K, dtype=H.dtype, device=H.device)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    M, info_m = torch.linalg.cholesky_ex(Li.T @ Li)
    ok = (info == 0) & (info_m == 0) & torch.isfinite(M).all()
    if not bool(ok):  # one host sync per site
        return None
    return M.T


def _channelwise_qparams(w_slice_t: torch.Tensor, quant_type, sym, rr, clip_ratio, mse):
    """Per-out-channel qparams (float32 scale and zero point, shape (N,)) of
    an ``(N, k)`` slice."""
    scale, zp = compute_qparams_from_array(
        w_slice_t, quant_type, QuantizationStrategy.CHANNEL, -1, sym, rr,
        clip_ratio=clip_ratio, mse=mse, zp_dtype=torch.float32)
    return scale.reshape(-1), zp.reshape(-1)


def _gptq_sweep(W, Hinv, scale, zp, *, qmin, qmax, block_size, group_size, use_group,
                quant_type, sym, rr, clip_ratio, mse):
    """The blocked error-corrected sweep over a ``(K, N)`` float32 weight.

    Operation for operation the JAX package's ``_gptq_sweep_host``: returns
    ``(Qint, g_scales, g_zps)``, the codes as float32 and, with groups, each
    group's loop-time qparams ``(n_groups, N)``.
    """
    K, N = W.shape
    W = W.clone()
    Qint = torch.zeros_like(W)
    n_groups = -(-K // group_size) if use_group else 1
    g_scales = torch.zeros((n_groups, N), dtype=torch.float32, device=W.device)
    g_zps = torch.zeros((n_groups, N), dtype=torch.float32, device=W.device)

    for i1 in range(0, K, block_size):
        i2 = min(i1 + block_size, K)
        W1 = W[i1:i2].clone()
        Qint1 = Qint[i1:i2]
        Err1 = torch.zeros_like(W1)
        Hinv1 = Hinv[i1:i2, i1:i2]
        for i in range(i2 - i1):
            c = i1 + i
            if use_group and c % group_size == 0:
                # From W, which holds the earlier blocks' updates but not this
                # block's (the reference reads the same slice).
                scale, zp = _channelwise_qparams(W[c:c + group_size].T, quant_type, sym, rr,
                                                 clip_ratio, mse)
                g_scales[c // group_size] = scale
                g_zps[c // group_size] = zp
            w = W1[i]
            t = torch.round(w / scale)
            t += zp
            torch.clamp(t, qmin, qmax, out=Qint1[i])
            q = (Qint1[i] - zp) * scale
            torch.div(w - q, Hinv1[i, i], out=Err1[i])
            W1[i:] -= torch.outer(Hinv1[i, i:], Err1[i])
        W[i2:] -= Hinv[i1:i2, i2:].T @ Err1
    return Qint, g_scales, g_zps


def _group_aligned_perm(d: np.ndarray, K: int, group_size: int, use_group: bool):
    """actorder's permutation and, with groups, the loop order of the full
    groups, by the JAX package's numpy rules (so ties order alike)."""
    if not use_group:
        return np.argsort(d)[::-1], None
    n_full = K // group_size
    parts, scores = [], []
    for g in range(n_full):
        rows = np.arange(g * group_size, (g + 1) * group_size)
        parts.append(rows[np.argsort(d[rows])[::-1]])
        scores.append(d[rows].max())
    group_order = np.argsort(np.asarray(scores))[::-1]
    perm = np.concatenate([parts[g] for g in group_order])
    if K % group_size:
        tail = np.arange(n_full * group_size, K)
        perm = np.concatenate([perm, tail[np.argsort(d[tail])[::-1]]])
    return perm, group_order


def gptq_quantize(
    weights: torch.Tensor,
    inputs: torch.Tensor,
    quant_type: QuantType = QuantType.QInt8,
    strategy: QuantizationStrategy = QuantizationStrategy.CHANNEL,
    group_size: int = 32,
    is_symmetric: bool = False,
    reduce_range: bool = False,
    clip_ratio: float = 1.0,
    block_size: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    mse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GPTQ-quantize a ``(in_features, out_features)`` weight on its device.

    ``inputs`` are the site's captured activations ``(samples, ...,
    in_features)``. Returns ``(q_weight, scale, zero_point)`` in RTN's
    layout. With groups and actorder the permutation is group-aligned (whole
    groups by their largest diag(H), rows by diag(H) within a group, a ragged
    tail group last), so loop groups are the original groups and the emitted
    scales are the loop's own.
    """
    device = weights.device
    W = weights.to(torch.float32).clone()
    K, N = W.shape
    H, _ = accumulate_hessian(inputs.to(device), torch.zeros((K, K), device=device), 0)

    use_group = bool(strategy == QuantizationStrategy.GROUP and group_size and group_size != -1)
    if strategy == QuantizationStrategy.TENSOR:
        scale, zp = compute_qparams_from_array(
            W.T, quant_type, QuantizationStrategy.TENSOR, -1, is_symmetric, reduce_range,
            clip_ratio=clip_ratio, mse=mse, zp_dtype=torch.float32)
    else:
        scale, zp = _channelwise_qparams(W.T, quant_type, is_symmetric, reduce_range,
                                         clip_ratio, mse)

    # Dead channels: unit Hessian diagonal, zero weight rows.
    diag = torch.diagonal(H)
    dead = diag == 0
    diag.copy_(torch.where(dead, torch.ones_like(diag), diag))
    W = torch.where(dead[:, None], torch.zeros_like(W), W)

    perm = group_order = None
    if actorder:
        perm, group_order = _group_aligned_perm(torch.diagonal(H).cpu().numpy(), K,
                                                int(group_size), use_group)
        perm_t = torch.from_numpy(perm.copy()).to(device)
        W = W[perm_t]
        H = H[perm_t][:, perm_t]

    Hinv = _cholesky_inverse_sweep(H, percdamp)
    if Hinv is None:
        logger.warning(
            "Failed to invert hessian due to numerical instability. Consider increasing "
            "percdamp, increasing the number of calibration samples, or shuffling the "
            "calibration dataset. Falling back to round-to-nearest for this module.")
        Hinv = torch.eye(K, dtype=torch.float32, device=device)

    qmin, qmax = quant_type.qrange(is_symmetric, reduce_range)
    gs = int(group_size) if use_group else -1
    Qint, g_scales, g_zps = _gptq_sweep(
        W, Hinv, scale, zp, qmin=qmin, qmax=qmax, block_size=block_size, group_size=gs,
        use_group=use_group, quant_type=quant_type, sym=is_symmetric, rr=reduce_range,
        clip_ratio=clip_ratio, mse=mse)

    if actorder:
        Qint = Qint[torch.from_numpy(np.argsort(perm)).to(device)]
    Qint = Qint.to(quant_type.container_dtype)

    # The loop-time qparams, so (Qint, scale, zp) dequantizes exactly to the
    # error-corrected weight.
    if strategy != QuantizationStrategy.GROUP:
        out_scale, out_zp = scale, zp
    else:
        if group_order is not None:
            # Loop group j is original group group_order[j]; a ragged tail
            # group stayed last.
            order = torch.from_numpy(group_order.copy()).to(device)
            n_full = len(group_order)
            g_scales = torch.cat([g_scales[:n_full][torch.argsort(order)], g_scales[n_full:]])
            g_zps = torch.cat([g_zps[:n_full][torch.argsort(order)], g_zps[n_full:]])
        out_scale = g_scales.T.reshape(-1, 1)
        out_zp = g_zps.T.reshape(-1, 1)
    return Qint.contiguous(), out_scale, out_zp.to(Qint.dtype)
