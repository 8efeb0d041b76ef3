"""Context parallelism: sequence-split scoring with ring attention.

Counterpart of ``onnx_quantize_tpu/parallel/cp.py``. Tokens are split over a
``seq`` mesh axis; every op of the decoder is token-wise except attention,
which runs as a ring: each rank computes its Q/K/V block, then the K/V blocks
(with their global positions) go round the ring one hop a step, the next hop
started before the current block is attended, while a streaming softmax
folds each visited block into the local queries' output. No (T, T) score
matrix and no gathered K/V exist; memory per rank is O(T/C).

Two modes:

* ``"ring"``: the streaming accumulator. A block that the causal/window
  visibility hides entirely is skipped (one host read of its ``any()`` a
  step). Equal to the dense path to float32-accumulation tolerance.
* ``"gather"``: one all-gather of the (GQA-small) K/V heads, then the dense
  attend, the one-device path's operations. With the contiguous layout its
  sums run over the keys in the one-device order (bit-equal to it on an
  H100); the zigzag layout reorders the keys in them, which moves a last
  bit.

``layout="zigzag"`` gives each rank one chunk from the front of the sequence
and its mirror from the back, so causal work is even across the ring.
Positions (RoPE and visibility) travel with the tokens, so any layout
computes the same function; logits are put back in order on the way out.

Every rank calls with the global ids and params and gets the whole logits.
Scope: full-sequence scoring on the Gemma3-family decoder; decode with a
cache stays on the TP engine.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from onnx_quantize_tpu_torch.parallel.comm import all_gather, ppermute_start
from onnx_quantize_tpu_torch.parallel.mesh import P, Mesh, shard_local, use_mesh

logger = logging.getLogger(__name__)

__all__ = ["make_cp_mesh", "make_cp_tp_mesh", "cp_localize", "cp_logits", "cp_tp_logits",
           "make_cp_forward", "zigzag_permutation", "cp_attend"]


def make_cp_mesh(shards: int, ranks=None, axis: str = "seq") -> Mesh:
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    if len(ranks) < shards:
        raise ValueError(f"need >= {shards} ranks, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:shards]), (axis,))


def zigzag_permutation(T: int, shards: int) -> np.ndarray:
    """Token order in which contiguous shard c holds chunks (c, 2C-1-c)."""
    if T % (2 * shards) != 0:
        raise ValueError(f"zigzag needs T % (2*shards) == 0, got T={T}, shards={shards}")
    chunks = np.arange(T).reshape(2 * shards, T // (2 * shards))
    return np.concatenate([chunks[i] for c in range(shards) for i in (c, 2 * shards - 1 - c)])


def _ring_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str, size: int):
    """Streaming-softmax ring attention.

    q: (B, Tl, Hq, D) local queries (RoPE'd, pre-scaled), k/v: (B, Tl, Hkv,
    D) local keys/values, q_pos: (B, Tl) global positions. Returns (B, Tl,
    Hq, D) float32. Step 0 attends the rank's own block, whose diagonal is
    always visible, so the running max is real before any block could add
    exp(0) terms and the final sum is never zero.
    """
    from onnx_quantize_tpu_torch.models.gemma3 import make_attention_valid

    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tl, Hkv, Hq // Hkv, D)
    m = torch.full((B, Hkv, Hq // Hkv, Tl), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, D), dtype=torch.float32, device=q.device)
    kv_pos = q_pos
    ring = [(i, (i + 1) % size) for i in range(size)]
    for step in range(size):
        pending = (ppermute_start([k, v, kv_pos], axis, ring) if step < size - 1 else None)
        # The additive mask and the skip come from one boolean tensor.
        valid = make_attention_valid(cfg, q_pos, kv_pos, is_global)  # (B, 1, Tl, Sl)
        if bool(valid.any()):
            mask = torch.where(valid, 0.0, -1e30).to(torch.float32)
            # The dense path's dtype chain: scores in q's dtype, float32
            # softmax pieces, probabilities in v's dtype.
            s = torch.einsum("btkgh,bskh->bkgts", qg, k.to(qg.dtype)).to(torch.float32)
            s = s + mask[:, :, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgts,bskh->bkgth", p.to(v.dtype), v)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        if pending is not None:
            k, v, kv_pos = pending.wait()
    out = acc / l[..., None]  # (B, Hkv, G, Tl, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tl, Hq, D)


def _gather_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str):
    """All-gathered K/V, then the exact dense attend."""
    from onnx_quantize_tpu_torch.models.gemma3 import make_attention_mask

    B, Tl, Hq, D = q.shape
    Hkv = k.shape[2]
    kf, vf = all_gather(k, axis, dim=1), all_gather(v, axis, dim=1)
    kv_pos = all_gather(q_pos, axis, dim=1)
    mask = make_attention_mask(cfg, q_pos, kv_pos, is_global)
    qg = q.reshape(B, Tl, Hkv, Hq // Hkv, D)
    s = torch.einsum("btkgh,bskh->bkgts", qg, kf.to(qg.dtype)).to(torch.float32)
    probs = torch.softmax(s + mask[:, :, None], dim=-1).to(vf.dtype)
    return torch.einsum("bkgts,bskh->btkgh", probs, vf).reshape(B, Tl, Hq, D)


def cp_attend(q, k, v, q_pos, *, cfg, is_global: bool, axis: str, size: int,
              mode: str = "ring"):
    """The attend of ``Gemma3Attention``'s context-parallel hook (``cp_spec``)."""
    if mode == "ring":
        return _ring_attend(q, k, v, q_pos, cfg=cfg, is_global=is_global, axis=axis, size=size)
    if mode == "gather":
        return _gather_attend(q, k, v, q_pos, cfg=cfg, is_global=is_global, axis=axis)
    raise ValueError(f"unknown cp mode {mode!r} (expected 'ring' or 'gather')")


def _stamp(model, axis: str, size: int, mode: str):
    model.use_flash = False  # the hook takes attention before the flash branch
    for block in model.layers:
        block.attn.cp_spec = (axis, size, mode)
    return model


def cp_localize(model, *, axis: str = "seq", size: int, mode: str = "ring"):
    """A fresh model of the same config whose attention runs the CP ring.
    Params are untouched: CP is an execution layout, not a weight layout."""
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3

    if not hasattr(model, "layers") or not isinstance(model, Gemma3):
        raise ValueError("context parallelism supports the Gemma3-family decoder")
    if mode not in ("ring", "gather"):
        raise ValueError(f"unknown cp mode {mode!r}")
    return _stamp(Gemma3(model.cfg), axis, size, mode)


def _layout(T: int, C: int, layout: str) -> np.ndarray:
    if T % C != 0:
        raise ValueError(f"seq len {T} not divisible by cp shards {C}")
    if layout == "zigzag":
        return zigzag_permutation(T, C)
    if layout == "contiguous":
        return np.arange(T)
    raise ValueError(f"unknown layout {layout!r}")


def _sequence_split(local, params, ids, mesh: Mesh, axis: str, perm: np.ndarray):
    """The CP forward: this rank's tokens of the permuted sequence, the
    model, the logits gathered along the sequence and put back in order."""
    device = params["embed"]["w"].device
    ids = (ids if isinstance(ids, torch.Tensor) else torch.from_numpy(np.asarray(ids))).to(
        device=device, dtype=torch.int64)
    B, T = ids.shape
    perm_t = torch.as_tensor(perm, device=device)
    positions = perm_t.to(torch.int32)[None].expand(B, T)
    with torch.inference_mode(), use_mesh(mesh):
        ids_loc = shard_local(ids[:, perm_t], P(None, axis), mesh)
        pos_loc = shard_local(positions, P(None, axis), mesh)
        logits = all_gather(local(params, ids_loc, positions=pos_loc), axis, dim=1)
    return logits[:, torch.as_tensor(np.argsort(perm), device=device)]


def make_cp_forward(model, mesh: Mesh, seq_len: int, *, axis: str = "seq", mode: str = "ring",
                    layout: str = "contiguous"):
    """``forward(params, ids) -> logits`` for (B, seq_len) ids, reused across
    calls (perplexity sweeps, calibration batches)."""
    C = mesh.shape[axis]
    perm = _layout(seq_len, C, layout)
    local = cp_localize(model, axis=axis, size=C, mode=mode)

    def forward(params, ids):
        if ids.shape[1] != seq_len:
            raise ValueError(f"expected seq len {seq_len}, got {ids.shape[1]}")
        return _sequence_split(local, params, ids, mesh, axis, perm)

    return forward


def cp_logits(model, params, ids, mesh: Mesh, *, axis: str = "seq", mode: str = "ring",
              layout: str = "contiguous"):
    """Full-sequence logits with the tokens split over ``axis``: equal to
    ``model(params, ids)`` up to the order of float sums (none for "gather"
    with the contiguous layout, the keys' order for zigzag, and the streaming
    softmax's rescales for "ring")."""
    return make_cp_forward(model, mesh, ids.shape[1], axis=axis, mode=mode,
                           layout=layout)(params, ids)


def make_cp_tp_mesh(seq_shards: int, tp: int, ranks=None, seq_axis: str = "seq",
                    model_axis: str = "model") -> Mesh:
    """A (seq, model) mesh: ring hops along one axis, TP sums along the other."""
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    n = seq_shards * tp
    if len(ranks) < n:
        raise ValueError(f"need >= {n} ranks, have {len(ranks)}")
    return Mesh(np.asarray(ranks[:n]).reshape(seq_shards, tp), (seq_axis, model_axis))


def cp_tp_logits(model, params, ids, mesh: Mesh, *, seq_axis: str = "seq",
                 model_axis: str = "model", mode: str = "ring", layout: str = "contiguous"):
    """Ring attention over ``seq`` and Megatron TP over ``model`` at once:
    tokens split along one axis, weights along the other by
    ``Gemma3.tp_localize``'s rules. The ring hops stay on the seq groups and
    the sums and gathers of TP on the model groups."""
    from onnx_quantize_tpu_torch.parallel.tp import (
        build_param_specs,
        localize_params,
        shard_params_local,
    )

    C, tp = mesh.shape[seq_axis], mesh.shape[model_axis]
    perm = _layout(ids.shape[1], C, layout)
    local, rules = model.tp_localize(tp, axis=model_axis)
    if local is model:
        local = type(model)(model.cfg)
    _stamp(local, seq_axis, C, mode)
    lparams = localize_params(params, rules, tp)
    mine = shard_params_local(lparams, build_param_specs(lparams, rules, axis=model_axis), mesh)
    return _sequence_split(local, mine, ids, mesh, seq_axis, perm)
