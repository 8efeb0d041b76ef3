"""Token-split expert parallelism: all_to_all dispatch and combine.

Counterpart of ``onnx_quantize_tpu/parallel/ep.py``. The engine's EP path
(``Gemma3MoEMLP.ep_axis``) keeps activations whole on every rank and sums
the combine. When the tokens themselves are split, rows move to their
experts' ranks and back with two ``all_to_all`` collectives (GShard,
Switch): route locally, pack each (token, choice) into an (experts,
capacity) buffer, swap, run the local experts (the stacked site dicts the
engine uses, the Hopper kernels per rank), swap back, scatter-add with the
routing weights.

``capacity`` is the row budget per (source rank, expert). None sizes it to
the worst case, ``M_local * top_k``: no choice can drop and the result
equals the one-device MoE MLP. A smaller budget drops the choices past it,
which then add zero (GShard's semantics; renormalizing is the caller's).
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.parallel.comm import all_to_all, axis_size

__all__ = ["a2a_moe_mlp"]


def a2a_moe_mlp(x, stacked: dict, top_p, top_i, *, axis: str, num_experts: int,
                activation: str = "silu", capacity: int | None = None):
    """The MoE MLP of this rank's token rows over the ``axis`` ranks.

    ``x``: (M_local, d), this rank's rows; ``top_p`` / ``top_i``: (M_local,
    k) routing weights and global expert ids; ``stacked``: this rank's
    experts as stacked site dicts (leading axis ``num_experts / ep``; local
    expert g is global ``axis_index * E_local + g``, the layout of
    ``models.moe.stack_moe_experts`` split along its leading axis). Runs
    inside ``use_mesh``. Returns (M_local, d) float32.
    """
    from onnx_quantize_tpu_torch.models.gemma3 import stacked_expert_mlp

    ep = axis_size(axis)
    if num_experts % ep != 0:
        raise ValueError(f"num_experts={num_experts} not divisible by ep={ep}")
    e_local = num_experts // ep
    M, d = x.shape
    k = top_i.shape[-1]
    cap = capacity if capacity is not None else M * k

    flat_e = top_i.reshape(-1).long()  # (M*k,) global expert of each choice
    flat_w = top_p.reshape(-1).to(torch.float32)
    tok = torch.arange(M, device=x.device).repeat_interleave(k)  # token-major choices
    # Each choice's slot in its expert's budget: its rank among the same
    # expert's choices in flat order. Choices past the budget drop.
    onehot = torch.nn.functional.one_hot(flat_e, num_experts)
    rank = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    kept = rank < cap

    disp = torch.zeros((num_experts, cap, d), dtype=x.dtype, device=x.device)
    disp[flat_e[kept], rank[kept]] = x[tok[kept]]
    # (ep, E_local, cap, d) -> each rank keeps its experts' rows from every
    # source rank, source-major.
    recv = all_to_all(disp.reshape(ep, e_local, cap, d), axis)

    outs = [stacked_expert_mlp(stacked, g, recv[:, g].reshape(ep * cap, d), activation)
            for g in range(e_local)]
    y = torch.stack(outs).reshape(e_local, ep, cap, d).transpose(0, 1).contiguous()
    # Send each source rank its rows' results back.
    back = all_to_all(y, axis).reshape(num_experts, cap, d)

    got = back[flat_e, rank.clamp(max=cap - 1)]
    weight = kept.to(torch.float32) * flat_w
    # The scatter-add of each token's k choices, as an ordered sum (an atomic
    # index_add would sum them in another order on every CUDA call).
    contrib = (got.to(torch.float32) * weight[:, None]).reshape(M, k, d)
    out = torch.zeros((M, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out
