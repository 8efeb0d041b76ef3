"""Gemma-3 text model, dense path, and the Llama-family decoder it expresses.

Counterpart of ``onnx_quantize_tpu/models/gemma3.py``: every attention and
MLP projection is a ``Linear`` site; the lm_head is its own site, tied to the
embedding at init. Gemma-3 semantics by default: RMSNorm (1 + w gain,
float32), QK-norm, GQA with dual-theta RoPE (local layers use
``rope_local_base``), a sliding window on all but every
``sliding_pattern``-th layer, GeGLU MLP (tanh gelu), sandwich norms, scaled
embeddings. The config's switches flip these to the Llama/Qwen conventions
(``models/llama.py``): no QK-norm, pre-norm only, SiLU MLP, unscaled
embeddings, plain-w RMSNorm gain, an optionally untied lm_head, llama3 rope
scaling, q/k/v biases.

Attention without a cache runs the flash-attention kernel where
``Gemma3.use_flash`` allows it (``"auto"``: T >= 512 on CUDA tensors, as the
reference arms it on its accelerator only) and einsum and softmax otherwise.
Over an int8/int4 KV cache it is the scale-folded attend that never
materializes a dequantized cache, or, for the engine's one-token steps with
``fused_attention``, the int8 flash-decode kernel. With the engine's
``mlp_megakernel``, a decode-sized GeGLU MLP over packed W4 weights runs the
fused MLP kernel (``ops/kernels/mlp_w4.py``), unless ``down_proj`` carries an
input prescale (AWQ, SmoothQuant) or an online rotation (QuaRot R4), which
the kernel has no hook for. QuaRot's online transforms (``prepasses/
rotate.py``) live on the modules: ``Gemma3Attention.qk_rot`` rotates q and k
per head after RoPE (so the K cache holds rotated rows) and
``Gemma3MLP.down_rot`` mixes the down_proj input blockwise; both are plain
matmuls, as the reference computes them outside any Pallas kernel. A forward
given a ``Context`` records the calibration taps of the unfused sites.
With ``num_experts > 0`` each block's MLP is a :class:`Gemma3MoEMLP`
(``models/moe.py`` holds the MoE configs and the engine layouts).

Parallelism hooks (``parallel/``): :meth:`Gemma3.tp_localize` returns a
per-rank model whose markers run the collectives of tensor and expert
parallelism (``Linear.tp_reduce``, ``Embedding.tp_vocab_axis``, the logits
all-gather, the GQA replicate-slice of K/V, ``Gemma3MoEMLP.ep_axis``), and
``Gemma3Attention.cp_spec`` (``parallel/cp.py``) runs a full-sequence
attention over sequence-split K/V blocks. The markers name mesh axes; the
collectives run over the mesh made current by ``parallel.mesh.use_mesh``.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from onnx_quantize_tpu_torch.core.enums import QFormat
from onnx_quantize_tpu_torch.engine.kv_cache import QuantizedKV
from onnx_quantize_tpu_torch.nn.layers import Embedding, RMSNorm, apply_rope
from onnx_quantize_tpu_torch.nn.module import InputSpec, Linear, Module, apply_linear
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import flash_attention, flash_decode, mlp_w4
from onnx_quantize_tpu_torch.ops.reference import dequantize_weight
from onnx_quantize_tpu_torch.utils import copy_tree

logger = logging.getLogger(__name__)

__all__ = ["Gemma3Config", "Gemma3", "Gemma3MoEMLP", "GEMMA3_270M", "GEMMA3_1B", "GEMMA3_4B",
           "make_attention_mask", "make_attention_valid", "fuse_gemma3_projections",
           "glu_activation", "stacked_expert_mlp"]


@dataclasses.dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262_144
    hidden_size: int = 640
    intermediate_size: int = 2048
    num_layers: int = 18
    num_heads: int = 4
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 1_000_000.0  # global layers
    rope_local_base: float = 10_000.0  # sliding-window layers
    sliding_window: int = 512
    sliding_pattern: int = 6  # every Nth layer is global
    rms_norm_eps: float = 1e-6
    query_pre_attn_scalar: float = 256.0
    dtype: str = "float32"
    # Architecture switches (defaults: Gemma-3). The Llama/Qwen conventions
    # (models/llama.py) flip them: no QK-norm, pre-norm only, SiLU MLP,
    # unscaled embeddings, plain-w RMSNorm gain, optionally untied lm_head,
    # llama3 rope scaling as (factor, low_freq_factor, high_freq_factor,
    # original_max_position), q/k/v biases (Qwen-2).
    use_qk_norm: bool = True
    sandwich_norms: bool = True
    mlp_activation: str = "gelu_tanh"  # "gelu_tanh" | "silu"
    scale_embeddings: bool = True
    rms_one_plus: bool = True
    tie_lm_head: bool = True
    rope_scaling: tuple | None = None
    attn_bias: bool = False
    # Mixture-of-Experts (the Mixtral/Qwen-MoE conventions, models/moe.py).
    # num_experts == 0 keeps the dense MLP; above 0 the block's MLP is a
    # Gemma3MoEMLP: a softmax router, top-k experts, each a gate/up/down trio.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int | None = None  # None: intermediate_size
    # Qwen-MoE's shared expert: a dense MLP of this width on every token,
    # gated by sigmoid(x @ w) with w (hidden, 1). 0 disables it.
    shared_expert_size: int = 0
    # Renormalize the top-k probabilities to sum to 1 (Mixtral: True;
    # Qwen1.5-MoE: False).
    norm_topk_prob: bool = True

    def is_global_layer(self, idx: int) -> bool:
        return (idx + 1) % self.sliding_pattern == 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls, **kw) -> "Gemma3Config":
        """A scaled-down config for tests (the JAX package's defaults)."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=2, num_kv_heads=1, head_dim=32, sliding_window=16,
            sliding_pattern=2,
        )
        base.update(kw)
        return cls(**base)


GEMMA3_270M = Gemma3Config()

# Larger text-model configs in the family (same architecture knobs).
GEMMA3_1B = Gemma3Config(
    hidden_size=1152,
    intermediate_size=6912,
    num_layers=26,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
)

GEMMA3_4B = Gemma3Config(
    hidden_size=2560,
    intermediate_size=10240,
    num_layers=34,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    sliding_window=1024,
)


def _rotation_tensor(module: Module, name: str, like: torch.Tensor) -> torch.Tensor:
    """The module's online rotation ``name`` (a float64 numpy matrix) in
    ``like``'s dtype on its device, converted once per stamped matrix, dtype
    and device, so a decode step copies nothing from the host."""
    rot = getattr(module, name)
    cache = module.__dict__.setdefault("_rotation_cache", {})
    key = (name, like.dtype, like.device)
    hit = cache.get(key)
    if hit is None or hit[0] is not rot:
        hit = cache[key] = (rot, torch.as_tensor(rot, dtype=like.dtype, device=like.device))
    return hit[1]


def _attend(q, k, v, mask, cfg: Gemma3Config, k_scale=None, v_scale=None):
    """GQA attention over (B, S, Hkv, D) keys/values; mask (B, 1, T, S).

    With ``k_scale``/``v_scale`` (B, S, Hkv), k and v are int8 codes and the
    scales are folded in: scores = (q . K_i8) * ks[s], out = (p * vs[s]) . V_i8,
    so no dequantized cache exists.
    """
    B, T = q.shape[:2]
    S = k.shape[1]
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, T, cfg.num_kv_heads, group, cfg.head_dim)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.to(q.dtype)).to(torch.float32)
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    logits = logits + mask[:, :, None, :, :S]
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        v = v.to(q.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)
    return out.reshape(B, T, cfg.num_heads * cfg.head_dim)


class Gemma3Attention(Module):
    def __init__(self, cfg: Gemma3Config, layer_idx: int):
        super().__init__()
        self.cfg = cfg
        self.layer_idx = layer_idx
        self.is_global = cfg.is_global_layer(layer_idx)
        d, dt, ab = cfg.hidden_size, cfg.torch_dtype, cfg.attn_bias
        self.q_proj = Linear(d, cfg.num_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.k_proj = Linear(d, cfg.num_kv_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.v_proj = Linear(d, cfg.num_kv_heads * cfg.head_dim, use_bias=ab, dtype=dt)
        self.o_proj = Linear(cfg.num_heads * cfg.head_dim, d, use_bias=False, dtype=dt)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
        # QuaRot R3 (prepasses/rotate.py): a per-head orthogonal (head_dim,
        # head_dim) float64 matrix applied to q and k after RoPE, before the
        # cache write. Scores are unchanged ((qR)(kR)^T = qk^T); the cached K
        # rows are rotated.
        self.qk_rot: np.ndarray | None = None
        # Tensor-parallel replicate-slice markers (set by tp_localize when
        # 1 < num_kv_heads < tp): the K/V projections stay whole and produce
        # ``kv_proj_heads`` heads; each rank keeps the one KV head its query
        # shard attends to (head = axis index // dup).
        self.kv_proj_heads: int | None = None  # None: cfg.num_kv_heads
        self.kv_slice: tuple[str, int] | None = None  # (axis name, dup)
        # Context-parallel marker (parallel/cp.py): (axis name, axis size,
        # "ring" | "gather"); without a cache, attention runs over K/V blocks
        # split along the sequence over that axis.
        self.cp_spec: tuple[str, int, str] | None = None

    def _flash_ok(self, use_flash, x: torch.Tensor) -> bool:
        if use_flash is False:
            return False
        T = x.shape[1]
        tileable = T % 16 == 0 and self.cfg.head_dim % 16 == 0
        if use_flash is True:
            return tileable
        # "auto": the reference's rule, set on a TPU (PERF.md has the H100's
        # kernel-vs-plain times below T = 512).
        return tileable and T >= 512 and x.device.type == "cuda"

    def _qkv(self, params, x, positions, ctx=None):
        cfg = self.cfg
        B, T, _ = x.shape
        # Under replicate-slice TP the K/V projections emit every global KV
        # head; attention and the cache use cfg.num_kv_heads local ones.
        kv_proj_heads = self.kv_proj_heads or cfg.num_kv_heads
        if "_fused_qkv" in params:
            # Engine-load horizontal fusion (nn/fuse.py): one matmul.
            qkv = apply_linear(params["_fused_qkv"], x)
            n_q = cfg.num_heads * cfg.head_dim
            n_k = kv_proj_heads * cfg.head_dim
            q, k, v = qkv[..., :n_q], qkv[..., n_q:n_q + n_k], qkv[..., n_q + n_k:]
        else:
            q = self.q_proj(params["q_proj"], x, ctx=ctx)
            k = self.k_proj(params["k_proj"], x, ctx=ctx)
            v = self.v_proj(params["v_proj"], x, ctx=ctx)
        q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, T, kv_proj_heads, cfg.head_dim)
        v = v.reshape(B, T, kv_proj_heads, cfg.head_dim)
        if self.kv_slice is not None and kv_proj_heads != cfg.num_kv_heads:
            # GQA replicate-slice: this rank's query heads all attend to one
            # global KV head (contiguous query split keeps a group on a rank).
            from onnx_quantize_tpu_torch.parallel.comm import axis_index

            axis, dup = self.kv_slice
            head = axis_index(axis) // dup
            k = k[:, :, head:head + cfg.num_kv_heads]
            v = v[:, :, head:head + cfg.num_kv_heads]
        if cfg.use_qk_norm:
            q = self.q_norm(params["q_norm"], q)
            k = self.k_norm(params["k_norm"], k)
        base = cfg.rope_theta if self.is_global else cfg.rope_local_base
        q = apply_rope(q, positions, base, scaling=cfg.rope_scaling)
        k = apply_rope(k, positions, base, scaling=cfg.rope_scaling)
        q = q * (cfg.query_pre_attn_scalar ** -0.5)
        if self.qk_rot is not None:
            q = q @ _rotation_tensor(self, "qk_rot", q)
            k = k @ _rotation_tensor(self, "qk_rot", k)
        return q, k, v

    def forward(self, params, x, positions, mask, kv_write=None, use_flash="auto", ctx=None):
        """mask: (B, 1, T, S) additive float32 mask (0 / -1e30).

        ``kv_write(layer, k, v)``, from the engine, stores the new rows in the
        cache and returns what attention reads: a :class:`QuantizedKV` of the
        int8/int4 cache, or the float (k, v) cache. Without a cache, positions
        are the prefill layout (0..T-1) wherever the flash kernel runs; it
        rebuilds the causal and window mask from indices.
        """
        cfg = self.cfg
        B, T, _ = x.shape
        window = None if self.is_global else cfg.sliding_window
        q, k, v = self._qkv(params, x, positions, ctx)
        if self.cp_spec is not None and kv_write is None:
            # Context-parallel scoring: K/V blocks split along the sequence
            # over the axis; the attend rebuilds the causal/window visibility
            # from the global ``positions`` of each block it holds.
            if mask is not None:
                logger.warning(
                    "Gemma3Attention: the context-parallel attend ignores the supplied "
                    "mask and rebuilds the causal/sliding-window mask per block; custom "
                    "(e.g. padding) masks are not applied under CP.")
            from onnx_quantize_tpu_torch.parallel.cp import cp_attend

            axis, size, mode = self.cp_spec
            out = cp_attend(q, k, v, positions, cfg=cfg, is_global=self.is_global, axis=axis,
                            size=size, mode=mode)
            out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
            return self.o_proj(params["o_proj"], out.to(x.dtype), ctx=ctx)
        if kv_write is not None:
            kv = kv_write(self.layer_idx, k, v)
            if isinstance(kv, QuantizedKV) and kv.use_kernel:
                # One-token step over the raw int8 cache in one kernel (T == 1).
                out = flash_decode.flash_decode_int8(
                    q[:, 0].to(torch.float32), kv.k, kv.k_scale, kv.v, kv.v_scale,
                    positions[:, 0].to(torch.int32), window=window)
                out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
                return self.o_proj(params["o_proj"], out.to(x.dtype), ctx=ctx)
            if isinstance(kv, QuantizedKV):
                out = _attend(q, kv.k_ints(), kv.v_ints(), mask, cfg, kv.k_scale, kv.v_scale)
                return self.o_proj(params["o_proj"], out.to(x.dtype), ctx=ctx)
            k, v = kv
        elif self._flash_ok(use_flash, x):
            out = flash_attention.flash_attention(q, k, v, sliding_window=window)
            return self.o_proj(params["o_proj"], out.reshape(B, T, cfg.num_heads * cfg.head_dim),
                               ctx=ctx)
        out = _attend(q, k, v, mask, cfg)
        return self.o_proj(params["o_proj"], out, ctx=ctx)


class Gemma3MLP(Module):
    def __init__(self, cfg: Gemma3Config):
        super().__init__()
        d, i, dt = cfg.hidden_size, cfg.intermediate_size, cfg.torch_dtype
        self.activation = cfg.mlp_activation
        self.gate_proj = Linear(d, i, use_bias=False, dtype=dt)
        self.up_proj = Linear(d, i, use_bias=False, dtype=dt)
        self.down_proj = Linear(i, d, use_bias=False, dtype=dt)
        # Set by the engine's ``mlp_megakernel``: a decode-sized MLP over two
        # packed W4 weights runs as one fused kernel (ops/kernels/mlp_w4.py).
        self.use_megakernel = False
        # QuaRot R4 (prepasses/rotate.py): a (block, block) float64 Hadamard
        # applied to each block of the down_proj input (its transpose folded
        # into down_proj's rows).
        self.down_rot: np.ndarray | None = None

    def forward(self, params, x, ctx=None):
        if "_fused_gate_up" in params:
            w = params["_fused_gate_up"]["w"]
            dn = params["down_proj"].get("w")
            # The fused kernel computes GeGLU only and has no hook for
            # down_proj's input prescale, the online R4 rotation or the
            # row-parallel all-reduce.
            if (self.use_megakernel and self.activation == "gelu_tanh"
                    and isinstance(w, QTensor) and isinstance(dn, QTensor)
                    and "prescale" not in params["down_proj"] and self.down_rot is None
                    and self.down_proj.tp_reduce is None):
                M = int(np.prod(x.shape[:-1]))
                if mlp_w4.mlp_w4_eligible(w, dn, M):
                    return mlp_w4.mlp_w4_fused(x, w, dn).to(x.dtype)
            gu = apply_linear(params["_fused_gate_up"], x)
            n_gate = gu.shape[-1] // 2
            gate, up = gu[..., :n_gate], gu[..., n_gate:]
        else:
            gate = self.gate_proj(params["gate_proj"], x, ctx=ctx)
            up = self.up_proj(params["up_proj"], x, ctx=ctx)
        act = glu_activation(gate, up, self.activation)
        if self.down_rot is not None:
            r = _rotation_tensor(self, "down_rot", act)
            shape = act.shape
            act = (act.reshape(*shape[:-1], shape[-1] // r.shape[0], r.shape[0]) @ r).reshape(shape)
        return self.down_proj(params["down_proj"], act, ctx=ctx)


def glu_activation(gate: torch.Tensor, up: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return torch.nn.functional.silu(gate) * up
    return torch.nn.functional.gelu(gate, approximate="tanh") * up


def _expert_slice(site: dict, e: int) -> dict:
    """Expert ``e``'s view of a stacked site dict (leading axis = expert): each
    tensor of a QTensor is indexed, its meta (the per-expert shape) kept."""
    out = {}
    for key, leaf in site.items():
        if isinstance(leaf, QTensor):
            out[key] = dataclasses.replace(leaf, **{
                f.name: None if getattr(leaf, f.name) is None else getattr(leaf, f.name)[e]
                for f in dataclasses.fields(leaf) if f.name != "meta"})
        else:
            out[key] = None if leaf is None else leaf[e]
    return out


def stacked_expert_mlp(stacked: dict, e: int, x: torch.Tensor, activation: str) -> torch.Tensor:
    """One expert's gated MLP from a stacked site dict (the engine layout).
    Each site runs ``apply_linear`` (the JAX package's ``apply_site``)."""
    if "gate_up" in stacked:
        gu = apply_linear(_expert_slice(stacked["gate_up"], e), x)
        n = gu.shape[-1] // 2
        gate, up = gu[..., :n], gu[..., n:]
    else:
        gate = apply_linear(_expert_slice(stacked["gate"], e), x)
        up = apply_linear(_expert_slice(stacked["up"], e), x)
    return apply_linear(_expert_slice(stacked["down"], e), glu_activation(gate, up, activation))


def top_k_lower_index(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis in descending order, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none, and bf16 router logits tie exactly)."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


# The ragged prefill's "auto" rule on CUDA: a prompt's forward (more than one
# token a row) takes the sorted grouped matmuls in place of the dense-masked
# experts from these rows M on, from the stacked and from the fused layout.
# Measured on an H100 at Qwen1.5-MoE-A2.7B's widths (chip_smoke.py phase 4d,
# arm (f); PERF.md section 7): the least M measured from which the ragged
# layer is the faster at every larger M measured. A decode step (one token a
# row) keeps its experts on the kernels at any batch: the ragged path fetches
# each layer's group sizes to the host, and ``InferenceEngine.serve_chunk``
# turns "auto" off for its admissions, whose round queues with no host sync.
RAGGED_MIN_M = {"stacked": 8, "fused": 1024}


class Gemma3MoEMLP(Module):
    """Sparse Mixture-of-Experts MLP (the Mixtral/Qwen-MoE conventions).

    Counterpart of the JAX package's ``Gemma3MoEMLP``. Routing: the router
    in the stream dtype, a float32 softmax, the top-k experts (the lower
    index first on ties), optionally renormalized (``cfg.norm_topk_prob``).
    Every expert is a :class:`Gemma3MLP` in the ModuleList ``experts``, so
    its projections are sites ``layers.{i}.mlp.experts.{e}.gate_proj`` etc.;
    Qwen's shared expert ``shared`` is added through a sigmoid gate
    ``shared_gate``.

    Execution is dense-masked: each expert runs over all rows with its
    unrouted rows zeroed (so its calibration taps see only its routed
    tokens), and the outputs combine in float32 with the routing weights, in
    expert order. Three parameter layouts:

    * ``experts.{e}`` subtrees (what ``init`` and ``quantize`` make): the
      per-expert loop;
    * ``_stacked_experts`` (``models.moe.stack_moe_experts``): site dicts
      with a leading expert axis, the same loop over per-expert views;
    * ``_fused_experts`` (``models.moe.fuse_moe_experts``): every expert's
      gate/up in one matmul along N, the routing weight folded into each
      expert's activation segment, and one down matmul along K whose
      accumulator sums the experts.

    ``use_ragged_prefill`` (True, False or "auto") runs the stacked or fused
    experts over the sorted routed rows only: one ``torch.matmul`` per expert
    on weights dequantized once in the stream dtype, which costs one host
    fetch of the group sizes per layer (counted in ``host_fetches``). "auto"
    takes it on CUDA for a forward of more than one token a row over at
    least ``RAGGED_MIN_M`` rows, and never on the CPU. The
    engine's fused-MLP hook never takes an MoE MLP: the experts' and the
    shared expert's ``use_megakernel`` stay False.
    """

    def __init__(self, cfg: Gemma3Config):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden_size, cfg.torch_dtype
        self.activation = cfg.mlp_activation
        self.inter = cfg.moe_intermediate_size or cfg.intermediate_size
        expert_cfg = dataclasses.replace(cfg, intermediate_size=self.inter)
        self.router = Linear(d, cfg.num_experts, use_bias=False, dtype=dt)
        self.experts = torch.nn.ModuleList(Gemma3MLP(expert_cfg) for _ in range(cfg.num_experts))
        if cfg.shared_expert_size:
            shared_cfg = dataclasses.replace(cfg, intermediate_size=cfg.shared_expert_size)
            self.shared = Gemma3MLP(shared_cfg)
            self.shared_gate = Linear(d, 1, use_bias=False, dtype=dt)
        self.use_ragged_prefill: bool | str = "auto"
        self.host_fetches = 0
        # Expert-parallel marker (set by tp_localize): the stacked experts'
        # leading axis (or the fused layout's columns) is split over this mesh
        # axis; local expert e is global expert axis index * local + e, and
        # one all-reduce sums the combine. The ragged path is off under it.
        self.ep_axis: str | None = None

    @staticmethod
    def _ragged_compatible(layout: dict) -> bool:
        """The ragged path runs float matmuls on dequantized weights: only
        weight-only QDQ sites keep their semantics there."""
        for site in layout.values():
            w = site.get("w")
            if isinstance(w, QTensor) and (
                    w.meta.fmt != QFormat.QDQ or w.meta.input_quant.mode != "none"
                    or w.meta.output_quant.mode != "none"):
                return False
        return True

    def _ragged_ok(self, layout, shape: tuple, device: torch.device,
                   fused_source: bool = False) -> bool:
        """Whether a forward over input of ``shape`` (B, T, d) takes the ragged path."""
        mode = self.use_ragged_prefill
        if (mode is False or layout is None or self.ep_axis is not None
                or not self._ragged_compatible(layout)):
            return False
        if mode is True:
            return True
        M = math.prod(shape[:-1])
        return (device.type == "cuda" and len(shape) == 3 and shape[1] > 1
                and M >= RAGGED_MIN_M["fused" if fused_source else "stacked"])

    @staticmethod
    def _dense_stack(site: dict, dtype: torch.dtype) -> torch.Tensor:
        """A stacked site as dense (E, K, N) weights in the stream dtype,
        dequantized once, expert by expert."""
        w = site["w"]
        if isinstance(w, QTensor):
            return torch.stack([dequantize_weight(_expert_slice(site, e)["w"])
                                for e in range(w.data.shape[0])]).to(dtype)
        return w.to(dtype)

    @staticmethod
    def _fused_to_stacked_dense(fused: dict, inter: int) -> dict:
        """Dense per-expert (E, K, 2I) gate_up and (E, I, d) down of the fused layout."""
        def dense(site):
            w = site["w"]
            return dequantize_weight(w) if isinstance(w, QTensor) else w

        gu = dense(fused["gate_up"])
        gu = gu.reshape(gu.shape[0], -1, 2 * inter).permute(1, 0, 2)
        dn = dense(fused["down"])
        return {"gate_up": {"w": gu}, "down": {"w": dn.reshape(-1, inter, dn.shape[-1])}}

    def _experts_ragged(self, stacked: dict, x, top_p, top_i) -> torch.Tensor:
        """The routed (token, choice) rows sorted by expert, one matmul per
        expert over its rows, then each token's k contributions summed in
        float32 in expert order, as the loop sums them (an ordered sum, not
        an atomic scatter-add)."""
        d = x.shape[-1]
        k = top_i.shape[-1]
        M = top_i.numel() // k
        flat_e = top_i.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        xs = x.reshape(M, d)[order // k]
        sizes = torch.bincount(flat_e, minlength=self.cfg.num_experts).tolist()  # the host fetch
        self.host_fetches += 1

        def grouped(site, rows):
            ps = site.get("prescale")
            if ps is not None:
                rows = (rows * ps[sorted_e]).to(rows.dtype)
            w = self._dense_stack(site, x.dtype)
            out = rows.new_empty((rows.shape[0], w.shape[-1]))
            start = 0
            for e, n in enumerate(sizes):
                if n:
                    out[start:start + n] = torch.matmul(rows[start:start + n], w[e])
                start += n
            return out

        if "gate_up" in stacked:
            gu = grouped(stacked["gate_up"], xs)
            n = gu.shape[-1] // 2
            gate, up = gu[..., :n], gu[..., n:]
        else:
            gate, up = grouped(stacked["gate"], xs), grouped(stacked["up"], xs)
        ys = grouped(stacked["down"], glu_activation(gate, up, self.activation))
        contrib = torch.empty((M * k, d), dtype=torch.float32, device=x.device)
        contrib[order] = ys.to(torch.float32) * top_p.reshape(-1)[order, None]
        rank = torch.argsort(top_i.reshape(M, k), dim=-1)
        contrib = contrib.reshape(M, k, d).gather(1, rank[..., None].expand(M, k, d))
        out = torch.zeros((M, d), dtype=torch.float32, device=x.device)
        for j in range(k):
            out = out + contrib[:, j]
        return out.reshape(*x.shape[:-1], d)

    def _routing(self, params, x, ctx=None):
        logits = self.router(params["router"], x, ctx=ctx).to(torch.float32)
        top_p, top_i = top_k_lower_index(torch.softmax(logits, dim=-1),
                                         self.cfg.num_experts_per_tok)
        if self.cfg.norm_topk_prob:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        return top_p, top_i

    @staticmethod
    def _combine_weights(top_p, top_i, num_experts: int) -> torch.Tensor:
        """(..., E) float32 combine weights: the routing weight where chosen, else 0."""
        zeros = top_p.new_zeros((*top_p.shape[:-1], num_experts))
        return zeros.scatter(-1, top_i, top_p)

    def _local_experts(self, n_local: int, combine: torch.Tensor) -> torch.Tensor:
        """The combine weights of this rank's experts (all of them without EP)."""
        if self.ep_axis is None:
            return combine
        from onnx_quantize_tpu_torch.parallel.comm import axis_index

        base = axis_index(self.ep_axis) * n_local
        return combine[..., base:base + n_local]

    def _experts_fused(self, fused: dict, x, combine) -> torch.Tensor:
        """Under EP the two sites are the Megatron column/row pair and the
        all-reduce is the combine across ranks."""
        gu = apply_linear(fused["gate_up"], x)  # (..., E_local * 2I)
        gu = gu.reshape(*gu.shape[:-1], -1, 2 * self.inter)
        act = glu_activation(gu[..., :self.inter], gu[..., self.inter:], self.activation)
        act = act * self._local_experts(gu.shape[-2], combine)[..., None].to(act.dtype)
        out = apply_linear(fused["down"], act.reshape(*x.shape[:-1], -1))
        if self.ep_axis is not None:
            from onnx_quantize_tpu_torch.parallel.comm import all_reduce

            out = all_reduce(out.to(torch.float32), self.ep_axis)
        return out.to(x.dtype)

    def forward(self, params, x, ctx=None):
        cfg = self.cfg
        top_p, top_i = self._routing(params, x, ctx)
        stacked = params.get("_stacked_experts")
        fused = params.get("_fused_experts")
        source = stacked if stacked is not None else fused
        from_fused = stacked is None and fused is not None
        if self._ragged_ok(source, tuple(x.shape), x.device, from_fused):
            if from_fused:
                source = self._fused_to_stacked_dense(fused, self.inter)
            out = self._experts_ragged(source, x, top_p, top_i).to(x.dtype)
            return self._shared_out(params, x, out, ctx)
        combine = self._combine_weights(top_p, top_i, cfg.num_experts)
        if fused is not None:
            return self._shared_out(params, x, self._experts_fused(fused, x, combine), ctx)
        out = torch.zeros((*x.shape[:-1], cfg.hidden_size), dtype=torch.float32,
                          device=x.device)
        if stacked is not None:
            down = stacked["down"]["w"]
            n_local = (down.data if isinstance(down, QTensor) else down).shape[0]
            combine = self._local_experts(n_local, combine)
        for e in range(combine.shape[-1]):
            w_e = combine[..., e]
            xe = x * (w_e > 0).to(x.dtype)[..., None]
            if stacked is not None:
                ye = stacked_expert_mlp(stacked, e, xe, self.activation)
            else:
                ye = self.experts[e](params[f"experts.{e}"], xe, ctx=ctx)
            out = out + ye.to(torch.float32) * w_e[..., None]
        if stacked is not None and self.ep_axis is not None:
            from onnx_quantize_tpu_torch.parallel.comm import all_reduce

            out = all_reduce(out, self.ep_axis)
        return self._shared_out(params, x, out.to(x.dtype), ctx)

    def _shared_out(self, params, x, out, ctx):
        if not self.cfg.shared_expert_size:
            return out
        gate = self.shared_gate(params["shared_gate"], x, ctx=ctx)
        shared = self.shared(params["shared"], x, ctx=ctx)
        return out + (torch.sigmoid(gate.to(torch.float32))
                      * shared.to(torch.float32)).to(x.dtype)


class Gemma3Block(Module):
    def __init__(self, cfg: Gemma3Config, layer_idx: int):
        super().__init__()
        d, eps, dt, one_plus = (cfg.hidden_size, cfg.rms_norm_eps, cfg.torch_dtype,
                                cfg.rms_one_plus)
        self.attn = Gemma3Attention(cfg, layer_idx)
        self.mlp = Gemma3MoEMLP(cfg) if cfg.num_experts > 0 else Gemma3MLP(cfg)
        self.input_norm = RMSNorm(d, eps, dtype=dt, one_plus=one_plus)
        self.pre_ffn_norm = RMSNorm(d, eps, dtype=dt, one_plus=one_plus)
        self.sandwich = cfg.sandwich_norms
        if self.sandwich:
            self.post_attn_norm = RMSNorm(d, eps, dtype=dt, one_plus=one_plus)
            self.post_ffn_norm = RMSNorm(d, eps, dtype=dt, one_plus=one_plus)

    def forward(self, params, x, positions, mask, kv_write=None, use_flash="auto", ctx=None):
        h = self.input_norm(params["input_norm"], x)
        h = self.attn(params["attn"], h, positions, mask, kv_write=kv_write, use_flash=use_flash,
                      ctx=ctx)
        if self.sandwich:
            h = self.post_attn_norm(params["post_attn_norm"], h)
        x = x + h
        h = self.pre_ffn_norm(params["pre_ffn_norm"], x)
        h = self.mlp(params["mlp"], h, ctx=ctx)
        if self.sandwich:
            h = self.post_ffn_norm(params["post_ffn_norm"], h)
        return x + h


def make_attention_valid(cfg: Gemma3Config, positions, kv_positions, is_global: bool):
    """Boolean visibility (B, 1, T, S): causal, plus the sliding window on
    local layers. The one source of both the additive mask and the block skip
    of the context-parallel ring (parallel/cp.py)."""
    valid = kv_positions[:, None, :] <= positions[:, :, None]
    if not is_global:
        valid &= kv_positions[:, None, :] > positions[:, :, None] - cfg.sliding_window
    return valid[:, None, :, :]


def make_attention_mask(cfg: Gemma3Config, positions, kv_positions, is_global: bool):
    """Additive mask (B, 1, T, S): 0 where visible, -1e30 where masked."""
    valid = make_attention_valid(cfg, positions, kv_positions, is_global)
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    return torch.where(valid, zero, -1e30)


def fuse_gemma3_projections(params: dict) -> dict:
    """Engine-load transform: fuse q/k/v and gate/up per layer when eligible.

    Apply after quantization. Returns a new params tree; the input is left
    untouched."""
    from onnx_quantize_tpu_torch.nn.fuse import can_fuse, fuse_sites

    params = copy_tree(params)
    for layer in params.values():
        if not (isinstance(layer, dict) and "attn" in layer):
            continue
        attn = layer["attn"]
        trio = [attn.get("q_proj"), attn.get("k_proj"), attn.get("v_proj")]
        if all(t is not None for t in trio) and can_fuse(trio):
            attn["_fused_qkv"] = {"w": fuse_sites(trio)[0]}
            for key in ("q_proj", "k_proj", "v_proj"):
                del attn[key]
        # The dense MLP, every MoE expert and the shared expert: each pair alone.
        mlp = layer["mlp"]
        subs = [mlp] + [v for k, v in mlp.items()
                        if isinstance(v, dict) and (k.startswith("experts.") or k == "shared")]
        for sub in subs:
            duo = [sub.get("gate_proj"), sub.get("up_proj")]
            if all(t is not None for t in duo) and can_fuse(duo):
                sub["_fused_gate_up"] = {"w": fuse_sites(duo)[0]}
                for key in ("gate_proj", "up_proj"):
                    del sub[key]
    return params


class Gemma3(Module):
    """Full Gemma-3 causal LM. ``forward`` returns logits (B, T, vocab) in the
    stream dtype."""

    def __init__(self, cfg: Gemma3Config = GEMMA3_270M):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dt)
        self.layers = torch.nn.ModuleList(Gemma3Block(cfg, i) for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype=dt,
                                  one_plus=cfg.rms_one_plus)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, use_bias=False, dtype=dt)
        # Attention for the full-sequence (no-cache) path: "auto" (the
        # flash-attention kernel on CUDA at T >= 512), True, or False.
        self.use_flash: bool | str = "auto"
        # Tensor-parallel marker (set by tp_localize): all-gather the
        # vocab-split logits over this mesh axis at the very end.
        self._tp_gather_logits: str | None = None
        self.input_specs = [InputSpec("input_ids", (8,), np.int32)]
        self.finalize()

    def init(self, generator: torch.Generator) -> dict:
        params = super().init(generator)
        if self.cfg.tie_lm_head:
            # Tie lm_head to the embedding (a transposed view of the same memory).
            params["lm_head"] = {"w": params["embed"]["w"].T}
        return params

    def hidden_states(self, params, input_ids, positions=None, kv_write=None,
                      kv_positions=None, ctx=None):
        cfg = self.cfg
        B, T = input_ids.shape
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=input_ids.device)[None, :].expand(B, T)
        if kv_positions is None:
            kv_positions = positions
        x = self.embed(params["embed"], input_ids)
        if cfg.scale_embeddings:
            x = x * math.sqrt(cfg.hidden_size)
        x = x.to(cfg.torch_dtype)
        # Under context parallelism each block of the ring builds its own
        # visibility from the global positions: no mask here.
        if kv_write is None and len(self.layers) and self.layers[0].attn.cp_spec is not None:
            mask_local = mask_global = None
        else:
            mask_local = make_attention_mask(cfg, positions, kv_positions, is_global=False)
            mask_global = make_attention_mask(cfg, positions, kv_positions, is_global=True)
        for i, block in enumerate(self.layers):
            mask = mask_global if cfg.is_global_layer(i) else mask_local
            x = block(params[f"layers.{i}"], x, positions, mask, kv_write=kv_write,
                      use_flash=self.use_flash, ctx=ctx)
        return self.final_norm(params["final_norm"], x)

    def forward(self, params, input_ids, positions=None, kv_write=None, kv_positions=None,
                ctx=None):
        x = self.hidden_states(params, input_ids, positions=positions, kv_write=kv_write,
                               kv_positions=kv_positions, ctx=ctx)
        return self.logits(params, x, ctx=ctx)

    def logits(self, params, hidden, ctx=None):
        """The lm_head over final hidden states; under TP, the vocab-split
        logits all-gathered (the only gather of the TP forward)."""
        logits = self.lm_head(params["lm_head"], hidden, ctx=ctx)
        if self._tp_gather_logits is not None:
            from onnx_quantize_tpu_torch.parallel.comm import all_gather

            logits = all_gather(logits, self._tp_gather_logits, dim=logits.ndim - 1)
        return logits

    def tp_localize(self, tp: int, axis: str = "model"):
        """Per-rank model and sharding rules for whole-model TP.

        Returns ``(local_model, rules)``: the local model has
        ``num_heads / tp`` query heads; KV heads split when ``num_kv_heads %
        tp == 0``, replicate and slice (each rank keeps the KV head its query
        shard attends to) when ``1 < num_kv_heads < tp`` and ``tp %
        num_kv_heads == 0``, and replicate for MQA; row-parallel all-reduce
        markers on o_proj/down_proj (MoE: expert parallelism over the same
        axis, the shared expert as a Megatron pair), a vocab-split embedding
        and the logits all-gather. Run it on params localized by
        ``parallel.tp.localize_params`` and sliced by the rules' specs.
        """
        cfg = self.cfg
        if tp == 1:
            return self, [(r".*", "replicate")]
        if cfg.num_heads % tp != 0:
            raise ValueError(f"num_heads={cfg.num_heads} not divisible by tp={tp}")
        kv_sharded = cfg.num_kv_heads % tp == 0
        kv_sliced = not kv_sharded and cfg.num_kv_heads > 1 and tp % cfg.num_kv_heads == 0
        if not kv_sharded and not kv_sliced and cfg.num_kv_heads != 1:
            raise ValueError(
                f"num_kv_heads={cfg.num_kv_heads} must divide tp, be divisible "
                f"by tp, or equal 1 (got tp={tp}: GQA groups would straddle "
                "device boundaries)")
        local_kv = (cfg.num_kv_heads // tp if kv_sharded
                    else 1 if kv_sliced else cfg.num_kv_heads)
        local = Gemma3(dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                           num_kv_heads=local_kv))
        moe = cfg.num_experts > 0
        if moe and cfg.num_experts % tp != 0:
            raise ValueError(f"num_experts={cfg.num_experts} not divisible by tp={tp}")
        for block in local.layers:
            block.attn.o_proj.tp_reduce = axis
            if moe:
                block.mlp.ep_axis = axis
                if cfg.shared_expert_size:
                    block.mlp.shared.down_proj.tp_reduce = axis
            else:
                block.mlp.down_proj.tp_reduce = axis
            if kv_sliced:
                block.attn.kv_proj_heads = cfg.num_kv_heads
                block.attn.kv_slice = (axis, tp // cfg.num_kv_heads)
        local.embed.tp_vocab_axis = axis
        local._tp_gather_logits = axis
        kv_kind = "column" if kv_sharded else "replicate"
        # Fused kinds carry their segments so localize_params can permute the
        # columns into per-rank [q_i|k_i|v_i] chunks.
        n_q = cfg.num_heads * cfg.head_dim
        n_kv = cfg.num_kv_heads * cfg.head_dim
        qkv_fused = ("fused_column", ((n_q, "column"), (n_kv, kv_kind), (n_kv, kv_kind)))
        rules = [
            (r"\.attn\._fused_qkv$", qkv_fused),
            (r"\.attn\.q_proj$", "column"),
            (r"\.attn\.(k_proj|v_proj)$", kv_kind),
            (r"\.attn\.o_proj$", "row"),
            (r"^lm_head$", "column"),
            (r"^embed$", "vocab"),
        ]
        if moe:
            shared = cfg.shared_expert_size
            rules += [
                # The concatenated experts (fuse_moe_experts) are the Megatron
                # pair: gate_up split along N in whole experts, down along K.
                (r"\.mlp\._fused_experts\.gate_up$", "column"),
                (r"\.mlp\._fused_experts\.down$", "row"),
                # Stacked experts split their leading axis; the router, the
                # shared gate and unstacked experts replicate.
                (r"\.mlp\._stacked_experts", "expert"),
                (r"\.mlp\.router$", "replicate"),
                (r"\.mlp\.shared_gate$", "replicate"),
                (r"\.mlp\.shared\._fused_gate_up$",
                 ("fused_column", ((shared, "column"), (shared, "column")))),
                (r"\.mlp\.shared\.(gate_proj|up_proj)$", "column"),
                (r"\.mlp\.shared\.down_proj$", "row"),
                (r"\.mlp\.experts\.", "replicate"),
            ]
        else:
            inter = cfg.intermediate_size
            rules += [
                (r"\.mlp\._fused_gate_up$", ("fused_column", ((inter, "column"),
                                                               (inter, "column")))),
                (r"\.mlp\.(gate_proj|up_proj)$", "column"),
                (r"\.mlp\.down_proj$", "row"),
            ]
        return local, rules
