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
Tensor, context and expert parallelism and MoE are not ported yet
(ROADMAP.md, Queue A items 11 and 14).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from onnx_quantize_tpu_torch.engine.kv_cache import QuantizedKV
from onnx_quantize_tpu_torch.nn.layers import Embedding, RMSNorm, apply_rope
from onnx_quantize_tpu_torch.nn.module import InputSpec, Linear, Module, apply_linear
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import flash_attention, flash_decode, mlp_w4
from onnx_quantize_tpu_torch.utils import copy_tree

__all__ = ["Gemma3Config", "Gemma3", "GEMMA3_270M", "make_attention_mask",
           "fuse_gemma3_projections"]


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
        if "_fused_qkv" in params:
            # Engine-load horizontal fusion (nn/fuse.py): one matmul.
            qkv = apply_linear(params["_fused_qkv"], x)
            n_q = cfg.num_heads * cfg.head_dim
            n_k = cfg.num_kv_heads * cfg.head_dim
            q, k, v = qkv[..., :n_q], qkv[..., n_q:n_q + n_k], qkv[..., n_q + n_k:]
        else:
            q = self.q_proj(params["q_proj"], x, ctx=ctx)
            k = self.k_proj(params["k_proj"], x, ctx=ctx)
            v = self.v_proj(params["v_proj"], x, ctx=ctx)
        q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
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
            # down_proj's input prescale or the online R4 rotation.
            if (self.use_megakernel and self.activation == "gelu_tanh"
                    and isinstance(w, QTensor) and isinstance(dn, QTensor)
                    and "prescale" not in params["down_proj"] and self.down_rot is None):
                M = int(np.prod(x.shape[:-1]))
                if mlp_w4.mlp_w4_eligible(w, dn, M):
                    return mlp_w4.mlp_w4_fused(x, w, dn).to(x.dtype)
            gu = apply_linear(params["_fused_gate_up"], x)
            n_gate = gu.shape[-1] // 2
            gate, up = gu[..., :n_gate], gu[..., n_gate:]
        else:
            gate = self.gate_proj(params["gate_proj"], x, ctx=ctx)
            up = self.up_proj(params["up_proj"], x, ctx=ctx)
        if self.activation == "silu":
            act = torch.nn.functional.silu(gate) * up
        else:
            act = torch.nn.functional.gelu(gate, approximate="tanh") * up
        if self.down_rot is not None:
            r = _rotation_tensor(self, "down_rot", act)
            shape = act.shape
            act = (act.reshape(*shape[:-1], shape[-1] // r.shape[0], r.shape[0]) @ r).reshape(shape)
        return self.down_proj(params["down_proj"], act, ctx=ctx)


class Gemma3Block(Module):
    def __init__(self, cfg: Gemma3Config, layer_idx: int):
        super().__init__()
        d, eps, dt, one_plus = (cfg.hidden_size, cfg.rms_norm_eps, cfg.torch_dtype,
                                cfg.rms_one_plus)
        self.attn = Gemma3Attention(cfg, layer_idx)
        self.mlp = Gemma3MLP(cfg)
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


def make_attention_mask(cfg: Gemma3Config, positions, kv_positions, is_global: bool):
    """Additive mask (B, 1, T, S): 0 where visible (causal, plus the sliding
    window on local layers), -1e30 where masked."""
    valid = kv_positions[:, None, :] <= positions[:, :, None]
    if not is_global:
        valid &= kv_positions[:, None, :] > positions[:, :, None] - cfg.sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    return torch.where(valid, zero, -1e30)[:, None, :, :]


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
        mlp = layer["mlp"]
        duo = [mlp.get("gate_proj"), mlp.get("up_proj")]
        if all(t is not None for t in duo) and can_fuse(duo):
            mlp["_fused_gate_up"] = {"w": fuse_sites(duo)[0]}
            for key in ("gate_proj", "up_proj"):
                del mlp[key]
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
        return self.lm_head(params["lm_head"], x, ctx=ctx)
