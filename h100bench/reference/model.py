"""The configurations' decoder in plain float32 torch, layer by layer.

The Llama/Mixtral/Qwen-MoE conventions as their Hugging Face modelling
files write them: pre-norm RMSNorm (gain w, float32), q/k/v (with biases
where the configuration has them), rotate-half RoPE, softmax attention
scaled by head_dim^-0.5 with grouped KV heads, a softmax router over the
experts, the top-k experts (the lower index first on ties), renormalized
where ``norm_topk_prob`` says so, each expert SiLU(x Wg) * (x Wu) Wd, and
Qwen's shared expert behind a sigmoid gate. Weights are the seed's floats
(``benchlib.weights``) quantized again by this package's RTN and
dequantized to float32; the KV rows go through the configuration's int8
cache (per token and head, symmetric, absmax / 127) before attention reads
them, as the configuration states. Matmuls run in float32 with TF32 off.

``precision`` selects the control: ``"fp8"`` rounds every Linear input to
float8 e4m3 (per-row absmax / 448), ``"kv4"`` keeps a 4-bit KV cache
(absmax / 7). Neither is the configuration; both are the steps below it
that a later change could be tempted to take.
"""

from __future__ import annotations

import contextlib

import torch

from h100bench.benchlib import weights
from h100bench.reference import rtn

__all__ = ["Reference", "no_tf32"]


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, H, D) at positions 0..T-1."""
    t, _, d = x.shape
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) * (2.0 / d)))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _kv_round(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Per (token, head) symmetric rounding to +-levels, as the cache holds it."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / levels, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 448.0, torch.ones_like(absmax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """Float32 forward of a configuration's quantized model from the seed."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "reference"):
        if precision not in ("reference", "fp8", "kv4"):
            raise ValueError(f"unknown precision {precision!r}")
        self.s = weights.Shapes(cfg)
        self.recipe = cfg["recipe"]
        self.seed, self.device, self.precision = seed, torch.device(device), precision
        self.draw = getattr(torch, cfg["torch_dtype"])  # the dtype the weights are served in
        self.kv_levels = 7 if precision == "kv4" else 127

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.precision == "fp8" else x

    def _lin(self, x, w, b=None):
        y = self._act(x) @ w
        return y if b is None else y + b

    def _layer_weights(self, i: int) -> dict:
        leaves = weights.layer_leaves(self.s, self.seed, i, self.device, self.draw)
        gs = self.recipe["body"]["group_size"]
        out = {}
        for name, w in leaves["w"].items():
            if name in ("mlp.router", "mlp.shared_gate"):
                out[name] = w.to(torch.float32)  # left in float by the recipe
            else:
                out[name] = rtn.dequant_uint4_group(w, gs)
        bias = {name: b.to(torch.float32) for name, b in leaves["b"].items()}
        return {"w": out, "b": bias}

    def _attention(self, x: torch.Tensor, w: dict, b: dict) -> torch.Tensor:
        s = self.s
        t = x.shape[0]
        q = self._lin(x, w["attn.q_proj"], b.get("attn.q_proj")).view(t, s.heads, s.head_dim)
        k = self._lin(x, w["attn.k_proj"], b.get("attn.k_proj")).view(t, s.kv_heads, s.head_dim)
        v = self._lin(x, w["attn.v_proj"], b.get("attn.v_proj")).view(t, s.kv_heads, s.head_dim)
        q = _rope(q, s.rope_theta) * (s.head_dim ** -0.5)
        k = _rope(k, s.rope_theta)
        k, v = _kv_round(k, self.kv_levels), _kv_round(v, self.kv_levels)
        g = s.heads // s.kv_heads
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("thd,shd->hts", q, k)
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v)
        return self._lin(out.reshape(t, s.heads * s.head_dim), w["attn.o_proj"])

    def _moe(self, x: torch.Tensor, w: dict) -> torch.Tensor:
        s = self.s
        probs = torch.softmax(self._lin(x, w["mlp.router"]), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :s.top_k], top_i[:, :s.top_k]
        if s.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(s.experts):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            h = (torch.nn.functional.silu(self._lin(xe, w[f"mlp.experts.{e}.gate_proj"]))
                 * self._lin(xe, w[f"mlp.experts.{e}.up_proj"]))
            out.index_add_(0, rows, self._lin(h, w[f"mlp.experts.{e}.down_proj"])
                           * top_p[rows, slot][:, None])
        if s.shared_width:
            h = (torch.nn.functional.silu(self._lin(x, w["mlp.shared.gate_proj"]))
                 * self._lin(x, w["mlp.shared.up_proj"]))
            gate = torch.sigmoid(self._lin(x, w["mlp.shared_gate"]))
            out = out + gate * self._lin(h, w["mlp.shared.down_proj"])
        return out

    @torch.no_grad()
    def final_hidden(self, seqs: list[list[int]]) -> list[torch.Tensor]:
        """Each sequence's final normed hidden states (T, hidden), float32."""
        s = self.s
        with no_tf32():
            embed = weights.embed_weight(s, self.seed, self.device, self.draw)
            ids = [torch.as_tensor(q, dtype=torch.long, device=self.device) for q in seqs]
            xs = [embed[i].to(torch.float32) for i in ids]
            del embed
            for layer in range(s.layers):
                lw = self._layer_weights(layer)
                xs = [x + self._attention(_rms(x, s.eps), lw["w"], lw["b"]) for x in xs]
                lens = [x.shape[0] for x in xs]
                flat = torch.cat(xs)
                flat = flat + self._moe(_rms(flat, s.eps), lw["w"])
                xs = list(torch.split(flat, lens))
                del lw, flat
            return [_rms(x, s.eps) for x in xs]

    @torch.no_grad()
    def lm_head(self) -> torch.Tensor:
        """The int8 lm_head dequantized, (hidden, vocab) float32."""
        return rtn.dequant_int8_channel(weights.lm_head_weight(self.s, self.seed, self.device,
                                                             self.draw))

    def logits(self, hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self._lin(hidden, head)
