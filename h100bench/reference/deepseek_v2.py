"""A DeepSeek-V2 configuration's decoder in plain float32 torch, layer by
layer, in the published form.

It follows ``modeling_deepseek.py`` of the DeepSeek-V2-Lite checkpoint and
the paper's section 2.1, and takes nothing of the port: pre-norm RMSNorm
(gain w, float32); attention decompressed per head, ``q = x Wq`` split into
``q_nope`` and ``q_pe``, ``[c ; k_pe] = x Wkv_a`` with ``c`` normalized by
``kv_a_layernorm``, ``[k_nope ; v] = c Wkv_b`` per head, RoPE over adjacent
pairs (2i, 2i + 1) with YaRN frequencies, ``k = [k_nope ; k_pe]``, causal
softmax at ``(nope + rope) ** -0.5 x mscale ** 2``; the first
``first_k_dense_replace`` layers a SiLU MLP, the others a float32 softmax
router, the top-k experts (the lower index first on ties), their weights
unnormalized times ``routed_scaling_factor``, each SiLU(x Wg) * (x Wu) Wd,
and the shared experts (one MLP of ``n_shared_experts x
moe_intermediate_size``) added ungated; an untied lm_head.

Weights are the seed's floats (``benchlib.weights_mla``, rope columns in the
published pairs) quantized again by this package's RTN and dequantized to
float32, ``kv_b_proj`` and the router left in float as the recipe states.
The latent rows ``[c ; k_pe]`` go through the configuration's int8 cache
(symmetric absmax / 127, one scale over ``c`` and one over ``k_pe``) before
anything reads them. Matmuls run in float32 with TF32 off.

Departures from the modelling file: float32 throughout (it runs the
checkpoint's bf16); cos and sin stay float32; the queries run in blocks of
``_BLOCK``; the prompts of a call share one prefix, whose hidden states and
latent rows are computed once and read by every suffix, as one forward over
each whole sequence would compute them.

``precision`` selects the control: ``"fp8"`` rounds every Linear input to
float8 e4m3 (per-row absmax / 448), ``"kv4"`` keeps 4-bit latent rows
(absmax / 7, the same two scales).
"""

from __future__ import annotations

import math

import torch

from h100bench.benchlib import weights, weights_mla
from h100bench.reference import rtn
from h100bench.reference.model import _fp8, _kv_round, _rms, no_tf32

__all__ = ["ReferenceMLA"]

_BLOCK = 256  # queries a block: (heads, 256, keys) float32 scores


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _inv_freq(s: weights_mla.ShapesMLA, device) -> tuple[torch.Tensor, float]:
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies and cos/sin scale."""
    d, base = s.rope, s.rope_theta
    idx = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    rs = s.rope_scaling
    if not rs:
        return 1.0 / (base ** (idx / d)), 1.0
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return (d * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv = (1.0 / (factor * base ** (idx / d))) * (1 - mask) + (1.0 / (base ** (idx / d))) * mask
    return inv, _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])


def softmax_scale(s: weights_mla.ShapesMLA) -> float:
    scale = (s.nope + s.rope) ** -0.5
    rs = s.rope_scaling
    if rs and rs.get("mscale_all_dim"):
        scale *= _mscale(float(rs["factor"]), rs["mscale_all_dim"]) ** 2
    return scale


class ReferenceMLA:
    """Float32 forward of a DeepSeek-V2 configuration's quantized model."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "reference"):
        if precision not in ("reference", "fp8", "kv4"):
            raise ValueError(f"unknown precision {precision!r}")
        self.s = weights_mla.ShapesMLA(cfg)
        self.recipe = cfg["recipe"]
        self.seed, self.device, self.precision = seed, torch.device(device), precision
        self.draw = getattr(torch, cfg["torch_dtype"])
        self.levels = 7 if precision == "kv4" else 127
        self.inv_freq, self.rope_amp = _inv_freq(self.s, self.device)

    def _lin(self, x, w):
        return (_fp8(x) if self.precision == "fp8" else x) @ w

    def _layer_weights(self, i: int) -> dict:
        leaves = weights_mla.layer_leaves(self.s, self.seed, i, self.device, self.draw)
        gs = self.recipe["body"]["group_size"]
        return {name: (w.to(torch.float32) if name in ("mlp.router", "attn.kv_b_proj")
                       else rtn.dequant_uint4_group(w, gs))
                for name, w in leaves["w"].items()}

    def _rope(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """x (T, H, rope) at positions start..start+T-1, pairs (2i, 2i + 1)
        regrouped into halves and rotated, as the modelling file does."""
        t, h, d = x.shape
        pos = torch.arange(start, start + t, dtype=torch.float32, device=x.device)
        freqs = torch.outer(pos, self.inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos = (emb.cos() * self.rope_amp)[:, None, :]
        sin = (emb.sin() * self.rope_amp)[:, None, :]
        x = x.reshape(t, h, d // 2, 2).transpose(3, 2).reshape(t, h, d)
        return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1) * sin

    def _kv(self, h: torch.Tensor, w: dict, start: int):
        """Queries (T, H, nope + rope) and decompressed keys and values
        (T, H, ...) of the normed hidden states ``h`` at positions
        start..start+T-1, the latent rows rounded as the cache holds them."""
        s = self.s
        t = h.shape[0]
        q = self._lin(h, w["attn.q_proj"]).view(t, s.heads, s.nope + s.rope)
        q = torch.cat([q[..., :s.nope], self._rope(q[..., s.nope:], start)], dim=-1)
        ckv = self._lin(h, w["attn.kv_a_proj"])
        c = _kv_round(_rms(ckv[:, :s.rank], s.eps), self.levels)  # kv_a_layernorm's gain is 1
        k_pe = _kv_round(self._rope(ckv[:, None, s.rank:], start)[:, 0], self.levels)
        kv = self._lin(c, w["attn.kv_b_proj"]).view(t, s.heads, s.nope + s.v_dim)
        k = torch.cat([kv[..., :s.nope], k_pe[:, None, :].expand(t, s.heads, s.rope)], dim=-1)
        return q, k, kv[..., s.nope:]

    def _attend(self, q, k, v, offset: int) -> torch.Tensor:
        """Query t (at key index offset + t) sees keys 0..offset + t."""
        s = self.s
        t = q.shape[0]
        scale = softmax_scale(s)
        out = torch.empty((t, s.heads, s.v_dim), dtype=torch.float32, device=q.device)
        for t0 in range(0, t, _BLOCK):
            t1 = min(t, t0 + _BLOCK)
            top = offset + t1
            scores = torch.einsum("thd,shd->hts", q[t0:t1], k[:top]) * scale
            seen = (torch.arange(top, device=q.device)[None, :]
                    <= offset + torch.arange(t0, t1, device=q.device)[:, None])
            scores = scores.masked_fill(~seen, float("-inf"))
            out[t0:t1] = torch.einsum("hts,shd->thd", torch.softmax(scores, dim=-1), v[:top])
        return out.reshape(t, s.heads * s.v_dim)

    def _mlp(self, x, w, prefix):
        return self._lin(torch.nn.functional.silu(self._lin(x, w[f"{prefix}.gate_proj"]))
                         * self._lin(x, w[f"{prefix}.up_proj"]), w[f"{prefix}.down_proj"])

    def _moe(self, x, w):
        s = self.s
        probs = torch.softmax(self._lin(x, w["mlp.router"]), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :s.top_k], top_i[:, :s.top_k]
        if s.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        top_p = top_p * s.routed_scale
        out = torch.zeros_like(x)
        for e in range(s.experts):
            rows, slot = torch.nonzero(top_i == e, as_tuple=True)
            if rows.numel():
                out.index_add_(0, rows, self._mlp(x[rows], w, f"mlp.experts.{e}")
                               * top_p[rows, slot][:, None])
        return out + self._mlp(x, w, "mlp.shared")

    @torch.no_grad()
    def final_hidden(self, prefix: list[int], suffixes: list[list[int]]) -> list[torch.Tensor]:
        """Each suffix's final normed hidden states (T_i, hidden), float32,
        with the whole sequence ``prefix + suffix`` as its context."""
        s = self.s
        P = len(prefix)
        with no_tf32():
            embed = weights.embed_weight(s, self.seed, self.device, self.draw)
            xs = [embed[torch.as_tensor(q, dtype=torch.long, device=self.device)]
                  .to(torch.float32) for q in [prefix] + suffixes]
            del embed
            for layer in range(s.layers):
                w = self._layer_weights(layer)
                hp = _rms(xs[0], s.eps)
                qp, kp, vp = self._kv(hp, w, 0)
                new = [xs[0] + self._lin(self._attend(qp, kp, vp, 0), w["attn.o_proj"])]
                for x in xs[1:]:
                    q, k, v = self._kv(_rms(x, s.eps), w, P)
                    att = self._attend(q, torch.cat([kp, k]), torch.cat([vp, v]), P)
                    new.append(x + self._lin(att, w["attn.o_proj"]))
                del qp, kp, vp
                lens = [x.shape[0] for x in new]
                flat = torch.cat(new)
                h = _rms(flat, s.eps)
                flat = flat + (self._mlp(h, w, "mlp") if s.is_dense(layer) else self._moe(h, w))
                xs = list(torch.split(flat, lens))
                del w, flat, h, new
            return [_rms(x, s.eps) for x in xs[1:]]

    @torch.no_grad()
    def lm_head(self) -> torch.Tensor:
        """The int8 lm_head dequantized, (hidden, vocab) float32."""
        return rtn.dequant_int8_channel(weights.lm_head_weight(self.s, self.seed, self.device,
                                                             self.draw))

    def logits(self, hidden: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self._lin(hidden, head)
