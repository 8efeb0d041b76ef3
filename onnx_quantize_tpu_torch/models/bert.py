"""BERT-style bidirectional encoder classifier: the integration-parity family.

Counterpart of ``onnx_quantize_tpu/models/bert.py``: the encoder (post-
LayerNorm blocks, biased Gemm projections, the ``[CLS]`` pooler with tanh,
the classification head: the DistilBERT shape), a deterministic synthetic
sentiment task (:func:`synthetic_sst2`, numpy draws equal to the reference's
byte for byte), a float trainer that reaches a DistilBERT-SST2-like accuracy
(~0.93) on it, and the accuracy loop. The model is multi-input
(``input_ids`` + ``attention_mask``), so calibration takes a dict of arrays.

The trainer is torch autograd with Adam in optax's form (bias-corrected
moments, ``lr * m_hat / (sqrt(v_hat) + eps)``) on the softmax cross-entropy
of integer labels; it runs no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from onnx_quantize_tpu_torch.models.transformer import LayerNorm, attend
from onnx_quantize_tpu_torch.nn.layers import Embedding
from onnx_quantize_tpu_torch.nn.module import Context, InputSpec, Linear, Module
from onnx_quantize_tpu_torch.utils import tree_map

__all__ = ["BertConfig", "BertClassifier", "synthetic_sst2", "train_classifier", "accuracy"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 512
    hidden_size: int = 128
    intermediate_size: int = 512
    num_layers: int = 2
    num_heads: int = 4
    max_seq: int = 48
    num_classes: int = 2
    layer_norm_eps: float = 1e-12  # BERT's default


class BertSelfAttention(Module):
    """Bidirectional MHA with biases (every projection is a Gemm site); the
    padding mask only, no causal mask."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = Linear(d, d, use_bias=True)
        self.k_proj = Linear(d, d, use_bias=True)
        self.v_proj = Linear(d, d, use_bias=True)
        self.o_proj = Linear(d, d, use_bias=True)

    def forward(self, params, x, mask, ctx: Context | None = None):
        B, T, d = x.shape
        H = self.cfg.num_heads
        q, k, v = (proj(params[name], x, ctx=ctx).reshape(B, T, H, d // H)
                   for name, proj in (("q_proj", self.q_proj), ("k_proj", self.k_proj),
                                      ("v_proj", self.v_proj)))
        return self.o_proj(params["o_proj"], attend(q, k, v, mask[:, None, None, :]), ctx=ctx)


class BertBlock(Module):
    """Post-LayerNorm residual block (the original BERT/DistilBERT order)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = BertSelfAttention(cfg)
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, use_bias=True)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, use_bias=True)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, params, x, mask, ctx: Context | None = None):
        x = self.ln_attn(params["ln_attn"], x + self.attn(params["attn"], x, mask, ctx=ctx))
        h = F.gelu(self.fc_in(params["fc_in"], x, ctx=ctx), approximate="tanh")
        return self.ln_mlp(params["ln_mlp"], x + self.fc_out(params["fc_out"], h, ctx=ctx))


class BertClassifier(Module):
    """Encoder + [CLS] pooler (dense + tanh) + classification head; blocks
    under the param keys ``layer.0``, ``layer.1``, ..."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_embed = Embedding(cfg.max_seq, cfg.hidden_size)
        self.ln_embed = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.layer = torch.nn.ModuleList(BertBlock(cfg) for _ in range(cfg.num_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, use_bias=True)
        self.classifier = Linear(cfg.hidden_size, cfg.num_classes, use_bias=True)
        self.input_specs = [
            InputSpec("input_ids", (cfg.max_seq,), np.int32),
            InputSpec("attention_mask", (cfg.max_seq,), np.int32),
        ]
        self.finalize()

    def forward(self, params, input_ids, attention_mask=None, ctx: Context | None = None):
        B, T = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=input_ids.device)
        mask = attention_mask.to(torch.bool)
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = self.embed(params["embed"], input_ids) + self.pos_embed(params["pos_embed"], pos)
        x = self.ln_embed(params["ln_embed"], x)
        for i, block in enumerate(self.layer):
            x = block(params[f"layer.{i}"], x, mask, ctx=ctx)
        pooled = torch.tanh(self.pooler(params["pooler"], x[:, 0, :], ctx=ctx))  # [CLS]
        return self.classifier(params["classifier"], pooled, ctx=ctx)


# ---------------------------------------------------------------------------
# Synthetic SST-2: a deterministic sentiment task the encoder must learn.
# ---------------------------------------------------------------------------

_CLS, _PAD = 1, 0


def _token_sentiment(vocab_size: int, seed: int = 5) -> np.ndarray:
    """Fixed per-token sentiment: ~1/4 positive, ~1/4 negative, the rest
    neutral. Positive and negative roles alternate across adjacent Zipf ranks
    (id % 4), so sentence totals concentrate near zero; strengths in
    [0.5, 1.5] give a spread of margins."""
    rng = np.random.default_rng(seed)
    s = np.zeros(vocab_size, np.float32)
    ids = np.arange(2, vocab_size)
    strength = rng.uniform(0.5, 1.5, vocab_size - 2).astype(np.float32)
    s[ids[ids % 4 == 0]] = strength[ids % 4 == 0]
    s[ids[ids % 4 == 1]] = -strength[ids % 4 == 1]
    return s


def synthetic_sst2(n: int, cfg: BertConfig, seed: int = 17):
    """Deterministic sentence batch: (input_ids, attention_mask, labels) as
    int32 numpy arrays.

    Each sentence is [CLS] + tokens from a Zipf-ranked categorical over the
    vocab + PAD; the label is the sign of the summed token sentiment, with
    ~3% deterministic label noise (so the float model tops out near 0.94).
    """
    rng = np.random.default_rng(seed)
    sent = _token_sentiment(cfg.vocab_size)
    T = cfg.max_seq
    ranks = np.arange(2, cfg.vocab_size, dtype=np.float64)
    probs = ranks**-1.2
    probs /= probs.sum()
    toks = rng.choice(np.arange(2, cfg.vocab_size), size=(n, T - 1), p=probs).astype(np.int32)
    lengths = rng.integers(T // 3, T - 1, size=n)
    pos = np.arange(T - 1)[None, :]
    valid = pos < lengths[:, None]
    ids = np.concatenate([np.full((n, 1), _CLS, np.int32), np.where(valid, toks, _PAD)], axis=1)
    mask = np.concatenate([np.ones((n, 1), np.int32), valid.astype(np.int32)], axis=1)
    totals = np.where(valid, sent[toks], 0.0).sum(axis=1)
    labels = (totals > 0).astype(np.int32)
    labels ^= (rng.random(n) < 0.03).astype(np.int32)
    return ids, mask, labels


def _device_of(params) -> torch.device:
    return params["embed"]["w"].device


@torch.inference_mode()
def accuracy(model: BertClassifier, params, ids, mask, labels, batch_size: int = 64) -> float:
    """Greedy classification accuracy over numpy arrays, on the params'
    device, in batches of ``batch_size``."""
    device = _device_of(params)
    correct = 0
    for lo in range(0, len(ids), batch_size):
        i = torch.from_numpy(np.asarray(ids[lo:lo + batch_size])).to(device)
        m = torch.from_numpy(np.asarray(mask[lo:lo + batch_size])).to(device)
        preds = model(params, i, m).argmax(dim=-1).cpu().numpy()
        correct += int((preds == labels[lo:lo + batch_size]).sum())
    return correct / len(ids)


def _train_steps(model: BertClassifier, params: dict, ids, mask, labels, steps: int,
                 batch_size: int, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> dict:
    """``steps`` Adam steps (optax's update) on consecutive batches of the
    numpy arrays; returns the new params (the input tree is not changed)."""
    device = _device_of(params)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves: list[torch.Tensor] = []
    tree_map(leaves.append, params)
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    for k in range(steps):
        lo = k * batch_size
        i, m, y = (torch.from_numpy(np.asarray(a[lo:lo + batch_size])).to(device)
                   for a in (ids, mask, labels))
        loss = F.cross_entropy(model(params, i, m), y.to(torch.int64))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            t = k + 1
            for p, g, m1, m2 in zip(leaves, grads, mu, nu):
                m1.mul_(b1).add_((1 - b1) * g)
                m2.mul_(b2).add_((1 - b2) * g.square())
                m_hat = m1 / (1 - b1**t)
                v_hat = m2 / (1 - b2**t)
                p.sub_(m_hat / (v_hat.sqrt() + eps) * lr)
    return tree_map(lambda t: t.detach(), params)


def train_classifier(model: BertClassifier, steps: int = 400, batch_size: int = 64,
                     lr: float = 3e-4, seed: int = 23,
                     device: torch.device | str = "cuda") -> dict:
    """Deterministically train the classifier on synthetic SST-2 from a
    seeded init on ``device``: ``steps`` Adam steps of ``batch_size``
    sentences each."""
    train_ids, train_mask, train_labels = synthetic_sst2(steps * batch_size, model.cfg,
                                                         seed=seed)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    with torch.enable_grad():
        return _train_steps(model, params, train_ids, train_mask, train_labels, steps,
                            batch_size, lr)
