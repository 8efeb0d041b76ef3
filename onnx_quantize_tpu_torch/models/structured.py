"""Deterministic structured-weight models for absolute accuracy pins.

Counterpart of ``onnx_quantize_tpu/models/structured.py``: a mid-size model
whose weights are *structured* (low-rank mixing plus heavy-tailed
per-channel outliers, the statistics PTQ algorithms are sensitive to), drawn
by seeded numpy PCG64 streams keyed by a CRC of each parameter path. The
draws are the reference's, in numpy, so both packages build the same values;
they become float32 torch tensors on the caller's device.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

__all__ = ["structured_params", "zipf_tokens", "STRUCTURED_GEMMA3"]


def _rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng((seed << 32) ^ zlib.crc32(name.encode()))


def _structured_weight(rng: np.random.Generator, K: int, N: int) -> np.ndarray:
    """Low-rank + noise + input-channel outliers (a few inputs scaled 6-10x,
    what SmoothQuant, AWQ and rotations exist to handle)."""
    r = max(4, min(K, N) // 8)
    A = rng.standard_normal((K, r)).astype(np.float32)
    B = rng.standard_normal((r, N)).astype(np.float32)
    w = (A @ B) / np.sqrt(r * K / 2.0)
    w += 0.3 * rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    n_out = max(1, K // 32)
    idx = rng.choice(K, size=n_out, replace=False)
    w[idx, :] *= rng.uniform(6.0, 10.0, size=(n_out, 1)).astype(np.float32)
    return (0.6 * w).astype(np.float32)


def structured_params(model, seed: int = 7, device: torch.device | str = "cuda") -> dict:
    """The model's param tree with deterministic structured values, float32
    on ``device``.

    Linear weights get low-rank + outlier structure; the embedding Zipf-decayed
    row norms (frequent tokens carry larger embeddings); norm gains small
    offsets; biases small values. The lm_head is the embedding's transpose, as
    in the reference (tied whatever the config says).
    """
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    sites = {s.name for s in model.linear_sites()}

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        name = ".".join(path[:-1])
        leaf = path[-1]
        rng = _rng(seed, ".".join(path))
        if leaf == "w" and name in sites and tree.ndim == 2:
            arr = _structured_weight(rng, *tree.shape)
        elif leaf == "w" and name == "embed" and tree.ndim == 2:
            V, D = tree.shape
            w = rng.standard_normal((V, D)).astype(np.float32)
            norms = (1.0 / np.power(np.arange(1, V + 1), 0.25)).astype(np.float32)
            arr = 0.05 * w * norms[:, None]
        elif leaf == "w" and tree.ndim == 1:  # RMSNorm gains
            arr = 0.1 * rng.standard_normal(tuple(tree.shape)).astype(np.float32)
        elif leaf == "b":
            arr = 0.02 * rng.standard_normal(tuple(tree.shape)).astype(np.float32)
        else:
            return tree.to(device)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    params = visit(params, ())
    if "lm_head" in params and "embed" in params:  # as the reference, whatever the config
        params["lm_head"] = {"w": params["embed"]["w"].T}
    return params


def zipf_tokens(n: int, vocab_size: int, seed: int = 11) -> np.ndarray:
    """Deterministic Zipf-distributed token stream (natural-text-like ranks)."""
    rng = np.random.default_rng(seed)
    toks = rng.zipf(1.3, size=4 * n)
    toks = toks[toks < vocab_size][:n]
    while len(toks) < n:
        extra = rng.zipf(1.3, size=2 * n)
        toks = np.concatenate([toks, extra[extra < vocab_size]])[:n]
    return toks.astype(np.int32)


def STRUCTURED_GEMMA3(device: torch.device | str = "cuda"):
    """The pinned mid-size structured Gemma-3 (~7M params): (model, params)."""
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

    cfg = Gemma3Config(
        vocab_size=2048, hidden_size=256, intermediate_size=1024, num_layers=4,
        num_heads=4, num_kv_heads=1, head_dim=64, sliding_window=128,
        sliding_pattern=3,
    )
    model = Gemma3(cfg)
    return model, structured_params(model, device=device)
