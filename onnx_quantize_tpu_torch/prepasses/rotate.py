"""Rotation pre-pass (QuaRot): fold an orthogonal basis change into the weights.

Counterpart of ``onnx_quantize_tpu/prepasses/rotate.py``. The decoder's
residual stream is rewritten in a rotated basis ``x~ = x R`` (R orthogonal):
the embedding and every stream-writing projection fold ``R`` on the right,
every stream-reading projection folds ``R^T`` on the left, and the model
computes the same logits. A rotation spreads outlier channels over the whole
hidden dimension, so low-bit weight and activation scales shrink.

RMSNorm commutes with a rotation only with a gain of 1, so each norm's gain
is first folded into the projections it feeds (``W <- D_gamma W``) and the
norm reset to identity. Models with sandwich (post-) norms are refused: a
post-norm's gain feeds the residual add with no matmul to absorb it (use the
Llama conventions, ``models/llama.py``).

The online rotations (R2/R3/R4) cover what R1 cannot reach:

* R2, V head space: ``R_v`` folded into v_proj's output columns and
  ``R_v^T`` into o_proj's input rows, per head (weight-space; the cached V
  rows are rotated).
* R3, q and k after RoPE: ``Gemma3Attention.qk_rot``, applied online, since
  RoPE sits between k_proj and the scores (the cached K rows are rotated).
* R4, the down_proj input: ``Gemma3MLP.down_rot``, a blockwise Hadamard
  applied online with ``H^T`` folded into down_proj's rows.

The rotations are drawn with numpy exactly as the reference draws them
(``default_rng(seed)`` for R1, ``default_rng(seed + 1)`` for the online set),
so they are bit-equal to its matrices and can be stamped again onto a model
rebuilt from a checkpoint (``stamp_online_rotations``). The folds run in
float64 torch on the params' device and cast back to each leaf's dtype, as
the reference casts its numpy float64 fold. Every fold REBINDS the leaf and
never writes in place: a tied lm_head is a view of the embedding, and a fold
in place would rotate a tied model twice.

Order: rotation runs before SmoothQuant (a prescale on a reading site
raises). Captured calibration inputs move into the rotated basis, and the
driver calibrates again after the pass (``requires_post_calibration``). In
an MoE layer the router, every expert's gate/up and the shared expert's
gate/up and its gate read the stream, and every expert's down_proj and the
shared down_proj write it; R4 (the online down rotation) is refused there,
as each expert would need it inside its routed execution.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from onnx_quantize_tpu_torch.plan import QuantPlan
from onnx_quantize_tpu_torch.utils import tree_get

logger = logging.getLogger(__name__)

__all__ = ["RotatePass", "random_orthogonal", "randomized_hadamard", "rotate_residual_stream",
           "hadamard_block", "apply_online_rotations", "stamp_online_rotations",
           "clear_online_rotations"]

_F64 = torch.float64


def random_orthogonal(n: int, rng: np.random.Generator) -> np.ndarray:
    """Haar-ish random orthogonal matrix (QR with sign-fixed diagonal)."""
    a = rng.standard_normal((n, n))
    q, r = np.linalg.qr(a)
    return q * np.sign(np.diag(r))[None, :]


def _hadamard(k: int) -> np.ndarray:
    h = np.ones((1, 1))
    for _ in range(k):
        h = np.block([[h, h], [h, -h]])
    return h


def randomized_hadamard(n: int, rng: np.random.Generator) -> np.ndarray:
    """Orthogonal ``D (H_{2^a} kron Q_m)`` for ``n = 2^a m`` (m odd): D a random
    +-1 diagonal, Q_m a random orthogonal block; a plain random orthogonal
    matrix when n is odd."""
    a = 0
    m = n
    while m % 2 == 0:
        a += 1
        m //= 2
    if a == 0:
        return random_orthogonal(n, rng)
    h = _hadamard(a) / np.sqrt(2.0**a)
    block = h if m == 1 else np.kron(h, random_orthogonal(m, rng))
    signs = rng.integers(0, 2, size=n) * 2.0 - 1.0
    return signs[:, None] * block


def hadamard_block(dim: int, rng: np.random.Generator) -> np.ndarray:
    """Sign-randomized orthogonal mixer for one block: ``D H / sqrt(dim)``
    when dim is a power of two, else a random orthogonal matrix."""
    if dim & (dim - 1) == 0:
        h = _hadamard(dim.bit_length() - 1) / np.sqrt(float(dim))
        signs = rng.integers(0, 2, size=dim) * 2.0 - 1.0
        return signs[:, None] * h
    return random_orthogonal(dim, rng)


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=_F64, device=device)


def _gain(norm_params: dict, one_plus: bool) -> torch.Tensor:
    w = norm_params["w"].to(_F64)
    return 1.0 + w if one_plus else w


def _reset_norm(norm_params: dict, one_plus: bool) -> None:
    w = norm_params["w"]
    norm_params["w"] = torch.zeros_like(w) if one_plus else torch.ones_like(w)


def _read_fold(site: dict, rot_t: torch.Tensor, gamma: torch.Tensor | None) -> None:
    """Stream-reading site: ``W <- R^T D_gamma W`` (a bias lives in head space).
    Rebinds ``site["w"]``."""
    if "prescale" in site:
        raise ValueError(
            "rotation must run before SmoothQuant: found a prescale on a "
            "stream-reading site (order preprocessors=[RotateConfig(), ...])"
        )
    w = site["w"]
    left = rot_t * gamma[None, :] if gamma is not None else rot_t
    site["w"] = (left @ w.to(_F64)).to(w.dtype)


def _write_fold(site: dict, rot: torch.Tensor) -> None:
    """Stream-writing site: ``W <- W R``, ``b <- b R``. Rebinds the leaves."""
    w = site["w"]
    site["w"] = (w.to(_F64) @ rot).to(w.dtype)
    if "b" in site:
        b = site["b"]
        site["b"] = (b.to(_F64) @ rot).to(b.dtype)


def _mlp_paths(mlp_params: dict, prefix: tuple[str, ...]):
    """(stream-reading paths, stream-writing paths) of a dense or MoE MLP."""
    if "router" not in mlp_params:
        return [prefix + ("gate_proj",), prefix + ("up_proj",)], [prefix + ("down_proj",)]
    readers, writers = [prefix + ("router",)], []
    for k in (k for k in mlp_params if k.startswith("experts.")):
        readers += [prefix + (k, "gate_proj"), prefix + (k, "up_proj")]
        writers.append(prefix + (k, "down_proj"))
    if "shared" in mlp_params:
        readers += [prefix + ("shared_gate",), prefix + ("shared", "gate_proj"),
                    prefix + ("shared", "up_proj")]
        writers.append(prefix + ("shared", "down_proj"))
    return readers, writers


def _decoder(model, what: str):
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3

    if not isinstance(model, Gemma3):
        raise ValueError(f"{what} supports the Gemma3-family decoder (Gemma/Llama/Qwen/MoE "
                         "configs)")
    return model.cfg


def rotate_residual_stream(model, params: dict, rotation) -> dict:
    """Fold ``rotation`` (n, n) into ``params`` (exact logits).

    Returns {stream-reading site path: its pre-fold norm gain (float64)}, the
    recipe for moving that site's captured inputs (``new = (old / gamma) @ R``).
    """
    cfg = _decoder(model, "rotation")
    if cfg.sandwich_norms:
        raise ValueError(
            "rotation requires pre-norm-only models (sandwich_norms=False): "
            "a post-norm gain feeds the residual add with no following "
            "matmul to absorb it"
        )
    n = cfg.hidden_size
    if tuple(rotation.shape) != (n, n):
        raise ValueError(f"rotation must be ({n}, {n}), got {tuple(rotation.shape)}")
    device = params["embed"]["w"].device
    rot = _f64(rotation, device)
    rot_t = rot.T
    one_plus = cfg.rms_one_plus
    gains: dict[tuple[str, ...], torch.Tensor] = {}

    embed = params["embed"]
    embed["w"] = (embed["w"].to(_F64) @ rot).to(embed["w"].dtype)
    for i in range(cfg.num_layers):
        layer = params[f"layers.{i}"]
        g_attn = _gain(layer["input_norm"], one_plus)
        for proj in ("q_proj", "k_proj", "v_proj"):
            path = (f"layers.{i}", "attn", proj)
            _read_fold(tree_get(params, path), rot_t, g_attn)
            gains[path] = g_attn
        _reset_norm(layer["input_norm"], one_plus)
        _write_fold(layer["attn"]["o_proj"], rot)

        g_ffn = _gain(layer["pre_ffn_norm"], one_plus)
        readers, writers = _mlp_paths(layer["mlp"], (f"layers.{i}", "mlp"))
        for path in readers:
            _read_fold(tree_get(params, path), rot_t, g_ffn)
            gains[path] = g_ffn
        for path in writers:
            _write_fold(tree_get(params, path), rot)
        _reset_norm(layer["pre_ffn_norm"], one_plus)

    g_final = _gain(params["final_norm"], one_plus)
    _read_fold(params["lm_head"], rot_t, g_final)
    gains[("lm_head",)] = g_final
    _reset_norm(params["final_norm"], one_plus)
    return gains


def _build_online_rots(cfg, block: int, seed: int, need_down: bool = True):
    """Deterministic (r_qk, r_v, h_down) from the config's shapes and the seed."""
    rng = np.random.default_rng(seed + 1)  # offset from R1's stream
    r_qk = hadamard_block(cfg.head_dim, rng)
    r_v = hadamard_block(cfg.head_dim, rng)
    if not need_down:
        return r_qk, r_v, None
    block = min(block, cfg.intermediate_size)
    if cfg.intermediate_size % block != 0:
        raise ValueError(
            f"online down rotation needs block ({block}) to divide "
            f"intermediate_size ({cfg.intermediate_size})"
        )
    return r_qk, r_v, hadamard_block(block, rng)


def _fold_cols_per_head(site: dict, rot: torch.Tensor, head_dim: int) -> None:
    """Output-side per-head fold: ``W[:, h] <- W[:, h] R`` (v_proj)."""
    w = site["w"]
    n_in, n_out = w.shape
    w3 = w.to(_F64).reshape(n_in, n_out // head_dim, head_dim)
    site["w"] = (w3 @ rot).reshape(n_in, n_out).to(w.dtype)
    if "b" in site:
        b = site["b"]
        b2 = b.to(_F64).reshape(n_out // head_dim, head_dim)
        site["b"] = (b2 @ rot).reshape(n_out).to(b.dtype)


def _fold_rows(site: dict, rot_t: torch.Tensor, block: int) -> None:
    """Input-side fold per ``block`` of rows: ``W_g <- R^T W_g`` (o_proj per
    head, down_proj per Hadamard block)."""
    w = site["w"]
    n_in, n_out = w.shape
    w3 = w.to(_F64).reshape(n_in // block, block, n_out)
    site["w"] = (rot_t @ w3).reshape(n_in, n_out).to(w.dtype)


def _rotate_captured_blockwise(u: torch.Tensor, rot: torch.Tensor, block: int) -> torch.Tensor:
    n = u.shape[-1]
    u3 = u.to(_F64).reshape(*u.shape[:-1], n // block, block)
    return (u3 @ rot.to(u.device)).reshape(u.shape).to(torch.float32)


def stamp_online_rotations(model, *, qk: bool = True, down: bool = True, block: int = 128,
                           seed: int = 0) -> None:
    """Stamp the online transforms onto a model whose params were already
    folded (after a checkpoint reload, say). Deterministic in (shapes, seed).
    R2 (V) is weight-space only: nothing to stamp for it."""
    r_qk, _, h_down = _build_online_rots(model.cfg, block, seed, need_down=down)
    for layer in model.layers:
        if qk:
            layer.attn.qk_rot = r_qk
        if down:
            if not hasattr(layer.mlp, "down_proj"):
                raise NotImplementedError(
                    "online down rotation supports dense MLPs only (MoE experts would each "
                    "need the online transform inside their routed execution)")
            layer.mlp.down_rot = h_down


def clear_online_rotations(model) -> None:
    """Remove the stamped online transforms. The stamp is model state paired
    with the params folded beside it: a model reused for another ``quantize``
    must be cleared (or stamped again) in between."""
    for layer in model.layers:
        layer.attn.qk_rot = None
        if hasattr(layer.mlp, "down_rot"):
            layer.mlp.down_rot = None


def apply_online_rotations(model, params: dict, plan: QuantPlan | None = None, *,
                           qk: bool = True, v: bool = True, down: bool = True,
                           block: int = 128, seed: int = 0) -> None:
    """Fold the weight-space halves of R2/R3/R4 into ``params`` and stamp the
    online transforms onto ``model``. Exact logits. With a ``plan``, the
    captured inputs of o_proj and down_proj move into the rotated basis."""
    cfg = _decoder(model, "online rotations")
    if down and any(not hasattr(layer.mlp, "down_proj") for layer in model.layers):
        raise NotImplementedError("online down rotation supports dense MLPs only; pass "
                                  "rotate_down=False for MoE models")
    r_qk, r_v, h_down = _build_online_rots(cfg, block, seed, need_down=down)
    device = params["embed"]["w"].device
    hd = cfg.head_dim
    captured: dict[tuple[str, ...], tuple[torch.Tensor, int]] = {}
    rv = _f64(r_v, device)
    hdn = None if h_down is None else _f64(h_down, device)
    for i in range(cfg.num_layers):
        layer = params[f"layers.{i}"]
        if v:
            _fold_cols_per_head(layer["attn"]["v_proj"], rv, hd)
            _fold_rows(layer["attn"]["o_proj"], rv.T, hd)
            captured[(f"layers.{i}", "attn", "o_proj")] = (rv, hd)
        if down:
            _fold_rows(layer["mlp"]["down_proj"], hdn.T, hdn.shape[0])
            captured[(f"layers.{i}", "mlp", "down_proj")] = (hdn, hdn.shape[0])
    stamp_online_rotations(model, qk=qk, down=down, block=block, seed=seed)

    if plan is not None:
        updated = 0
        for entry in plan:
            rec = captured.get(entry.site.param_path)
            if rec is None or entry.captured_input is None:
                continue
            entry.captured_input = _rotate_captured_blockwise(entry.captured_input, *rec)
            updated += 1
        if updated:
            logger.info("Online rotation moved %d captured inputs to the rotated basis",
                        updated)


class RotatePass:
    """In-place param/plan pass folding the rotation into the model."""

    def __init__(self, mode: str = "hadamard", seed: int = 0, rotate_qk: bool = False,
                 rotate_v: bool = False, rotate_down: bool = False, online_block: int = 128):
        self.mode = mode
        self.seed = seed
        self.rotate_qk = rotate_qk
        self.rotate_v = rotate_v
        self.rotate_down = rotate_down
        self.online_block = online_block

    def __call__(self, model, params: dict, plan: QuantPlan, qconfig) -> bool:
        n = model.cfg.hidden_size
        rng = np.random.default_rng(self.seed)
        rot = (randomized_hadamard(n, rng) if self.mode == "hadamard"
               else random_orthogonal(n, rng))
        gains = rotate_residual_stream(model, params, rot)
        if self.rotate_qk or self.rotate_v or self.rotate_down:
            apply_online_rotations(model, params, plan, qk=self.rotate_qk, v=self.rotate_v,
                                   down=self.rotate_down, block=self.online_block,
                                   seed=self.seed)
        # Captured inputs of stream-reading sites move to the rotated basis, so
        # later passes (AWQ) see what the rotated model sees; channels whose
        # gain was 0 carried no signal.
        updated = 0
        for entry in plan:
            g = gains.get(entry.site.param_path)
            if g is None or entry.captured_input is None:
                continue
            u = entry.captured_input.to(_F64)
            g = g.to(u.device)
            u = torch.where(g != 0.0, u / torch.where(g != 0.0, g, 1.0), 0.0)
            entry.captured_input = (u @ _f64(rot, u.device)).to(torch.float32)
            updated += 1
        logger.info("Rotation pass folded a %s basis into %d sites (%d captured inputs "
                    "moved to the rotated basis)", self.mode, len(gains), updated)
        return True
