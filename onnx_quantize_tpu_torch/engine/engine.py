"""Inference engine: prefill and decode over a static KV cache, one device.

Counterpart of the single-device part of ``onnx_quantize_tpu/engine/engine.py``.
Ragged batches use per-sequence lengths: pad-token K/V rows land in slots that
a sentinel in ``kv_positions`` keeps masked until a real token overwrites
them. Where the JAX package compiles prefill and a ``lax.scan`` decode loop,
the port runs eagerly: ``decode_multi`` is a Python loop under
``torch.inference_mode()`` whose tokens stay on the device until the end.
Capturing the decode step in a CUDA graph is later work.

Works with float or quantized params (the Linear sites dispatch to the
Hopper kernels on CUDA) and a float, int8 or int4 KV cache. With
``fused_attention=True`` every one-token forward over the int8 cache runs
the flash-decode kernel; with ``mlp_megakernel=True`` every decode-sized MLP
over packed W4 weights runs the fused MLP kernel. ``score_nll``/``score_ppl``
score token rows teacher-forced through the decode path, so the cache's
quantization error is part of the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onnx_quantize_tpu_torch.engine.kv_cache import (
    KVCacheConfig,
    init_cache,
    read_kv,
    read_kv_quantized,
    write_kv,
)
from onnx_quantize_tpu_torch.engine.sampling import SamplingParams, sample
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.utils import tree_map

__all__ = ["InferenceEngine", "prepare_kernel_scales"]

_FAR = 1 << 30  # kv_positions sentinel: always masked


def prepare_kernel_scales(params: dict) -> dict:
    """Bake packed GROUP-quantized scale/zp into the W4 kernel's padded
    (G_pad/2, 2, N) float32 group-pair layout, once at load, so no decode
    step pays the pad and convert. ``ops.reference.weight_qparams_2d`` slices
    the layout back, so either layout is valid wherever a QTensor flows."""
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import expand_w4_scales

    def prep(leaf):
        if not (isinstance(leaf, QTensor) and leaf.meta.packed
                and leaf.meta.strategy == "group" and leaf.scale.ndim != 3):
            return leaf
        scale, zp = expand_w4_scales(leaf)
        return dataclasses.replace(leaf, scale=scale, zero_point=zp)

    return tree_map(prep, params)


def _device_of(params: dict) -> torch.device:
    leaf = params["embed"]["w"]
    return leaf.device


class InferenceEngine:
    """Prefill/decode engine on the device that holds ``params``."""

    def __init__(self, model, params: dict, max_batch: int = 8, max_seq: int = 2048,
                 kv_quant: bool | str = False, dtype: torch.dtype = torch.float32,
                 fused_attention: bool | str = "auto", mlp_megakernel: bool | str = "auto"):
        cfg = model.cfg
        # kv_quant: False | True/"int8" | "int4" (packed nibbles, half the
        # cache bytes again; see kv_cache.py).
        kv_quant_arg = kv_quant  # keep the caller's spelling for error text
        if kv_quant in (False, None):
            kv_bits, kv_quant = 8, False
        elif kv_quant in (True, "int8"):
            kv_bits, kv_quant = 8, True
        elif kv_quant == "int4":
            kv_bits, kv_quant = 4, True
        else:
            raise ValueError(
                f"kv_quant must be False, True/'int8', or 'int4', got {kv_quant!r}"
            )
        # Flash decode over the int8 cache (ops/kernels/flash_decode.py) is
        # opt-in, as in the JAX package, whose default was set on a TPU; the
        # H100's own comparison is in PERF.md.
        fusable = (
            kv_quant and kv_bits == 8
            and cfg.head_dim % 128 == 0 and max_seq % 128 == 0
        )
        self._fused_attn = fused_attention != "auto" and bool(fused_attention)
        if self._fused_attn and not fusable:
            raise ValueError(
                "fused_attention requires an int8 KV cache, head_dim % 128"
                f" == 0 and max_seq % 128 == 0 (got kv_quant="
                f"{kv_quant_arg!r} [{kv_bits}-bit], "
                f"head_dim={cfg.head_dim}, max_seq={max_seq})"
            )
        # The fused W4 MLP (ops/kernels/mlp_w4.py) takes each eligible site
        # (packed-W4 pair, M <= 256) when armed. The reference arms "auto" on
        # a TPU only; the port keeps "auto" off until the H100 shows a gain
        # (PERF.md). The switch lives on the model's MLPs, as in the
        # reference; the engine sets it before each of its forwards, so two
        # engines over one model keep their own settings.
        self._mega = mlp_megakernel != "auto" and bool(mlp_megakernel)
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.params = prepare_kernel_scales(params)
        self.device = _device_of(self.params)
        self.cache_cfg = KVCacheConfig(
            num_layers=cfg.num_layers, batch=max_batch, max_seq=max_seq,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, quantized=kv_quant,
            bits=kv_bits, dtype=dtype,
        )

    def new_cache(self) -> dict:
        return init_cache(self.cache_cfg, self.device)

    def _tensor(self, a, dtype) -> torch.Tensor:
        """Host arrays or tensors -> a tensor of ``dtype`` on the engine's device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(device=self.device, dtype=dtype)

    def _token_ids(self, a) -> torch.Tensor:
        """Token ids on the device. Host input is range-checked first: an id
        out of range would be a device-side assert in the embedding gather."""
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            vocab = self.model.cfg.vocab_size
            if a.size and (a.min() < 0 or a.max() >= vocab):
                raise ValueError(f"token ids must lie in [0, {vocab})")
        return self._tensor(a, torch.int64)

    # -- model forward with cache ---------------------------------------

    def _forward(self, cache, ids, positions, kv_positions, write_mask, last_lengths=None):
        # The flash-decode kernel serves one-token forwards only.
        fused = self._fused_attn and ids.shape[1] == 1

        def kv_write_fn(layer, k, v):
            write_kv(cache, layer, k, v, positions, write_mask)
            if self.cache_cfg.quantized:
                return read_kv_quantized(cache, layer, use_kernel=fused)
            return read_kv(cache, layer, dtype=self.dtype)

        model, params = self.model, self.params
        for block in getattr(model, "layers", []):
            block.mlp.use_megakernel = self._mega
        if last_lengths is None:
            return model(params, ids, positions=positions, kv_write=kv_write_fn,
                         kv_positions=kv_positions)
        # Prefill needs only next-token logits: gather the last valid hidden
        # state per row BEFORE the lm_head, so the (T, vocab) projection runs
        # at (B, 1).
        hidden = model.hidden_states(params, ids, positions=positions, kv_write=kv_write_fn,
                                     kv_positions=kv_positions)
        # A length-0 row (an unused slot) gathers position 0; its logits are unused.
        idx = (last_lengths - 1).clamp(min=0).long()[:, None, None].expand(
            -1, 1, hidden.shape[-1])
        h_last = torch.gather(hidden, 1, idx)  # (B, 1, H)
        return model.lm_head(params["lm_head"], h_last)

    @torch.inference_mode()
    def _decode_step(self, cache, tokens, active):
        """tokens: (B,) next input token per slot; active: (B,) bool."""
        lengths = cache["lengths"]
        # Sequences at capacity must not advance; their (masked) write would
        # land past max_seq.
        active = active & (lengths < self.max_seq)
        positions = torch.where(active, lengths, self.max_seq)[:, None]
        slot = torch.arange(self.max_seq, dtype=torch.int32, device=self.device)[None, :]
        kv_positions = torch.where(slot < (lengths + active.to(torch.int32))[:, None],
                                   slot, _FAR)
        logits = self._forward(cache, tokens[:, None], positions, kv_positions,
                               active[:, None])
        cache["lengths"] = lengths + active.to(torch.int32)
        return logits[:, 0]

    # -- public API -----------------------------------------------------

    @torch.inference_mode()
    def prefill(self, cache: dict, ids, lengths, slot_mask=None):
        """Prefill ``ids`` (B, T_pad) with true ``lengths`` (B,) into ``cache``
        (updated in place); returns (cache, last-token logits (B, V)).

        ``slot_mask`` (B,) selects the slots written (default: all); the other
        slots keep their cache rows and lengths, and their logits are
        meaningless.
        """
        ids = self._token_ids(ids)
        B, T = ids.shape
        if T > self.max_seq:
            raise ValueError(f"prompt length {T} exceeds max_seq={self.max_seq}")
        if not isinstance(lengths, torch.Tensor) and not (
                (np.asarray(lengths) >= 0).all() and (np.asarray(lengths) <= T).all()):
            raise ValueError(f"lengths must lie in [0, {T}]")
        lengths = self._tensor(lengths, torch.int32)
        if slot_mask is None:
            slot_mask = torch.ones((B,), dtype=torch.bool, device=self.device)
        else:
            slot_mask = self._tensor(slot_mask, torch.bool)
        positions = torch.arange(T, dtype=torch.int32, device=self.device)[None, :].expand(B, T)
        slot = torch.arange(self.max_seq, dtype=torch.int32, device=self.device)[None, :]
        kv_positions = torch.where(slot < lengths[:, None], slot, _FAR)
        logits = self._forward(cache, ids, positions, kv_positions,
                               slot_mask[:, None].expand(B, T), last_lengths=lengths)[:, 0]
        cache["lengths"] = torch.where(slot_mask, lengths, cache["lengths"])
        return cache, logits

    def decode(self, cache: dict, tokens, active=None):
        """One decode step for every active slot; returns (cache, logits (B, V))."""
        tokens = self._token_ids(tokens)
        active = (torch.ones(tokens.shape, dtype=torch.bool, device=self.device)
                  if active is None else self._tensor(active, torch.bool))
        return cache, self._decode_step(cache, tokens, active)

    @torch.inference_mode()
    def decode_multi(self, cache: dict, tokens, steps: int, active=None,
                     sampling: SamplingParams | None = None,
                     generator: torch.Generator | None = None,
                     eos_token_id: int | None = None):
        """Decode ``steps`` tokens (greedy, or sampled from ``generator``).

        With ``eos_token_id`` set, a sequence freezes after emitting EOS (no
        KV writes, no length advance; its output is padded with EOS).
        Returns (cache, generated (B, steps) int32 on the device).
        """
        toks = self._token_ids(tokens)
        active = (torch.ones(toks.shape, dtype=torch.bool, device=self.device)
                  if active is None else self._tensor(active, torch.bool))
        done = torch.zeros_like(active)
        out = []
        for _ in range(steps):
            act = active & ~done
            logits = self._decode_step(cache, toks, act)
            if sampling is None or sampling.temperature <= 0:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = sample(logits, generator, sampling).to(torch.int64)
            if eos_token_id is not None:
                nxt = torch.where(done, eos_token_id, nxt)
                done = done | (act & (nxt == eos_token_id))
            out.append(nxt)
            toks = nxt
        generated = (torch.stack(out, dim=1) if out
                     else torch.zeros((toks.shape[0], 0), dtype=torch.int64, device=self.device))
        return cache, generated.to(torch.int32)

    @torch.inference_mode()
    def _score(self, ids: torch.Tensor, lengths: torch.Tensor):
        """Teacher-forced NLL through the decode path, one batch of rows.

        Prefills exactly one token, then feeds the gold tokens one decode step
        at a time, so every K/V row is written and read through the cache's
        own quantization. ids: (B, T) on the device; lengths: (B,) int32 true
        lengths (>= 2 to score). Returns (nll_sum (B,) float32, count (B,)
        int32), both on the device: a Python loop with no host sync.
        """
        B, T = ids.shape
        if T < 2:
            raise ValueError("need at least two tokens to score a prediction")

        def nll_of(logits, tgt, valid):
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nll = -torch.gather(logp, 1, tgt[:, None])[:, 0]
            return torch.where(valid, nll, 0.0)

        cache, logits = self.prefill(self.new_cache(), ids[:, :1], lengths.clamp(max=1))
        # Prefill's last-token logits predict position 1.
        valid = lengths > 1
        nll_sum = nll_of(logits, ids[:, 1], valid)
        count = valid.to(torch.int32)
        # Feed token i (1..T-2); its logits predict position i+1. The final
        # token is never fed: its logits have no target.
        for i in range(1, T - 1):
            logits = self._decode_step(cache, ids[:, i], i < lengths)
            valid = (i + 1) < lengths
            nll_sum = nll_sum + nll_of(logits, ids[:, i + 1], valid)
            count = count + valid.to(torch.int32)
        return nll_sum, count

    def score_nll(self, ids, lengths=None) -> tuple[np.ndarray, np.ndarray]:
        """Teacher-forced NLL through the engine's decode path.

        Scores ``ids`` (N, T) by prefilling one token and step-decoding the
        rest, so the result reflects the configured KV-cache quantization
        (``kv_quant``) at every position. Rows go in ``max_batch`` chunks.
        Returns (nll_sum (N,) float32, count (N,) int32) numpy arrays.
        """
        ids = np.asarray(ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        N, T = ids.shape
        if T > self.max_seq:
            raise ValueError(f"sequence length {T} exceeds max_seq={self.max_seq}")
        lengths = (np.full((N,), T, np.int32) if lengths is None
                   else np.asarray(lengths, np.int32))
        nll = np.zeros((N,), np.float32)
        cnt = np.zeros((N,), np.int32)
        for start in range(0, N, self.max_batch):
            rows = slice(start, min(start + self.max_batch, N))
            n = rows.stop - rows.start
            pad = self.max_batch - n
            b_nll, b_cnt = self._score(self._token_ids(np.pad(ids[rows], ((0, pad), (0, 0)))),
                                       self._tensor(np.pad(lengths[rows], (0, pad)), torch.int32))
            nll[rows] = b_nll.cpu().numpy()[:n]
            cnt[rows] = b_cnt.cpu().numpy()[:n]
        return nll, cnt

    def score_ppl(self, ids, lengths=None) -> float:
        """Perplexity over ``ids`` via :meth:`score_nll` (decode-path KV)."""
        nll, cnt = self.score_nll(ids, lengths)
        return float(np.exp(nll.sum() / max(int(cnt.sum()), 1)))

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 sampling: SamplingParams = SamplingParams(),
                 eos_token_id: int | None = None,
                 generator: torch.Generator | None = None) -> list[list[int]]:
        """Simple batched generation (one prefill, then a decode loop)."""
        if len(prompts) > self.max_batch:
            raise ValueError(f"{len(prompts)} prompts exceed max_batch={self.max_batch}")
        B = self.max_batch
        lengths = np.zeros((B,), np.int32)
        T_pad = max(max(len(p) for p in prompts), 1)
        ids = np.zeros((B, T_pad), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
            lengths[i] = len(p)
        lengths = np.maximum(lengths, 1)

        cache, logits = self.prefill(self.new_cache(), ids, lengths)
        outputs: list[list[int]] = [[] for _ in prompts]
        done = np.zeros((B,), bool)
        done[len(prompts):] = True
        for step in range(max_new_tokens):
            tokens = sample(logits, generator, sampling).cpu().numpy()
            for i in range(len(prompts)):
                if not done[i]:
                    outputs[i].append(int(tokens[i]))
                    if eos_token_id is not None and tokens[i] == eos_token_id:
                        done[i] = True
            if done.all() or step == max_new_tokens - 1:
                break
            cache, logits = self.decode(cache, tokens, active=~done)
        return outputs
