"""Inference engine: prefill and decode over a static KV cache, on one device
or on a (data, model) mesh of ranks.

Counterpart of ``onnx_quantize_tpu/engine/engine.py``.
Ragged batches use per-sequence lengths: pad-token K/V rows land in slots that
a sentinel in ``kv_positions`` keeps masked until a real token overwrites
them. Where the JAX package compiles prefill and a ``lax.scan`` decode loop,
the port runs eagerly: ``decode_multi`` is a Python loop under
``torch.inference_mode()`` whose tokens stay on the device until the end.
Capturing the decode step in a CUDA graph is later work.

``serve_chunk`` is one round of the continuous-batching scheduler
(``engine/scheduler.py``): an optional admission (a masked prefill of the
whole batch, or a narrow one of the admitted rows only), per-slot first-token
sampling, then ``steps`` decode steps with per-slot sampling, EOS, budget and
capacity freezes. It is an eager loop too, with no host sync inside it, and
returns one packed int32 blob that stays on the device.

Works with float or quantized params (the Linear sites dispatch to the
Hopper kernels on CUDA) and a float, int8 or int4 KV cache. With
``fused_attention=True`` every one-token forward over the int8 cache runs
the flash-decode kernel; with ``mlp_megakernel=True`` every decode-sized MLP
over packed W4 weights runs the fused MLP kernel. ``score_nll``/``score_ppl``
score token rows teacher-forced through the decode path, so the cache's
quantization error is part of the result.

With ``mesh`` (``parallel.mesh.Mesh``, axes (data, model)), every rank builds
the engine from the same global param tree: the model's ``tp_localize`` gives
the per-rank model, ``parallel.tp`` localizes the tree and takes the rank's
slice, and only then are the slice's kernel scales baked. The rank's
single-device engine (``local``) runs the Megatron schedule on its weight
shard, with the batch rows of its data coordinate; the public methods take
global inputs, run the local engine and all-gather their outputs over the
data axis, so every rank returns what one device would. A data rank's
sampled tokens draw the noise of the whole batch and keep its rows
(``sampling.gumbel_argmax``'s window), so every row gets its own noise, as
on one device, from a generator seeded alike on every rank. The cache a mesh
engine hands out is the rank's shard: its rows and its local KV heads. What
the JAX package refuses on a mesh, this one refuses the same way: prefix
caching, narrow admission and the ``score_nll``/``score_ppl`` scan.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from onnx_quantize_tpu_torch import tracing
from onnx_quantize_tpu_torch.engine.kv_cache import (
    KVCacheConfig,
    admitted_rows,
    init_cache,
    read_kv,
    read_kv_quantized,
    write_kv,
    write_kv_rows,
)
from onnx_quantize_tpu_torch.engine.sampling import SamplingParams, sample, sample_batch
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.utils import tree_map

__all__ = ["InferenceEngine", "prepare_kernel_scales"]

_FAR = 1 << 30  # kv_positions sentinel: always masked


def prepare_kernel_scales(params: dict) -> dict:
    """Bake packed GROUP-quantized scale/zp into the W4 kernel's padded
    (G_pad/2, 2, N) float32 group-pair layout, once at load, so no decode
    step pays the pad and convert. ``ops.reference.weight_qparams_2d`` slices
    the layout back, so either layout is valid wherever a QTensor flows.

    A leaf whose data is not 2-D (stacked MoE experts, a leading expert axis)
    is left as it is: bake before ``models.moe.stack_moe_experts``, and each
    expert's view of the stack keeps the layout it was stacked in."""
    from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import expand_w4_scales

    def prep(leaf):
        if not (isinstance(leaf, QTensor) and leaf.meta.packed
                and leaf.meta.strategy == "group" and leaf.data.ndim == 2
                and leaf.scale.ndim != 3):
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
                 fused_attention: bool | str = "auto", mlp_megakernel: bool | str = "auto",
                 mesh=None, data_axis: str = "data", model_axis: str = "model"):
        self.mesh = mesh
        if mesh is not None:
            self._init_mesh(model, params, max_batch, max_seq, kv_quant, dtype,
                            fused_attention, mlp_megakernel, data_axis, model_axis)
            return
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
        # A mesh engine's local engine draws its rows of the global noise.
        self._noise_window = None
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

    def _init_mesh(self, model, params, max_batch, max_seq, kv_quant, dtype, fused_attention,
                   mlp_megakernel, data_axis, model_axis):
        from onnx_quantize_tpu_torch.parallel.tp import (
            build_param_specs,
            localize_params,
            shard_params_local,
        )

        mesh = self.mesh
        self._data_axis, self._model_axis = data_axis, model_axis
        tp, dp = mesh.shape[model_axis], mesh.shape[data_axis]
        if max_batch % dp != 0:
            raise ValueError(f"max_batch={max_batch} not divisible by data={dp}")
        local_model, rules = model.tp_localize(tp, axis=model_axis)
        params = localize_params(params, rules, tp)
        mine = shard_params_local(params, build_param_specs(params, rules, axis=model_axis),
                                  mesh)
        # The local engine bakes the slice's kernel scales.
        self.local = InferenceEngine(local_model, mine, max_batch // dp, max_seq, kv_quant,
                                     dtype, fused_attention, mlp_megakernel)
        self.model = model
        self.max_batch, self.max_seq, self.dtype = max_batch, max_seq, dtype
        self.params, self.device = self.local.params, self.local.device
        self.cache_cfg = self.local.cache_cfg
        lb = self.local.max_batch
        self._rows = slice(mesh.coords[data_axis] * lb, (mesh.coords[data_axis] + 1) * lb)
        self.local._noise_window = (self._rows, max_batch)

    def _mine(self, a):
        """This rank's batch rows of a per-slot host array or tensor (None stays)."""
        return None if a is None else a[self._rows]

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in batch order."""
        from onnx_quantize_tpu_torch.parallel.comm import all_gather

        return all_gather(t, self._data_axis, dim=0)

    def _on_mesh(self):
        from onnx_quantize_tpu_torch.parallel.mesh import use_mesh

        return use_mesh(self.mesh)

    def new_cache(self) -> dict:
        """An empty cache (on a mesh: this rank's rows and local KV heads)."""
        if self.mesh is not None:
            return self.local.new_cache()
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

    def _forward(self, cache, ids, positions, kv_positions, write_mask, last_lengths=None,
                 kv_write=None):
        """The model over ``ids`` (B, T) with the cache: by default each
        layer's new K/V rows go into ``cache`` where ``write_mask`` (B, n) is
        set, for the leading n <= T columns, and attention reads the whole
        cache; ``kv_write`` replaces that writer."""
        # The flash-decode kernel serves one-token forwards only.
        fused = self._fused_attn and ids.shape[1] == 1

        def kv_write_fn(layer, k, v):
            n = write_mask.shape[1]
            write_kv(cache, layer, k[:, :n], v[:, :n], positions[:, :n], write_mask)
            if self.cache_cfg.quantized:
                return read_kv_quantized(cache, layer, use_kernel=fused)
            return read_kv(cache, layer, dtype=self.dtype)

        kv_write_fn = kv_write or kv_write_fn

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
        # A row outside the written slots (length 0, or an in-flight
        # sequence's length past T) gathers a clamped position; its logits
        # are unused.
        idx = (last_lengths - 1).clamp(0, hidden.shape[1] - 1).long()[:, None, None].expand(
            -1, 1, hidden.shape[-1])
        h_last = torch.gather(hidden, 1, idx)  # (B, 1, H)
        return model.logits(params, h_last)

    @contextlib.contextmanager
    def _without_auto_ragged(self):
        """MoE layers on "auto" keep their experts dense-masked: the ragged
        prefill fetches each layer's group sizes to the host."""
        mlps = [block.mlp for block in getattr(self.model, "layers", [])
                if getattr(block.mlp, "use_ragged_prefill", None) == "auto"]
        for mlp in mlps:
            mlp.use_ragged_prefill = False
        try:
            yield
        finally:
            for mlp in mlps:
                mlp.use_ragged_prefill = "auto"

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
    def prefill(self, cache: dict, ids, lengths, slot_mask=None, with_tokens: bool = False,
                prefix: dict | None = None):
        """Prefill ``ids`` (B, T_pad) with true ``lengths`` (B,) into ``cache``
        (updated in place); returns (cache, last-token logits (B, V)).

        ``slot_mask`` (B,) selects the slots written (default: all); the other
        slots keep their cache rows and lengths, and their logits are
        meaningless. ``with_tokens=True`` also returns the greedy first tokens
        (B,) int32, on the device. With ``prefix`` (a :meth:`snapshot_prefix`
        dict of P rows), ``ids`` are the suffix tokens and ``lengths`` the
        totals (P + suffix): the prefix rows go into rows [0, P) of the
        selected slots only, and only the suffix runs, at positions P..P+T-1.
        """
        if self.mesh is not None:
            if prefix is not None:
                raise NotImplementedError(
                    "prefix caching is single-chip for now (shard the prefix "
                    "rows with the cache specs to extend it)")
            with self._on_mesh():
                out = self.local.prefill(cache, self._mine(ids), self._mine(lengths),
                                         self._mine(slot_mask), with_tokens)
                return (cache, *(self._gathered(t) for t in out[1:]))
        ids = self._token_ids(ids)
        B, T = ids.shape
        P = 0 if prefix is None else prefix["k"].shape[1]
        if T > self.max_seq:
            raise ValueError(f"prompt length {T} exceeds max_seq={self.max_seq}")
        top = min(P + T, self.max_seq)
        if not isinstance(lengths, torch.Tensor):
            host = np.asarray(lengths)
            sel = (np.ones(B, bool) if slot_mask is None or isinstance(slot_mask, torch.Tensor)
                   else np.asarray(slot_mask, bool))
            if not ((host[sel] >= P) & (host[sel] <= top)).all():
                raise ValueError(f"lengths must lie in [{P}, {top}]")
        lengths = self._tensor(lengths, torch.int32)
        if slot_mask is None:
            slot_mask = torch.ones((B,), dtype=torch.bool, device=self.device)
        else:
            slot_mask = self._tensor(slot_mask, torch.bool)
        if prefix is not None:
            # The cache is written in place, so the prefix goes only into the
            # selected slots: every other slot may hold an in-flight sequence.
            for key, rows in prefix.items():
                region = cache[key][:, :, :P]
                sel = slot_mask.reshape(1, B, *([1] * (region.ndim - 2)))
                region.copy_(torch.where(sel, rows[:, None].to(region.dtype), region))
        positions = P + torch.arange(T, dtype=torch.int32, device=self.device)[None, :].expand(B, T)
        slot = torch.arange(self.max_seq, dtype=torch.int32, device=self.device)[None, :]
        kv_positions = torch.where(slot < lengths[:, None], slot, _FAR)
        # A suffix bucket may run past max_seq; those padding columns are not
        # written (the JAX scatter drops them). The hidden states cover the
        # T suffix positions: the last-token gather is suffix-local.
        logits = self._forward(cache, ids, positions, kv_positions,
                               slot_mask[:, None].expand(B, top - P),
                               last_lengths=lengths - P)[:, 0]
        cache["lengths"] = torch.where(slot_mask, lengths, cache["lengths"])
        if with_tokens:
            return cache, logits, torch.argmax(logits, dim=-1).to(torch.int32)
        return cache, logits

    def snapshot_prefix(self, cache: dict, row: int, length: int) -> dict:
        """Rows [0, length) of slot ``row`` as a reusable KV prefix: (L, length,
        H, D) K/V (and (L, length, H) scales), copies on the device, for
        :meth:`prefill`'s ``prefix``."""
        if self.mesh is not None:
            raise NotImplementedError("prefix caching is single-chip for now")
        keys = ["k", "v"] + (["k_scale", "v_scale"] if self.cache_cfg.quantized else [])
        return {key: cache[key][:, row, :length].clone() for key in keys}

    @torch.inference_mode()
    def _admit_prefill(self, cache: dict, ids, lengths, slots):
        """Narrow admission prefill: the forward runs over the A admitted rows
        only, at (A, T_pad), where the masked prefill runs all B.

        ``ids`` (A, T_pad), ``lengths`` (A,) and ``slots`` (A,) are host
        arrays; the bucket's padding rows carry ``slots = max_batch`` and are
        dropped on the host (:func:`admitted_rows`): they touch no cache row,
        length or token. Each layer's K/V rows go into their slots, and the
        admission's attention reads the fresh rows and nothing of the wide
        cache (the masked path's extra keys add exact zeros to its softmax).

        Returns (logits (A, V), greedy (A,) int32, rows, slot_index): the
        last two are the real rows and their slots, as device index tensors.
        """
        ids = self._token_ids(ids)
        A, T = ids.shape
        if T > self.max_seq:
            raise ValueError(f"prompt length {T} exceeds max_seq={self.max_seq}")
        host = np.asarray(lengths)
        if not ((host >= 1) & (host <= T)).all():
            raise ValueError(f"lengths must lie in [1, {T}]")
        rows, slot_index = admitted_rows(slots, self.max_batch, self.device)
        lengths = self._tensor(lengths, torch.int32)
        positions = torch.arange(T, dtype=torch.int32, device=self.device)[None, :].expand(A, T)
        kv_positions = torch.where(positions < lengths[:, None], positions, _FAR)

        def kv_write(layer, k, v):
            fresh = write_kv_rows(cache, layer, k, v, positions, rows, slot_index)
            if self.cache_cfg.quantized:
                return fresh
            # What the masked path reads back: the cache's dtype, then the engine's.
            return tuple(t.to(self.cache_cfg.dtype).to(self.dtype) for t in fresh)

        logits = self._forward(cache, ids, positions, kv_positions, None, last_lengths=lengths,
                               kv_write=kv_write)[:, 0]
        cache["lengths"] = cache["lengths"].index_put((slot_index,), lengths[rows])
        return logits, torch.argmax(logits, dim=-1).to(torch.int32), rows, slot_index

    def decode(self, cache: dict, tokens, active=None):
        """One decode step for every active slot; returns (cache, logits (B, V))."""
        if self.mesh is not None:
            with self._on_mesh():
                _, logits = self.local.decode(cache, self._mine(tokens), self._mine(active))
                return cache, self._gathered(logits)
        tokens = self._token_ids(tokens)
        active = (torch.ones(tokens.shape, dtype=torch.bool, device=self.device)
                  if active is None else self._tensor(active, torch.bool))
        with tracing.span("engine.decode"):
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
        if self.mesh is not None:
            with self._on_mesh():
                _, gen = self.local.decode_multi(cache, self._mine(tokens), steps,
                                                 self._mine(active), sampling, generator,
                                                 eos_token_id)
                return cache, self._gathered(gen)
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
                nxt = sample(logits, generator, sampling, self._noise_window).to(torch.int64)
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
        if self.mesh is not None:
            raise NotImplementedError(
                "score_nll is single-chip (shard the score scan with the "
                "decode specs to extend it)")
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

    @torch.inference_mode()
    def serve_chunk(self, cache: dict, tokens, steps: int, *, eos, sampling_arrays,
                    variant: tuple[bool, bool, bool], generator: torch.Generator | None = None,
                    active=None, budgets=None, carry=None, admit_ids=None, admit_lengths=None,
                    admit_mask=None, admit_slots=None, admit_budgets=None):
        """One serving round: an optional admission, first-token sampling,
        then ``steps`` decode steps with per-slot sampling, EOS, budgets and
        capacity. An eager loop with no host sync inside it: an MoE model's
        admission keeps its experts dense-masked where its ragged prefill
        is on "auto".

        ``sampling_arrays`` = (temps, top_ks, top_ps) per slot (build with
        ``sampling.batch_sampling_arrays``), ``variant`` their static flags
        (need_temp, need_topk, need_topp); ``eos`` (B,) EOS ids, -1 for none.
        The entry state comes from host arrays (``tokens``, ``active``,
        ``budgets``: remaining tokens per slot, the admission's first token
        counted against it) or from the previous round's ``carry``, which
        stays on the device, so a continuation round is queued before the
        previous round's blob is read.

        Admission: ``admit_ids`` (B, T_pad) with ``admit_lengths`` (B,) and
        ``admit_mask`` (B,) runs the masked prefill of the whole batch;
        ``admit_ids`` (A, T_pad) with ``admit_lengths`` (A,) and
        ``admit_slots`` (A,) the narrow one (padding rows carry max_batch).
        ``admit_budgets`` (B,) overrides the admitted slots' budgets (a
        planned admission into a slot whose old budget is in the carry).

        A slot freezes (no KV write, no length advance, its output padded
        with its EOS id or its last token) when it emits EOS, spends its
        budget or reaches max_seq. Returns ``(cache, blob, carry)``: blob
        (B, steps + 4) int32 on the device with columns ``[t0, out..., emitted,
        done, lengths]`` (``emitted`` counts the valid leading ``out``
        tokens), carry = (tokens, done, budgets) after the round.
        """
        if self.mesh is not None:
            if admit_ids is not None and admit_slots is not None:
                raise NotImplementedError(
                    "narrow admission is single-chip; mesh engines use "
                    "the full masked admission")
            mine = self._mine
            with self._on_mesh():
                _, blob, carry = self.local.serve_chunk(
                    cache, mine(tokens), steps, eos=mine(eos),
                    sampling_arrays=tuple(mine(a) for a in sampling_arrays), variant=variant,
                    generator=generator, active=mine(active), budgets=mine(budgets),
                    carry=None if carry is None else tuple(mine(c) for c in carry),
                    admit_ids=mine(admit_ids), admit_lengths=mine(admit_lengths),
                    admit_mask=mine(admit_mask), admit_budgets=mine(admit_budgets))
                return cache, self._gathered(blob), tuple(self._gathered(c) for c in carry)
        with tracing.span("engine.serve_chunk"):
            need_temp, need_topk, need_topp = variant
            temps, top_ks, top_ps = sampling_arrays
            temps = self._tensor(temps, torch.float32)
            top_ks = self._tensor(top_ks, torch.int32)
            top_ps = self._tensor(top_ps, torch.float32)

            def samp(logits):
                return sample_batch(logits, generator, temps, top_ks, top_ps, need_temp=need_temp,
                                    need_topk=need_topk, need_topp=need_topp,
                                    window=self._noise_window)

            if carry is not None:
                toks, done, budgets = carry
            else:
                toks = self._token_ids(tokens)
                done = ~self._tensor(active, torch.bool)
                budgets = self._tensor(budgets, torch.int32)
            eos = self._tensor(eos, torch.int64)
            eos_on = eos >= 0
            B = toks.shape[0]
            if admit_ids is not None:
                with tracing.span("engine.admit"):
                    if admit_slots is not None:
                        with self._without_auto_ragged():
                            logits_a, greedy_a, rows, slot_index = self._admit_prefill(
                                cache, admit_ids, admit_lengths, admit_slots)
                        mask = torch.zeros((B,), dtype=torch.bool,
                                           device=self.device).index_fill_(0, slot_index, True)
                        if need_temp:
                            # The noise is drawn per position of the (B, V) matrix, so
                            # the A rows go into their slots' rows first: the sampled
                            # tokens then equal the masked path's.
                            last = torch.zeros((B, logits_a.shape[-1]), dtype=logits_a.dtype,
                                               device=self.device).index_put((slot_index,),
                                                                             logits_a[rows])
                            t0 = samp(last)
                        else:
                            t0 = toks.index_put((slot_index,), greedy_a[rows].to(toks.dtype))
                    else:
                        with self._without_auto_ragged():
                            cache, last = self.prefill(cache, admit_ids, admit_lengths,
                                                       slot_mask=admit_mask)
                        mask = self._tensor(admit_mask, torch.bool)
                        t0 = samp(last)
                    toks = torch.where(mask, t0, toks)
                    emitted0 = mask.to(torch.int32)
                    done = (done & ~mask) | (mask & eos_on & (t0 == eos))
                    if admit_budgets is not None:
                        budgets = torch.where(mask, self._tensor(admit_budgets, torch.int32),
                                              budgets)
            else:
                t0 = toks
                emitted0 = torch.zeros_like(budgets)
            done = done | (emitted0 >= budgets) | (cache["lengths"] >= self.max_seq)
            emitted = torch.zeros_like(budgets)
            out = []
            for _ in range(steps):
                with tracing.span("engine.decode"):
                    act = ~done  # a frozen slot stays frozen for the rest of the round
                    logits = self._decode_step(cache, toks, act)
                    nxt = samp(logits)
                    # A frozen slot emits padding, which the host drops by ``emitted``.
                    nxt = torch.where(done, torch.where(eos_on, eos.clamp(min=0), toks), nxt)
                    emitted = emitted + act.to(torch.int32)
                    done = (done | (act & eos_on & (nxt == eos)) | (emitted0 + emitted >= budgets)
                            | (cache["lengths"] >= self.max_seq))
                    out.append(nxt)
                    toks = nxt
            cols = [t0[:, None], *(o[:, None] for o in out), emitted[:, None], done[:, None],
                    cache["lengths"][:, None]]
            blob = torch.cat([c.to(torch.int32) for c in cols], dim=1)
            return cache, blob, (toks, done, budgets - emitted0 - emitted)

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
