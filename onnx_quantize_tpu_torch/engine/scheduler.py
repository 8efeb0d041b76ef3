"""Continuous batching scheduler.

Counterpart of ``onnx_quantize_tpu/engine/scheduler.py``. Keeps the decode
batch full: finished sequences release their slot, queued requests are
admitted into free slots, and decode runs over all active slots, the loop
driven from the host over the engine's calls.

Two modes:

* ``chunk == 1``: the per-step loop. One masked prefill call per admission
  group, one decode call and host-side sampling per token. Simple, general,
  and the reference the serve mode is held to.
* ``chunk > 1``: serve mode. Each round is one ``engine.serve_chunk`` call:
  admission prefill, per-slot first-token sampling and ``chunk`` decode
  steps, whose result is one packed int32 blob read with one host fetch.
  Sampling parameters, EOS ids and token budgets are per-slot tensors, so
  mixed batches share a round. A sequence that finishes inside a round holds
  its slot until the round ends, but stops writing KV and advancing its
  length the moment it emits EOS, spends its budget or fills the cache.

With ``pipeline > 1`` (serve mode) up to that many rounds are queued from the
device-resident carry before any blob is read, and admissions into slots
that the budgets say will be free are planned on the host, so a round can
carry its own admission without waiting for the previous one's blob.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque

import numpy as np
import torch

from onnx_quantize_tpu_torch.engine.engine import InferenceEngine
from onnx_quantize_tpu_torch.engine.sampling import (
    SamplingParams,
    batch_sampling_arrays,
    sample,
)

logger = logging.getLogger(__name__)

__all__ = ["Request", "ContinuousBatchingScheduler"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = SamplingParams()
    eos_token_id: int | None = None
    # True when ``prompt`` is the suffix after the scheduler's registered
    # prefix (``register_prefix``): admission writes the cached prefix KV and
    # prefills only the suffix.
    use_prefix: bool = False
    # Filled by the scheduler:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Host clock stamps (time.monotonic): queued by submit(), admitted when
    # the request takes a slot, finished at completion.
    t_submitted: float = 0.0
    t_admitted: float = 0.0
    t_finished: float = 0.0


class ContinuousBatchingScheduler:
    """Admits requests into engine slots and steps the decode batch."""

    def __init__(self, engine: InferenceEngine, generator: torch.Generator | None = None,
                 chunk: int = 1, pipeline: int = 1):
        if chunk < 1 or pipeline < 1:
            raise ValueError(f"chunk and pipeline must be >= 1, got {chunk} and {pipeline}")
        self.engine = engine
        self.chunk = chunk
        # Rounds queued before a blob is read (serve mode only). Admissions
        # into slots that the budgets show free are planned inside a group;
        # a slot freed early (EOS, capacity) waits for the group's end.
        self.pipeline = pipeline
        # Narrow admission (serve mode): groups of at most max_batch / 2
        # forward only their rows, at (A, T_pad), instead of the whole batch.
        # The same tokens, less admission compute. Mesh engines always admit
        # masked, as the JAX package's.
        self.narrow_admit = True
        self.cache = engine.new_cache()
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * engine.max_batch
        self.next_tokens = np.zeros((engine.max_batch,), np.int32)
        # Host mirror of cache["lengths"]: in serve mode it comes with the
        # round's blob; in per-step mode every transition is tracked, so
        # serving never fetches the lengths alone.
        self.lengths = np.zeros((engine.max_batch,), np.int32)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=engine.device).manual_seed(0))
        self._id_counter = itertools.count()
        self.completed: list[Request] = []
        # Sticky sampler flags: once a round needs temperature, top-k or
        # top-p, later rounds keep the wider variant (rows that do not use a
        # feature are unchanged by it).
        self._variant: tuple[bool, bool, bool] = (False, False, False)
        # The shared prompt prefix (register_prefix): its KV rows and length.
        self._prefix: dict | None = None
        self._prefix_len = 0
        # Serve-mode accounting: each round spends B * chunk slot-steps, each
        # on an emitted token, a frozen slot or an empty one, so
        # emitted / slot_steps is the occupancy of the fixed-batch decode.
        self.stats = {
            "rounds": 0, "slot_steps": 0, "emitted": 0,
            "admit_rounds": 0, "planned_admits": 0, "boundary_admits": 0,
        }

    def register_prefix(self, tokens: list[int]) -> int:
        """Cache a shared prompt prefix's KV once; later ``submit(...,
        use_prefix=True)`` requests pass only their suffix, and admission
        skips the prefix's prefill.

        Returns the prefix length. One prefix per scheduler; registering
        again replaces it (in-flight requests keep the rows they were given).
        """
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) >= self.engine.max_seq:
            raise ValueError(
                f"prefix length {len(tokens)} leaves no room in max_seq={self.engine.max_seq}")
        B = self.engine.max_batch
        ids = np.zeros((B, len(tokens)), np.int32)
        ids[0, :] = tokens
        lengths = np.zeros((B,), np.int32)
        lengths[0] = len(tokens)
        mask = np.zeros((B,), bool)
        mask[0] = True
        # A throwaway prefill into slot 0 of a scratch cache, then a snapshot.
        scratch, _ = self.engine.prefill(self.engine.new_cache(), ids, np.maximum(lengths, 1),
                                         slot_mask=mask)
        self._prefix = self.engine.snapshot_prefix(scratch, 0, len(tokens))
        self._prefix_len = len(tokens)
        return self._prefix_len

    def submit(self, prompt: list[int], **kwargs) -> Request:
        request = Request(request_id=next(self._id_counter), prompt=prompt, **kwargs)
        total = len(prompt)
        if request.use_prefix:
            if self._prefix is None:
                raise ValueError("use_prefix=True but no prefix registered")
            if len(prompt) < 1:
                raise ValueError("prefix requests need >= 1 suffix token")
            total += self._prefix_len
        if total > self.engine.max_seq:
            raise ValueError(
                f"prompt length {total} exceeds the engine's max_seq={self.engine.max_seq}; "
                "truncate the prompt or raise max_seq")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        request.t_submitted = time.monotonic()
        self.queue.append(request)
        return request

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # -- admission -------------------------------------------------------

    def _assign_slots(self) -> list[tuple[int, Request]]:
        """Host only: move queued requests into free slots."""
        admitted: list[tuple[int, Request]] = []
        for slot_id, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            request = self.queue.popleft()
            request.t_admitted = time.monotonic()
            self.slots[slot_id] = request
            admitted.append((slot_id, request))
            logger.debug("admitted request %d into slot %d", request.request_id, slot_id)
        return admitted

    def _t_pad(self, admitted) -> int:
        """The admission's padded width: the longest prompt bucketed to a
        multiple of 64 (at most max_seq), so the kernels see a few shapes."""
        longest = max(max(len(r.prompt), 1) for _, r in admitted)
        return max(min(-(-longest // 64) * 64, self.engine.max_seq), longest)

    def _build_admit(self, admitted, offset: int = 0):
        """Padded (ids, lengths, mask) for a masked prefill of the batch.
        ``offset`` shifts the recorded lengths by an implanted prefix's
        length (the ids stay suffix-only)."""
        B = self.engine.max_batch
        ids = np.zeros((B, self._t_pad(admitted)), np.int32)
        lengths = self.lengths.copy()
        mask = np.zeros((B,), bool)
        for slot_id, request in admitted:
            ids[slot_id, : len(request.prompt)] = request.prompt
            lengths[slot_id] = offset + max(len(request.prompt), 1)
            mask[slot_id] = True
        return ids, lengths, mask

    def _build_admit_narrow(self, admitted):
        """(ids (A, T_pad), lengths (A,), slots (A,)) for the narrow
        admission prefill. A is bucketed to a power of two; padding rows
        carry ``slot = max_batch``, which the engine drops on the host."""
        B = self.engine.max_batch
        A = 1
        while A < len(admitted):
            A *= 2
        A = min(A, B)
        ids = np.zeros((A, self._t_pad(admitted)), np.int32)
        lengths = np.ones((A,), np.int32)
        slots = np.full((A,), B, np.int32)
        for i, (slot_id, request) in enumerate(admitted):
            ids[i, : len(request.prompt)] = request.prompt
            lengths[i] = max(len(request.prompt), 1)
            slots[i] = slot_id
            self.lengths[slot_id] = lengths[i]
        return ids, lengths, slots

    def _prefill_group(self, admitted, prefixed: bool) -> None:
        """One masked prefill call for an admission group, and its first tokens."""
        ids, new_lengths, mask = self._build_admit(
            admitted, offset=self._prefix_len if prefixed else 0)
        self.lengths = new_lengths.copy()
        self.cache, logits, greedy = self.engine.prefill(
            self.cache, ids, new_lengths, slot_mask=mask, with_tokens=True,
            prefix=self._prefix if prefixed else None)
        if all(r.sampling.temperature <= 0 for _, r in admitted):
            # Greedy admissions read the argmax computed with the prefill.
            arr = greedy.cpu().numpy()
            tokens = {slot_id: int(arr[slot_id]) for slot_id, _ in admitted}
        else:
            tokens = self._sample_rows(logits, admitted)
        for slot_id, request in admitted:
            request.output.append(tokens[slot_id])
            self.next_tokens[slot_id] = tokens[slot_id]
            hit_eos = request.eos_token_id is not None and tokens[slot_id] == request.eos_token_id
            # A prompt that fills the cache leaves no room to decode: the
            # prefill's token is its one emission.
            if (hit_eos or self.lengths[slot_id] >= self.engine.max_seq
                    or len(request.output) >= request.max_new_tokens):
                self._finish(slot_id, request)

    def _admit(self) -> None:
        """Per-step admission: one masked prefill call per group (the
        prefix requests, then the plain ones)."""
        admitted = self._assign_slots()
        for prefixed in (True, False):
            group = [a for a in admitted if a[1].use_prefix == prefixed]
            if group:
                self._prefill_group(group, prefixed)

    def _sample_rows(self, logits, pairs) -> dict[int, int]:
        """Next tokens for the (slot, request) pairs, one ``sample`` call per
        distinct SamplingParams (per-step mode; serve mode samples per slot
        inside the round)."""
        by_params: dict[SamplingParams, list[int]] = {}
        for slot_id, request in pairs:
            by_params.setdefault(request.sampling, []).append(slot_id)
        out: dict[int, int] = {}
        for params, slot_ids in by_params.items():
            toks = sample(logits, self.generator, params).cpu().numpy()
            for slot_id in slot_ids:
                out[slot_id] = int(toks[slot_id])
        return out

    def _finish_request(self, request: Request) -> None:
        """Mark complete without touching the slot table (serve mode owns
        slot reuse: a slot may already hold its planned next occupant)."""
        request.done = True
        request.t_finished = time.monotonic()
        self.completed.append(request)
        logger.debug("request %d finished", request.request_id)

    def _finish(self, slot_id: int, request: Request) -> None:
        self._finish_request(request)
        self.slots[slot_id] = None

    # -- serve mode (chunk > 1): one engine call, one fetch a round ------

    def _admit_kwargs(self, admitted, with_budgets: bool) -> dict:
        """serve_chunk's admission arguments (narrow or masked)."""
        if (self.narrow_admit
                and self.engine.mesh is None  # mesh engines: full admission
                and len(admitted) <= self.engine.max_batch // 2):
            ids, lengths, slots = self._build_admit_narrow(admitted)
            kw = dict(admit_ids=ids, admit_lengths=lengths, admit_slots=slots)
        else:
            ids, lengths, mask = self._build_admit(admitted)
            kw = dict(admit_ids=ids, admit_lengths=lengths, admit_mask=mask)
        if with_budgets:
            budgets = np.zeros((self.engine.max_batch,), np.int32)
            for slot_id, request in admitted:
                budgets[slot_id] = request.max_new_tokens - len(request.output)
            kw["admit_budgets"] = budgets
        return kw

    def _slot_arrays(self, occupant: dict[int, Request | None]):
        """(eos, sampling arrays) rows for the given occupancy; widens the
        sticky variant."""
        B = self.engine.max_batch
        eos = np.full((B,), -1, np.int32)
        params_list = []
        for s in range(B):
            request = occupant.get(s)
            params_list.append(request.sampling if request is not None else SamplingParams())
            if request is not None and request.eos_token_id is not None:
                eos[s] = request.eos_token_id
        arrays, variant = batch_sampling_arrays(params_list)
        self._variant = tuple(a or b for a, b in zip(self._variant, variant))
        return eos, arrays

    def _step_serve(self) -> list[Request]:
        """One pipelined group of serve rounds with planned admissions.

        A slot with remaining budget b is done after ceil(b / chunk) rounds at
        the latest (EOS and capacity only end it earlier, and admitting into
        a frozen slot is an ordinary admission). So the host plans each
        later round's admissions from the budgets, and every round of the
        group is queued from the device carry before any blob is read.
        """
        admitted = self._assign_slots()
        prefixed = [a for a in admitted if a[1].use_prefix]
        if prefixed:
            # Prefix admissions run as their own masked prefill call; the
            # serve round takes only plain admissions.
            self._prefill_group(prefixed, prefixed=True)
            admitted = [a for a in admitted if not a[1].use_prefix and not a[1].done]
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not occupied:
            return self._drain_completed()

        B = self.engine.max_batch
        chunk = self.chunk
        active = np.array([s is not None for s in self.slots])
        budgets = np.zeros((B,), np.int32)
        for slot_id, request in occupied:
            budgets[slot_id] = request.max_new_tokens - len(request.output)
        occupant: dict[int, Request] = dict(occupied)
        eos, arrays = self._slot_arrays(occupant)

        admit_kw = self._admit_kwargs(admitted, with_budgets=False) if admitted else {}
        self.cache, blob, carry = self.engine.serve_chunk(
            self.cache, self.next_tokens, steps=chunk, active=active, budgets=budgets, eos=eos,
            sampling_arrays=arrays, variant=self._variant, generator=self.generator, **admit_kw)
        blobs = [blob]
        admits_per_round: list[dict[int, Request]] = [dict(admitted)]
        occupant_per_round: list[dict[int, Request]] = [dict(occupant)]

        # Guaranteed-remaining emissions per slot (an upper bound: EOS and
        # capacity only finish a slot earlier, which is safe for planned reuse).
        admitted0 = {s for s, _ in admitted}
        pred_rem = {s: int(budgets[s]) - (1 if s in admitted0 else 0) - chunk
                    for s, _ in occupied}

        for _ in range(self.pipeline - 1):
            live = any(rem > 0 for rem in pred_rem.values())
            plain_queue = bool(self.queue) and not self.queue[0].use_prefix
            if not live and not plain_queue:
                break
            new_admits: list[tuple[int, Request]] = []
            if plain_queue:
                for s in range(B):
                    if not (self.queue and not self.queue[0].use_prefix):
                        break
                    if s in occupant and pred_rem.get(s, 0) > 0:
                        continue  # still (possibly) running
                    request = self.queue.popleft()
                    request.t_admitted = time.monotonic()
                    occupant[s] = request
                    new_admits.append((s, request))
                    logger.debug("planned admission of request %d into slot %d",
                                 request.request_id, s)
            if not live and not new_admits:
                break
            eos, arrays = self._slot_arrays(occupant)
            admit_kw = self._admit_kwargs(new_admits, with_budgets=True) if new_admits else {}
            self.cache, blob, carry = self.engine.serve_chunk(
                self.cache, None, steps=chunk, eos=eos, sampling_arrays=arrays,
                variant=self._variant, generator=self.generator, carry=carry, **admit_kw)
            blobs.append(blob)
            admits_per_round.append(dict(new_admits))
            occupant_per_round.append(dict(occupant))
            self.stats["planned_admits"] += len(new_admits)
            for s, request in new_admits:
                pred_rem[s] = request.max_new_tokens - 1
            for s in pred_rem:
                pred_rem[s] -= chunk

        self.stats["rounds"] += len(blobs)
        self.stats["slot_steps"] += len(blobs) * B * chunk
        self.stats["admit_rounds"] += sum(1 for a in admits_per_round if a)
        self.stats["boundary_admits"] += len(admits_per_round[0])
        # One host fetch for the whole group: the blobs are stacked on the device.
        fetched = torch.stack(blobs).cpu().numpy()
        for round_idx, blob in enumerate(fetched):
            t0 = blob[:, 0]
            out = blob[:, 1: 1 + chunk]
            emitted = blob[:, -3]
            done = blob[:, -2].astype(bool)
            self.lengths = blob[:, -1].astype(np.int32)
            round_admits = admits_per_round[round_idx]
            self.stats["emitted"] += int(emitted.sum()) + len(round_admits)
            for slot_id, request in occupant_per_round[round_idx].items():
                if request.done:
                    continue
                if slot_id in round_admits:
                    request.output.append(int(t0[slot_id]))
                request.output.extend(int(t) for t in out[slot_id, : emitted[slot_id]])
                if request.output:
                    self.next_tokens[slot_id] = request.output[-1]
                if done[slot_id]:
                    self._finish_request(request)
        for s in range(B):
            request = occupant.get(s)
            self.slots[s] = request if request is not None and not request.done else None
        return self._drain_completed()

    # -- per-step mode (chunk == 1) ------------------------------------------

    def step(self) -> list[Request]:
        """One scheduler iteration: admit, decode, collect finished requests."""
        if self.chunk > 1:
            return self._step_serve()

        self._admit()
        active_mask = np.array([s is not None for s in self.slots])
        if not active_mask.any():
            return self._drain_completed()

        self.cache, logits = self.engine.decode(self.cache, self.next_tokens, active=active_mask)
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        tokens = self._sample_rows(logits, occupied)

        for slot_id, request in occupied:
            token = tokens[slot_id]
            request.output.append(token)
            self.next_tokens[slot_id] = token
            self.lengths[slot_id] = min(int(self.lengths[slot_id]) + 1, self.engine.max_seq)
            hit_eos = request.eos_token_id is not None and token == request.eos_token_id
            out_of_cache = int(self.lengths[slot_id]) >= self.engine.max_seq
            if hit_eos or out_of_cache or len(request.output) >= request.max_new_tokens:
                self._finish(slot_id, request)

        return self._drain_completed()

    def _drain_completed(self) -> list[Request]:
        out, self.completed = self.completed, []
        return out

    def run(self) -> list[Request]:
        """Run until every submitted request completes; returns them in finish order."""
        finished: list[Request] = []
        while self.has_work:
            finished.extend(self.step())
        return finished
