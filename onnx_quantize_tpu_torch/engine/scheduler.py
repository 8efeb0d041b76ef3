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

A serve-mode admission of at most ``max_batch // 2`` rows is narrow: it
runs only the admitted rows. Over a weight-only tree it runs them as
length-matched sub-forwards (``plan_admission``), so a short prompt is not
padded to the longest one of its group; a tree that quantizes activations
keeps one forward, whose dynamic int8 scales are taken over all its rows.
Requests behind the registered prefix take the narrow admission too, as
their own sub-forwards, which read the prefix's cache rows before their
own; a wider admission runs them as one masked prefill call of their own.

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

from onnx_quantize_tpu_torch import tracing
from onnx_quantize_tpu_torch.engine.engine import InferenceEngine
from onnx_quantize_tpu_torch.engine.sampling import (
    SamplingParams,
    batch_sampling_arrays,
    sample,
)

logger = logging.getLogger(__name__)

__all__ = ["Request", "ContinuousBatchingScheduler", "plan_admission", "ADMIT_M_FLOOR",
           "ADMIT_M_CAP"]

# The tokens (rows x padded width) below which an admission forward stops
# getting proportionally cheaper: a narrow admission is planned as if each
# of its forwards cost at least this many tokens. Measured on an H100 at
# Qwen1.5-MoE-A2.7B's widths (W4 g64, fused experts, int8 cache, max_batch
# 64; PERF.md section 6): one narrow forward of M = 128, 256, 512, 1024,
# 2048 tokens took 0.536, 0.442, 0.377, 0.362, 0.364 ms a token, flat from
# 1024 on; a forward's launches also take the host ~60 ms whatever its M.
# Sampled admissions of 4-16 chat prompts planned at floors of 256-2048 ran
# fastest at 1024 (within 0.3% of the best where another floor won).
ADMIT_M_FLOOR = 1024

# The most tokens (rows x padded width) a forward of two or more rows is
# planned at; one longer prompt still runs alone. A dense-masked MoE
# forward holds about 1 MB a token (every expert's float32 and bf16 gate/up
# product at Qwen1.5-MoE-A2.7B's and DeepSeek-V2-Lite's widths), so 16,384
# tokens, the length of a 16k-token prefix registered as one row, is a
# transient of about 17-18 GB beside the cache and the weights.
ADMIT_M_CAP = 16384


def _bucket(n: int, max_seq: int) -> int:
    """A prompt's padded width: its length bucketed to a multiple of 64 (at
    most max_seq), so the kernels see a few shapes."""
    n = max(n, 1)
    return max(min(-(-n // 64) * 64, max_seq), n)


def _rows_bucket(n: int) -> int:
    """The rows of an admission run as one forward: a power of two."""
    return 1 << (n - 1).bit_length()


def plan_admission(lengths, max_seq: int) -> list[list[int]]:
    """The narrow admission's forwards, for prompts of ``lengths``: lists of
    indices into ``lengths``, each a sub-batch of consecutive prompts in
    length order (the shortest first), that together minimise the sum of
    ``max(rows x padded width, ADMIT_M_FLOOR)`` over the forwards, the fewest
    forwards among equal sums, no forward of two or more rows above
    ``ADMIT_M_CAP`` tokens. A sub-batch runs its exact rows at its longest
    prompt's bucket; the whole admission as one forward keeps its rows
    bucketed to a power of two, as the single forward always ran, and is
    returned in the given order. Host arithmetic only: an exact dynamic
    programme over the sorted prompts, O(n^2)."""
    n = len(lengths)
    order = sorted(range(n), key=lambda i: (max(lengths[i], 1), i))
    width = [_bucket(lengths[i], max_seq) for i in order]
    best = [(0, 0)] + [None] * n  # (cost, forwards) of the plan of order[:j]
    cut = [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(j):
            rows = _rows_bucket(n) if (i, j) == (0, n) else j - i
            if j - i > 1 and rows * width[j - 1] > ADMIT_M_CAP:
                continue
            cost = (best[i][0] + max(rows * width[j - 1], ADMIT_M_FLOOR), best[i][1] + 1)
            if best[j] is None or cost < best[j]:
                best[j], cut[j] = cost, i
    if cut[n] == 0:
        return [list(range(n))]
    plan, j = [], n
    while j:
        plan.append(order[cut[j]:j])
        j = cut[j]
    return plan[::-1]


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
        # forward only their rows instead of the whole batch, as one forward
        # at (A, T_pad) or as length-matched sub-forwards (plan_admission).
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
            "admit_rounds": 0, "planned_admits": 0,
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
        self._prefix = self.engine.prefill_prefix(tokens)
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

    def _t_pad(self, admitted, cap: int | None = None) -> int:
        """The admission's padded width: the longest prompt's bucket, at most
        ``cap`` (default max_seq)."""
        return _bucket(max(len(r.prompt) for _, r in admitted), cap or self.engine.max_seq)

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

    def _build_admit_narrow(self, admitted, offset: int = 0):
        """(ids, lengths (A,), slots (A,)) for the narrow admission prefill.

        Where the engine's rows are independent (no site quantizes its
        activations), the admission runs as :func:`plan_admission`'s
        forwards: ``ids`` is then a list of (A_i, T_i) sub-batches over the
        consecutive rows of ``lengths`` and ``slots``. Otherwise, and where
        the plan is one forward, ``ids`` is one (A, T_pad) array whose rows
        are bucketed to a power of two; padding rows carry
        ``slot = max_batch``, which the engine drops on the host. ``offset``
        is a registered prefix's length, for suffixes after it: the lengths
        are totals, and the widths are bucketed within max_seq - offset."""
        B = self.engine.max_batch
        cap = self.engine.max_seq - offset
        plan = (plan_admission([len(r.prompt) for _, r in admitted], cap)
                if self.engine.rows_independent else [list(range(len(admitted)))])
        pieces, lengths, slots = [], [], []
        for sub in plan:
            group = [admitted[i] for i in sub]
            rows = min(_rows_bucket(len(group)), B) if len(plan) == 1 else len(group)
            ids = np.zeros((rows, self._t_pad(group, cap)), np.int32)
            for i, (slot_id, request) in enumerate(group):
                ids[i, : len(request.prompt)] = request.prompt
                lengths.append(offset + max(len(request.prompt), 1))
                slots.append(slot_id)
                self.lengths[slot_id] = lengths[-1]
            lengths += [offset + 1] * (rows - len(group))
            slots += [B] * (rows - len(group))
            pieces.append(ids)
        return (pieces[0] if len(plan) == 1 else pieces,
                np.array(lengths, np.int32), np.array(slots, np.int32))

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

    def _narrow(self, n: int) -> bool:
        """Whether an admission of ``n`` rows takes the narrow path (mesh
        engines always admit masked, as the JAX package's)."""
        return self.narrow_admit and self.engine.mesh is None and n <= self.engine.max_batch // 2

    def _joins(self, planned) -> bool:
        """Whether the queue's head can join a planned admission beside
        ``planned``: a prefix request, or any beside one, only while the
        admission stays narrow."""
        if not self.queue:
            return False
        if not (self.queue[0].use_prefix or any(r.use_prefix for _, r in planned)):
            return True
        return self._narrow(len(planned) + 1)

    def _admit_kwargs(self, admitted, with_budgets: bool) -> dict:
        """serve_chunk's admission arguments (narrow or masked); a narrow
        admission runs its prefix requests as sub-forwards of their own."""
        if self._narrow(len(admitted)):
            groups = [(g, off) for g, off in (
                ([a for a in admitted if a[1].use_prefix], self._prefix_len),
                ([a for a in admitted if not a[1].use_prefix], 0)) if g]
            built = [self._build_admit_narrow(g, off) if off else self._build_admit_narrow(g)
                     for g, off in groups]
            if len(built) == 1 and not groups[0][1]:
                ids, lengths, slots = built[0]
                kw = dict(admit_ids=ids, admit_lengths=lengths, admit_slots=slots)
            else:
                ids, prefixed = [], []
                for (piece, _, _), (_, off) in zip(built, groups):
                    more = piece if isinstance(piece, list) else [piece]
                    ids += more
                    prefixed += [bool(off)] * len(more)
                kw = dict(admit_ids=ids, admit_lengths=np.concatenate([b[1] for b in built]),
                          admit_slots=np.concatenate([b[2] for b in built]),
                          admit_prefix=self._prefix, admit_prefixed=prefixed)
        else:
            ids, lengths, mask = self._build_admit(admitted)
            kw = dict(admit_ids=ids, admit_lengths=lengths, admit_mask=mask)
        pieces = ids if isinstance(ids, list) else [ids]
        tracing.count("sched.admit_tokens", sum(max(len(r.prompt), 1) for _, r in admitted))
        tracing.count("sched.admit_padded_tokens", sum(p.size for p in pieces))
        tracing.count("sched.admit_forwards", len(pieces))
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
        with tracing.span("sched.plan"):
            admitted = self._assign_slots()
            prefixed = [a for a in admitted if a[1].use_prefix]
            if prefixed and not self._narrow(len(admitted)):
                # A wide admission runs its prefix requests as their own
                # masked prefill call; the serve round takes the plain ones.
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
            with tracing.span("sched.plan"):
                live = any(rem > 0 for rem in pred_rem.values())
                if not live and not self._joins([]):
                    break
                new_admits: list[tuple[int, Request]] = []
                for s in range(B):
                    if not self._joins(new_admits):
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
        # One host fetch for the whole group: the blobs are stacked on the device.
        with tracing.span("sched.fetch"):
            fetched = torch.stack(blobs).cpu().numpy()
        with tracing.span("sched.unpack"):
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
