"""Closed-loop chat through the port's ContinuousBatchingScheduler in serve
mode (``engine.serve_chunk``).

Each client sends its next request the moment its previous one is
delivered complete. A request's prompt length and output budget come from
a fixed pool drawn once from the mix's ``pool.seed`` (log-normal, clipped),
in an order fixed by that seed too, so every run serves the same sizes to
the same clients and the work of a window does not change with the run's
seed; the run's seed draws the token ids, the weights and the sampling
noise. Every ``greedy_every``-th request is greedy, the others sampled.
There is no EOS: budgets end requests.

Warm-up (set-up): each client's first request takes a uniform fraction of
its budget, so the live requests' remaining lengths start spread as in a
steady state; clients join in groups, shortest prompts first, and
``settle_groups`` more groups follow. The window opens
on a group's fetch and closes on the first fetch at least ``--seconds``
later, so no partial group is counted. Token delivery is stamped at each
group's fetch (the scheduler's only host read). Because the sizes are
fixed, every run serves the same groups in the same order, and only where
the window closes depends on the program's speed: each run prints, on
standard error, the end-to-end readings it would have given had the
window closed at each earlier fetch past half of ``--seconds`` (the
"edges" line), which shows how far a shorter window or a slower group
moves them.

``--trace 1`` runs the same window, then ``trace_groups`` more groups under
``torch.profiler`` with each round's admissions and emitted counts recorded,
for the kernels' rooflines, ``mfu`` and the idle share.

Once the window has closed and the program is freed, a seeded sample of the
greedy requests finished in the window, the longest among them, goes to the
reference (``reference/judge.py``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from h100bench.benchlib import program as prog
from h100bench.benchlib import stats
from h100bench.benchlib import trace as tr
from h100bench.benchlib.outcome import Check, Outcome
from h100bench.benchlib.roofline import Work
from h100bench.benchlib.weights import Shapes
from h100bench.reference import judge


class Traffic:
    """Every client's request stream: sizes from the mix, ids from the seed."""

    def __init__(self, p: dict, seed: int, vocab: int):
        self.p, self.seed, self.vocab = p, seed, vocab
        pool = np.random.default_rng(p["pool"]["seed"])
        size = p["pool"]["size"]

        def draw(d):
            x = np.exp(math.log(d["median"]) + d["sigma"] * pool.standard_normal(size))
            return np.clip(np.round(x), d["min"], d["max"]).astype(np.int64)

        self.prompt_len, self.budget = draw(p["prompt"]), draw(p["output"])
        self.order = pool.permutation(size)
        self.first_frac = pool.uniform(0.0, 1.0, p["clients"])

    def request(self, client: int, j: int):
        """(prompt ids, budget, greedy) of the client's j-th request."""
        g = client + self.p["clients"] * j
        k = self.order[g % len(self.order)]
        n, budget = int(self.prompt_len[k]), int(self.budget[k])
        if j == 0:
            budget = max(1, math.ceil(self.first_frac[client] * budget))
        ids = np.random.default_rng([self.seed, 2, client, j]).integers(0, self.vocab, n)
        return ids.tolist(), budget, g % self.p["greedy_every"] == 0


class Record:
    __slots__ = ("request", "greedy", "budget", "deliveries")

    def __init__(self, request, greedy: bool, budget: int):
        self.request, self.greedy, self.budget = request, greedy, budget
        self.deliveries: list[tuple[float, int]] = []


class Loop:
    """The clients, the scheduler, and the deliveries stamped at each fetch."""

    def __init__(self, sched, traffic: Traffic, sampled):
        from onnx_quantize_tpu_torch.engine.sampling import SamplingParams

        self.sched, self.traffic = sched, traffic
        self.greedy_params = SamplingParams()
        self.sampled_params = SamplingParams(**sampled)
        self.live: dict[int, Record] = {}
        self.count: dict[int, int] = {}
        self.seen: dict[int, int] = {}
        self.records: list[Record] = []
        self.submitting = True

    def submit(self, client: int, extra: int = 0) -> None:
        """The client's next request; ``extra`` tokens are added to its
        budget (within the cache)."""
        j = self.count.get(client, 0)
        ids, budget, greedy = self.traffic.request(client, j)
        budget = min(budget + extra, self.sched.engine.max_seq - len(ids))
        self.count[client] = j + 1
        req = self.sched.submit(ids, max_new_tokens=budget,
                                sampling=self.greedy_params if greedy else self.sampled_params)
        rec = Record(req, greedy, budget)
        self.live[client], self.seen[client] = rec, 0
        self.records.append(rec)

    def group(self) -> float:
        """One scheduler step (a pipelined group of rounds and its fetch)."""
        with tr.span("scheduler.step"):
            self.sched.step()
        t = time.monotonic()
        with tr.span("harness.deliveries"):
            for client, rec in list(self.live.items()):
                n = len(rec.request.output)
                if n > self.seen[client]:
                    rec.deliveries.append((t, n - self.seen[client]))
                    self.seen[client] = n
                if rec.request.done:
                    del self.live[client]
                    if self.submitting:
                        self.submit(client)
        return t


class WorkLog:
    """Each serve round's admissions and emitted counts, for the work counts."""

    def __init__(self, engine):
        self.rounds, self.on = [], False
        inner = engine.serve_chunk

        def serve_chunk(cache, tokens, steps, **kw):
            out = inner(cache, tokens, steps, **kw)
            if self.on:
                self.rounds.append((kw, steps, out[1]))
            return out

        engine.serve_chunk = serve_chunk

    def tally(self, work: Work, max_batch: int) -> dict:
        w4 = fd = flops = 0.0
        for kw, steps, blob in self.rounds:
            lengths = kw.get("admit_lengths")
            if lengths is not None:
                lengths = np.asarray(lengths)
                if kw.get("admit_slots") is not None:
                    ns = lengths[np.asarray(kw["admit_slots"]) < max_batch]
                else:
                    ns = lengths[np.asarray(kw["admit_mask"], bool)]
                tokens = int(ns.sum())
                w4 += work.w4_least_s(tokens)
                flops += work.flops(tokens, sum(Work.causal_context(int(n)) for n in ns), len(ns))
            b = blob.cpu().numpy()
            emitted, end = b[:, -3].astype(np.int64), b[:, -1].astype(np.int64)
            for s in range(steps):
                act = emitted > s
                m = int(act.sum())
                if not m:
                    continue
                rows = int((end[act] - emitted[act] + s + 1).sum())
                w4 += work.w4_least_s(m)
                fd += work.flash_decode_least_s(rows, m)
                flops += work.flops(m, rows, m)
        return {"least_s": {"w4": w4, "flash_decode": fd}, "model_flops": flops}


def _failed(rec: Record, vocab: int) -> bool:
    out = rec.request.output
    return len(out) != rec.budget or any(t < 0 or t >= vocab for t in out)


def _sample(records, seed: int, want_tokens: int, most: int):
    """A seeded sample of greedy finished requests, the longest first."""
    pool = sorted(records, key=lambda r: (-len(r.request.output), r.request.request_id))
    if not pool:
        return []
    chosen = [pool[0]]
    rest = pool[1:]
    order = np.random.default_rng([seed, 3]).permutation(len(rest))
    for i in order:
        if sum(len(r.request.output) for r in chosen) >= want_tokens or len(chosen) >= most:
            break
        chosen.append(rest[i])
    return [(list(r.request.prompt), list(r.request.output)) for r in chosen]


def summarize(records, t_open: float, t_close: float, vocab: int) -> dict:
    """The window's deliveries: tokens delivered at fetches in (t_open,
    t_close]; the time to first token of every request whose first token
    came in the window; the time per output token of every request with two
    or more tokens in the window, finished or not; the finished requests and
    how many of them failed; the requests in flight at some point of it."""
    def inside(x):
        return t_open < x <= t_close

    tokens, ttft, tpot = 0, [], []
    for r in records:
        got = [(tt, n) for tt, n in r.deliveries if inside(tt)]
        n_in = sum(n for _, n in got)
        tokens += n_in
        if r.deliveries and inside(r.deliveries[0][0]):
            ttft.append(1e3 * (r.deliveries[0][0] - r.request.t_submitted))
        if n_in >= 2:
            tpot.append(1e3 * (got[-1][0] - got[0][0]) / (n_in - 1))
    finished = [r for r in records if r.request.done and inside(r.request.t_finished)]
    attempted = sum(1 for r in records if r.request.t_submitted <= t_close
                    and (not r.request.done or r.request.t_finished > t_open))
    return {"tokens": tokens, "ttft_ms": ttft, "tpot_ms": tpot, "finished": finished,
            "failed": sum(_failed(r, vocab) for r in finished), "attempted": attempted}


def _edges(records, t_open: float, closes, seconds: float, vocab: int) -> str:
    """gen_tok_s/ttft_p95_ms/tpot_p95_ms had the window closed at each
    fetch past half of ``seconds``."""
    out = []
    for c in closes:
        if c - t_open < 0.5 * seconds:
            continue
        w = summarize(records, t_open, c, vocab)
        if not w["ttft_ms"] or not w["tpot_ms"]:
            continue
        out.append(f"{c - t_open:.2f} s {w['tokens'] / (c - t_open):.2f}/"
                   f"{stats.percentile(w['ttft_ms'], 95):.1f}/"
                   f"{stats.percentile(w['tpot_ms'], 95):.2f} (n={len(w['ttft_ms'])})")
    return ", ".join(out)


def run(ctx) -> Outcome:
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine

    cfg, p = ctx.cell.config, ctx.cell.traffic
    cuda = torch.device(ctx.device).type == "cuda"
    built = prog.build_program(cfg, ctx.seed, ctx.device)
    eng_p = p["engine"]
    engine = InferenceEngine(built.model, built.tree, max_batch=p["clients"],
                             max_seq=eng_p["max_seq"], kv_quant=eng_p["kv_cache"],
                             dtype=built.dtype, fused_attention=eng_p["fused_attention"])
    if ctx.fault is not None:
        ctx.fault(engine)
    sched = ContinuousBatchingScheduler(
        engine, generator=torch.Generator(device=ctx.device).manual_seed(ctx.seed),
        chunk=p["scheduler"]["chunk"], pipeline=p["scheduler"]["pipeline"])
    vocab = Shapes(cfg).vocab
    traffic = Traffic(p, ctx.seed, vocab)
    loop = Loop(sched, traffic, p["sampled"])
    log = WorkLog(engine)

    # Warm-up: every client joins, shortest first prompts first, at most
    # ``join_clients`` a group and as many as keep the admission's padded
    # rows (a power of two times the longest prompt, bucketed to 64) within
    # ``join_tokens``: the dense-masked admission holds a float32
    # (rows, experts x 2 x width) product. A first request's budget gets the
    # decode steps of the groups that join after it, so none finishes (and
    # comes back with a prompt of another length) while clients join, and
    # at the window's start the remaining budgets are the drawn fractions.
    built_at = time.monotonic()
    clients = sorted(range(p["clients"]), key=lambda c: (len(traffic.request(c, 0)[0]), c))
    groups, group = [], []
    for c in clients:
        rows = 1 << len(group).bit_length()  # the bucket of len(group) + 1 rows
        padded = rows * -(-len(traffic.request(c, 0)[0]) // 64) * 64
        if group and (padded > p["warmup"]["join_tokens"]
                      or len(group) >= p["warmup"]["join_clients"]):
            groups.append(group)
            group = []
        group.append(c)
    groups.append(group)
    steps = p["scheduler"]["chunk"] * p["scheduler"]["pipeline"]
    times = []
    for i, group in enumerate(groups):
        for c in group:
            loop.submit(c, extra=steps * (len(groups) - 1 - i))
        t_open = loop.group()
        times.append(t_open)
    for _ in range(p["warmup"]["settle_groups"]):
        t_open = loop.group()
        times.append(t_open)
    setup_s = t_open - ctx.t_start
    s0 = dict(sched.stats)

    t, closes = t_open, []
    while t - t_open < ctx.seconds:
        t = loop.group()
        closes.append(t)
    t_close = t
    window_s = t_close - t_open
    s1 = dict(sched.stats)

    reading, trace_note = None, "not traced"
    obs = {"quantize_s": built.quantize_s}
    if ctx.trace:
        log.on = True
        t_trace = time.monotonic()
        _, reading = tr.traced(lambda: [loop.group() for _ in range(p["trace_groups"])])
        log.on = False
        obs.update(log.tally(Work(cfg), p["clients"]))
        trace_note = (f"traced {p['trace_groups']} groups: window {reading.window_s:.3f} s, "
                      f"{len(reading.kernels)} kernels, read in "
                      f"{time.monotonic() - t_trace - reading.window_s:.1f} s")
        obs["trace"] = reading
    loop.submitting = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    w = summarize(loop.records, t_open, t_close, vocab)
    tokens, ttft, tpot, finished, failed = (w["tokens"], w["ttft_ms"], w["tpot_ms"],
                                            w["finished"], w["failed"])
    rounds = s1["rounds"] - s0["rounds"]
    obs.update({
        "occupancy": 100.0 * (s1["emitted"] - s0["emitted"]) / max(1, s1["slot_steps"]
                                                                   - s0["slot_steps"]),
        "step_ms": 1e3 * window_s / max(1, rounds * p["scheduler"]["chunk"]),
    })
    e2e = {"gen_tok_s": tokens / window_s, "ttft_p95_ms": stats.percentile(ttft, 95),
           "tpot_p95_ms": stats.percentile(tpot, 95), "setup_s": setup_s}
    info = [f"window {window_s:.3f} s, {tokens} tokens, {len(finished)} requests finished, "
            f"{rounds} rounds",
            f"ttft ms: median {stats.percentile(ttft, 50):.1f}, p95 {e2e['ttft_p95_ms']:.1f}, "
            f"n={len(ttft)}",
            f"tpot ms: median {stats.percentile(tpot, 50):.2f}, p95 {e2e['tpot_p95_ms']:.2f}, "
            f"n={len(tpot)}",
            f"quantize_s {built.quantize_s:.3f}, setup_s {setup_s:.3f}, peak {peak} B",
            trace_note,
            "edges: " + _edges(loop.records, t_open, closes, ctx.seconds, vocab),
            f"set-up: program built at {built_at - ctx.t_start:.1f} s, {len(groups)} joining "
            f"and {p['warmup']['settle_groups']} settling groups, group ends at "
            + " ".join(f"{t - ctx.t_start:.1f}" for t in times)]

    samples = _sample([r for r in finished if r.greedy], ctx.seed, p["check"]["served_tokens"],
                      p["check"]["max_requests"])
    del loop, sched, engine, built, log, traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = ctx.cell.limits
    if samples:
        t_ref = time.monotonic()
        got = judge.served_gaps(cfg, ctx.seed, ctx.device, samples, ctx.controls)
        info.append(f"checked {got['requests']} requests, {got['tokens']} served tokens, "
                    f"argmax share {got['argmax_share']:.4f}, mean gap {got['mean_gap']!r}, "
                    f"reference {time.monotonic() - t_ref:.1f} s")
        for precision in ctx.controls:
            obs.setdefault("controls", {})[precision] = got["control_" + precision]
            info.append(f"control {precision}: {got['control_' + precision]}")
        checks = [Check("max_gap", got["max_gap"], limits["max_gap"]),
                  Check("mean_gap", got["mean_gap"], limits["mean_gap"])]
    else:
        checks = [Check("checked_requests", 0.0, 1.0, upper=False)]
    checks.append(Check("failed_requests", float(failed), 0.0))
    return Outcome(e2e=e2e, obs=obs, checks=checks, attempted=w["attempted"], failed=failed,
                   memory_peak_bytes=int(peak), info=info, trace=reading)
