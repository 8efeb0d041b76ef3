"""Closed-loop chat over one long shared context, through the port's
ContinuousBatchingScheduler in serve mode with its prefix cache
(``register_prefix``).

The chat driver's loop (``drivers/chat.py``) with one difference: before the
clients join, the mix's prefix of ``prefix.tokens`` ids, drawn from the
run's seed, is registered once (set-up), and every request is a suffix
behind it (``use_prefix=True``): the suffix and answer sizes come from the
mix's fixed pool as in chat, the suffix ids from the seed. Warm-up, the
window, its edges, the traced groups and the sample for the reference are
the chat driver's. The work counts of the traced groups are DeepSeek-V2's
(``benchlib/roofline_mla.py``): each admitted suffix token sees the prefix
and the suffix before it; each decode step's token sees its sequence.

Once the window has closed and the program is freed, a seeded sample of the
greedy requests finished in the window, the longest among them, goes with
the prefix to the reference (``reference/judge_mla.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from h100bench.benchlib import program_mla as prog
from h100bench.benchlib import stats
from h100bench.benchlib import trace as tr
from h100bench.benchlib.outcome import Check, Outcome
from h100bench.benchlib.roofline_mla import WorkMLA
from h100bench.drivers.chat import Loop, Record, Traffic, WorkLog, _edges, _sample, summarize
from h100bench.reference import judge_mla


class PrefixLoop(Loop):
    """The chat loop whose every request is a suffix behind the registered
    prefix of ``prefix_len`` tokens."""

    def __init__(self, sched, traffic: Traffic, sampled, prefix_len: int):
        super().__init__(sched, traffic, sampled)
        self.prefix_len = prefix_len

    def submit(self, client: int, extra: int = 0) -> None:
        j = self.count.get(client, 0)
        ids, budget, greedy = self.traffic.request(client, j)
        budget = min(budget + extra, self.sched.engine.max_seq - self.prefix_len - len(ids))
        self.count[client] = j + 1
        req = self.sched.submit(ids, max_new_tokens=budget, use_prefix=True,
                                sampling=self.greedy_params if greedy else self.sampled_params)
        rec = Record(req, greedy, budget)
        self.live[client], self.seen[client] = rec, 0
        self.records.append(rec)


def tally(log: WorkLog, work: WorkMLA, max_batch: int, prefix_len: int) -> dict:
    """The W4 sites' least time and the model FLOPs of the logged rounds:
    admissions (suffix tokens behind the prefix where their sub-batch is
    flagged) and decode steps."""
    w4 = flops = 0.0
    for kw, steps, blob in log.rounds:
        lengths = kw.get("admit_lengths")
        if lengths is not None:
            lengths = np.asarray(lengths, np.int64)
            if kw.get("admit_slots") is not None:
                real = np.asarray(kw["admit_slots"]) < max_batch
                pieces = kw["admit_ids"] if isinstance(kw["admit_ids"], list) else [kw["admit_ids"]]
                flags = kw.get("admit_prefixed") or [False] * len(pieces)
                pre = np.concatenate([np.full(len(p), prefix_len if f else 0, np.int64)
                                      for p, f in zip(pieces, flags)])
            else:
                real = np.asarray(kw["admit_mask"], bool)
                pre = np.zeros_like(lengths)
            new, p0 = lengths[real] - pre[real], pre[real]
            w4 += work.w4_least_s(int(new.sum()))
            flops += work.flops(int(new.sum()), int((new * p0 + new * (new + 1) // 2).sum()),
                                int(real.sum()))
        b = blob.cpu().numpy()
        emitted, end = b[:, -3].astype(np.int64), b[:, -1].astype(np.int64)
        for s in range(steps):
            act = emitted > s
            m = int(act.sum())
            if m:
                w4 += work.w4_least_s(m)
                flops += work.flops(m, int((end[act] - emitted[act] + s + 1).sum()), m)
    return {"least_s": {"w4": w4}, "model_flops": flops}


def run(ctx) -> Outcome:
    from onnx_quantize_tpu_torch.engine import ContinuousBatchingScheduler, InferenceEngine

    cfg, p = ctx.cell.config, ctx.cell.traffic
    cuda = torch.device(ctx.device).type == "cuda"
    built = prog.build_program(cfg, ctx.seed, ctx.device)
    eng_p = p["engine"]
    engine = InferenceEngine(built.model, built.tree, max_batch=p["clients"],
                             max_seq=eng_p["max_seq"], kv_quant=eng_p["kv_cache"],
                             dtype=built.dtype, fused_attention=False)
    if ctx.fault is not None:
        ctx.fault(engine)
    sched = ContinuousBatchingScheduler(
        engine, generator=torch.Generator(device=ctx.device).manual_seed(ctx.seed),
        chunk=p["scheduler"]["chunk"], pipeline=p["scheduler"]["pipeline"])
    vocab = cfg["vocab_size"]
    P = p["prefix"]["tokens"]
    prefix = np.random.default_rng([ctx.seed, 4]).integers(0, vocab, P).tolist()
    built_at = time.monotonic()
    sched.register_prefix(prefix)
    registered_at = time.monotonic()
    traffic = Traffic(p, ctx.seed, vocab)
    loop = PrefixLoop(sched, traffic, p["sampled"], P)
    log = WorkLog(engine)

    # Warm-up, as the chat driver's: clients join shortest suffixes first, at
    # most ``join_clients`` a group and as many as keep the group's padded
    # rows within ``join_tokens``; a first request's budget gets the decode
    # steps of the groups that join after it.
    clients = sorted(range(p["clients"]), key=lambda c: (len(traffic.request(c, 0)[0]), c))
    groups, group = [], []
    for c in clients:
        rows = 1 << len(group).bit_length()
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
    obs = {"quantize_s": built.quantize_s, "config": cfg}
    if ctx.trace:
        log.on = True
        t_trace = time.monotonic()
        _, reading = tr.traced(lambda: [loop.group() for _ in range(p["trace_groups"])])
        log.on = False
        obs.update(tally(log, WorkMLA(cfg), p["clients"], P))
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
            f"set-up: program built at {built_at - ctx.t_start:.1f} s, prefix of {P} "
            f"registered in {registered_at - built_at:.1f} s, {len(groups)} joining and "
            f"{p['warmup']['settle_groups']} settling groups, group ends at "
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
        got = judge_mla.served_gaps(cfg, ctx.seed, ctx.device, prefix, samples, ctx.controls)
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
