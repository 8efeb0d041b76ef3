"""One run of one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's model from the seed, warms up the shapes its traffic uses
(set-up), measures for ``--seconds`` through the cell's driver, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``. The numbers
compared, each beside its limit, are the last lines on standard error and
the last key of the JSON line. Without a CUDA card (or with fewer than the
cell asks for) it exits with code 2 and prints no result; if JAX or the
JAX package was loaded, with code 3.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.benchlib import env  # noqa: E402

T_START = env.process_start()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, outcome, trace: bool, chips: int, kind: str) -> dict:
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m)(outcome.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                             "idle_gaps": outcome.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    env.set_cache_dirs(ROOT)
    from h100bench.benchlib.cells import Cell, load_benchmark
    from h100bench.benchlib.outcome import Context

    cell = Cell(load_benchmark(ROOT), args.workload)
    chips = cell.entry["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no measurement: the cell needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    card = env.card()
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device="cuda", t_start=T_START)
    outcome = cell.driver.run(ctx)
    found = env.jax_modules()
    if found:
        print(f"no result: JAX modules were loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(cell, outcome, bool(args.trace), chips, card["kind"])
    print(f"card: {card['nvidia_smi']}", file=sys.stderr)
    for text in outcome.info:
        print(text, file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    for check in outcome.checks:
        print(f"check {check.line()} {'ok' if check.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
