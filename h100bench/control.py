"""Readings for a cell's limits: the program's compared numbers beside the
control's (the reference in a precision below the configuration's), on
several seeds in one process. The benchmark's own runs do not run this.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20 --controls fp8,kv4
    python3 h100bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20 \
        --engine kv_cache='"int4"' --engine fused_attention=false

Each seed runs the cell's driver as ``run.py`` does (its set-up, a window
of ``--seconds`` at the cell's load, the reference), then reads each
reference control over the same served tokens or windows. ``--engine``
overrides a key of the mix's ``engine`` settings (a JSON value), to run a
lower-precision path of the program itself (its int4 KV cache) as the
control, judged against the same reference. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.benchlib import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--engine", action="append", default=[])
    args = ap.parse_args(argv)
    env.set_cache_dirs(ROOT)
    from h100bench.benchlib.cells import Cell, load_benchmark
    from h100bench.benchlib.outcome import Context

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(load_benchmark(ROOT), args.workload)
    for item in args.engine:
        key, value = item.split("=", 1)
        cell.traffic["engine"][key] = json.loads(value)
    controls = tuple(c for c in args.controls.split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = cell.driver.run(Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                                      device="cuda", t_start=t0, controls=controls))
        print(json.dumps({"seed": seed, "engine": cell.traffic.get("engine"),
                          "checks": {c.name: c.value for c in out.checks},
                          "controls": out.obs.get("controls", {}), "info": out.info,
                          "e2e": out.e2e}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
