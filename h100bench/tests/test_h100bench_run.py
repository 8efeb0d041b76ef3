"""run.py refuses to measure without a card, and every cell of
BENCHMARK.json finds its configuration, mix, driver, limits and readers."""

import json
import subprocess
import sys

from h100bench.benchlib.cells import BENCH, ROOT, Cell, load_benchmark


def test_run_refuses_without_a_card(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "qwen1.5-moe.chat-conv", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    for line in out.stdout.splitlines():
        assert not line.strip().startswith("{"), line


def test_every_cell_finds_its_parts():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = Cell(bench, w["name"])
        assert cell.end_to_end and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert hasattr(cell.driver, "run")
        assert all(isinstance(v, (int, float)) for v in cell.limits.values())


def test_benchmark_names_and_paths():
    bench = load_benchmark()
    assert bench["paths"] == ["h100bench"]
    assert bench["command"] == ["python3", "h100bench/run.py"]
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["file"].startswith("h100bench/")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
