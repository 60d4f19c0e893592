"""A copy of the benchmark with a narrow cell (``data/tiny.json`` under
``data/tiny_voc.json``) that the CPU runs in seconds, added as files only:
the harness finds them by name."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"
CELL = "tiny.voc"


def make_root(tmp: Path, limits=None) -> Path:
    """tmp/BENCHMARK.json naming the narrow cell, tmp/port_bench a copy of
    the benchmark with the narrow configuration, traffic and limits."""
    bench = tmp / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(DATA / "tiny.json", bench / "configs" / "tiny.json")
    shutil.copy(DATA / "tiny_voc.json", bench / "traffic" / "tiny_voc.json")
    if limits is not None:
        (bench / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "tiny", "source": "test widths", "reduced": [],
        "file": "port_bench/configs/tiny.json", "why": "CPU tests"})
    manifest["workloads"].append({
        "name": CELL, "config": "tiny", "traffic": "tiny_voc", "chips": 1,
        "why": "CPU tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


def run(tmp: Path, *, seed: int = 3, limits=None):
    """One run of the narrow cell on the CPU -> (result line, plan)."""
    from port_bench import harness

    root = make_root(tmp, limits)
    p = harness.plan(CELL, root, root / "port_bench")
    res = harness.run_cell(p, seed=seed, seconds=0.1, trace=False,
                           device="cpu", t0=time.perf_counter(),
                           log=lambda *a: None)
    return res, p
