"""A configuration, a traffic mix and a per-layer metric added as files
only: the harness finds each by its name in the manifest, and no file the
benchmark had changes."""

import hashlib
import json
from pathlib import Path

from port_bench import harness
from port_bench.tests import tiny

METRIC = '''"""Batches completed in the window (a count)."""


def read(ctx):
    return ctx["window"]["batches"] or None
'''


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    limits = json.loads((tiny.DATA / "tiny_limits.json").read_text())
    root = tiny.make_root(tmp_path, limits)
    bench = root / "port_bench"
    (bench / "metrics" / "window.batches.py").write_text(METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "window.batches", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "runner", "moves": "img_s",
        "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    # Every file the benchmark already had is as it was.
    before = digests(tiny.BENCH)
    after = digests(bench)
    for rel, digest in before.items():
        if rel.parts[0] != "tests":
            assert after[rel] == digest, rel

    p = harness.plan(tiny.CELL, root, bench)
    assert p["config"]["model"]["vit"]["image_size"] == 48
    assert p["traffic"]["pool_batches"] == 2
    readers = {m["name"]: m["reader"] for m in p["metrics"]["per_layer"]}
    assert readers["window.batches"] == bench / "metrics" / \
        "window.batches.py"
    ctx = {"window": {"batches": 7}, "trace": None,
           "memory": {"window_peak_bytes": 0}}
    got = harness.read_metrics(
        [m for m in p["metrics"]["per_layer"]
         if m["name"] in ("window.batches", "vit.kernel_ms",
                          "device.idle_share")], ctx)
    # The new reader reads; readers that find nothing leave their metric
    # out of the line.
    assert got == {"window.batches": {"value": 7.0, "unit": "count"}}

    res = harness.run_cell(p, seed=3, seconds=0.1, trace=False,
                           device="cpu", t0=0.0, log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"img_s", "setup_s"}


def test_every_batch_and_seed_holds_the_same_work():
    from port_bench import traffic

    spec = json.loads((tiny.BENCH / "traffic" / "voc.json").read_text())
    spec = dict(spec, pool_batches=3)
    seen = []
    for seed in (1, 2**31 + 7):
        pool = traffic.make_pool(spec, batch=6, image_size=16, bucket=8,
                                 seed=seed, device="cpu")
        for b in range(3):
            lists = pool.class_lists[pool.batch_slice(b)]
            seen.append(sorted(len(c) for c in lists))
            assert all(len(set(c)) == len(c) for c in lists)
        assert set(pool.gt_sizes) == {(375, 500)}
        assert pool.images.shape == (18, 16, 16, 3)
    assert all(s == [1, 1, 2, 2, 3, 4] for s in seen)
    assert pool.class_lists != traffic.make_pool(
        spec, batch=6, image_size=16, bucket=8, seed=1,
        device="cpu").class_lists
