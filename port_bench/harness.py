"""One run of one cell of the benchmark.

Everything that belongs to one configuration, traffic mix, per-layer
metric or system is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the path the manifest names): the model's
  sizes, the pipeline's settings, the stated precision per stage, the
  system that runs it (``systems/<system>.py``) and its ViT kernels;
- ``traffic/<traffic>.json``: parameters of the one generator
  (``traffic.py``), and settings laid over the configuration's;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one metric, which
  returns None where it finds nothing to read;
- ``limits/<cell>.json``: the limit of each number the comparison reads.

A run loads and warms up (set-up), drives the system in a closed loop
with two batches in flight for at least ``--seconds`` (the window closes
at the first completion after that), optionally traces a steady stretch
of whole batches, then judges the sampled outputs against the reference
and prints one JSON line.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pnp_ovss_tpu")


def deep_update(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def plan(workload: str, root: Path, bench_dir: Path = BENCH_DIR) -> Dict:
    """Resolve a cell by name: its manifest entries and every file that
    belongs to it."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) \
        if limits_path.exists() else {}

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [
            dict(m, reader=bench_dir / "metrics" / f"{m['name']}.py")
            for m in manifest[kind] if applies(m)]
    return {
        "cell": cell, "config": cfg, "traffic": traffic, "limits": limits,
        "pipeline": deep_update(cfg["pipeline"], traffic.get("pipeline", {})),
        "precision": dict(cfg["precision"], **traffic.get("precision", {})),
        "system": bench_dir / "systems" / f"{cfg['system']}.py",
        "metrics": metrics,
    }


def read_metrics(entries: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        safe = "port_bench_metric_" + m["name"].replace(".", "_")
        value = _load_module(m["reader"], safe).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, chips: int) -> Dict:
    import torch

    if getattr(device, "type", str(device)).startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def power_limit_w() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(p: Dict, *, seed: int, seconds: float, trace: bool, device,
             t0: float, log=print, keep: Optional[Dict] = None) -> Dict:
    """One run of the cell ``p`` (``plan``). Returns the result line.
    ``keep`` receives the pool, vocabulary, sampled records and each
    image's readings (the calibration reads them)."""
    import torch

    from port_bench import check, traffic as traffic_mod

    on_gpu = str(device).startswith("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, pipe, traffic = p["config"], p["pipeline"], p["traffic"]
    vit = cfg["model"]["vit"]
    pool = traffic_mod.make_pool(traffic, batch=pipe["batch_size"],
                                 image_size=vit["image_size"],
                                 bucket=pipe["bucket"], seed=seed,
                                 device=device)
    vocab = traffic_mod.vocab(traffic)
    sample = traffic_mod.check_sample(traffic, seed, pool)
    system_cls = _load_module(p["system"], "port_bench_system").System
    system = system_cls(cfg, pipe, pool, vocab, seed=seed, device=device,
                        sample=sample)

    # Warm-up at the cell's own shapes, outside the sampled indices.
    for _ in range(traffic["warmup_batches"]):
        system.collect(system.submit(-1))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            system.collect(system.submit(-1))
        prof = profile(activities=[ProfilerActivity.CUDA])
    if on_gpu:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    system.reset_launches()
    setup_s = time.perf_counter() - t0

    # Everything set-up made moves to the collector's permanent
    # generation, so that its full passes in the window do not scan the
    # model, the pool and the kernels' state again (steadier windows).
    gc.collect()
    gc.freeze()
    # -- the window -----------------------------------------------------
    first_traced = traffic["trace"]["skip_batches"]
    n_traced = traffic["trace"]["batches"]
    min_batches = max(sample) + 1
    lat: List[float] = []
    done: List[float] = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    pending, i, t_last = None, 0, t_start
    tr_t = {}
    while True:
        now = time.perf_counter()
        nxt = system.submit(i) if (now < t_end or i < min_batches) else None
        if nxt is not None:
            i += 1
        if pending is not None:
            system.collect(pending)
            t_last = time.perf_counter()
            lat.append(t_last - pending.t_submit)
            done.append(t_last - t_start)
            j = pending.index
            if prof is not None and j == first_traced - 1:
                prof.start()
                tr_t["start"] = time.perf_counter()
            if prof is not None and j == first_traced - 1 + n_traced:
                prof.stop()
                tr_t["stop"] = time.perf_counter()
        pending = nxt
        if pending is None:
            break
    window_s = t_last - t_start
    if prof is not None and "stop" not in tr_t and "start" in tr_t:
        prof.stop()
        tr_t["stop"] = time.perf_counter()
    submitted = i
    window_peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    launches = system.launches()
    expected = system.expected_launches()
    quarter = window_s / 4
    log(json.dumps({"launches_per_batch": {
        k: v / submitted for k, v in launches.items() if v},
        "expected_per_batch": {k: v for k, v in expected.items() if v},
        "img_s_by_quarter": [
            sum(q * quarter < t <= (q + 1) * quarter for t in done)
            * pipe["batch_size"] / quarter for q in range(4)]}))

    trace_ctx = None
    if prof is not None and "start" in tr_t:
        from port_bench import devtrace

        kernels = devtrace.kernels_of(prof)
        # The images of every batch whose kernels the trace may hold.
        class_counts = [len(c) for b in range(first_traced,
                                              first_traced + n_traced + 1)
                        for c in pool.class_lists[pool.batch_slice(b)]]
        trace_ctx = {"kernels": kernels, "batches": n_traced,
                     "class_counts": class_counts,
                     "wall_s": tr_t["stop"] - tr_t["start"],
                     "busy_s": devtrace.busy_us(kernels) * 1e-6,
                     "untraced_batch_s": (window_s - (tr_t["stop"]
                                                      - tr_t["start"]))
                     / max(1, len(lat) - n_traced)}
    batch = pipe["batch_size"]
    ctx = {
        "config": cfg, "pipeline": pipe, "traffic": traffic,
        "text_len": system.text_len,
        "window": {"seconds": window_s, "batches": len(lat),
                   "images": len(lat) * batch, "batch_s": lat,
                   "setup_s": setup_s, "batch_size": batch},
        "memory": {"window_peak_bytes": window_peak},
        "trace": trace_ctx,
        "power_limit_w": power_limit_w() if on_gpu else None,
    }
    metrics = read_metrics(p["metrics"]["per_layer" if trace
                                        else "end_to_end"], ctx)

    # -- the comparison, after the window --------------------------------
    records = system.records()
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    details: List[Dict] = []
    numbers = check.judge(cfg, pipe, p["precision"], pool, vocab, records,
                          seed, device, details)
    if keep is not None:
        keep.update(pool=pool, vocab=vocab, records=records,
                    details=details, numbers=numbers)
    checks = check.verdict(numbers, p["limits"])
    ok = check.passed(checks)
    failed = 0 if ok else len(records)
    dev = device_info(device, p["cell"]["chips"])
    dev["memory_peak_bytes"] = max(setup_peak, window_peak)
    if ctx["power_limit_w"] is not None:
        dev["power_limit_w"] = ctx["power_limit_w"]
    result = {"correct": ok, "attempted": len(lat) * batch,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_ctx is not None:
        from port_bench import devtrace

        dev["busy_s"] = trace_ctx["busy_s"]
        dev["window_s"] = trace_ctx["wall_s"]
        ops = sorted(devtrace.by_name(trace_ctx["kernels"]).items(),
                     key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": devtrace.idle_gaps(trace_ctx["kernels"])}
    result["checks"] = checks
    return result


def main(argv: List[str], t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = BENCH_DIR.parent
    p = plan(args.workload, root)

    import torch

    chips = p["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(p, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or the JAX package loaded: "
              f"{bad}; no result", file=sys.stderr)
        return 3
    checks = result["checks"]
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0

