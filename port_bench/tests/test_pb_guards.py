"""What the benchmark may import, and the manifest's character rules."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pnp_ovss_tpu"}


def imported_tops(path: Path):
    """Top-level names (before the first dot, whole) of every import."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def modules(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = set(imported_tops(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", modules("reference"), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_system(path):
    tops = set(imported_tops(path))
    assert "pnp_ovss_tpu_torch" not in tops
    assert "port_bench" not in tops  # only its own relative imports


def test_the_top_level_comparison_is_whole():
    names = {"pnp_ovss_tpu_torch", "pnp_ovss_tpu", "jax", "jaxlib"}
    assert {n.split(".")[0] for n in names} & FORBIDDEN == \
        {"pnp_ovss_tpu", "jax", "jaxlib"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_the_character_rules():
    raw = (ROOT / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(line(w) for w in m["command"]) and len(m["command"]) <= 32
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= m["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        names = [e["name"] for e in m[kind]]
        assert len(names) == len(set(names)), kind
        for e in m[kind]:
            assert set(e) <= keys, (kind, set(e) - keys)
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k]), (e["name"], k)
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for e in m["end_to_end"] + m["per_layer"]:
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["per_layer"]:
        assert e["moves"] in e2e
