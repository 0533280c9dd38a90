"""BENCHMARK.json against the contract's shape, every cell's files
resolving by name, and the imports of the benchmark's modules."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
JAX = {"jax", "jaxlib", "flax", "njw_tpu"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        assert NAME.match(w["traffic"]) and w["config"] in {
            c["name"] for c in BENCH["configs"]}
        seen.add(w["name"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_four_card_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_and_reports(name):
    c = harness.cell(name, BENCH)
    assert harness.driver(c) and harness.reference(c)
    assert (ROOT / "perfbench" / "cost" / f"{c.config['cost']}.py").exists()
    for m in c.end_to_end + c.per_layer:
        assert hasattr(harness.reader(m["name"]), "read"), m["name"]
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    # each per-layer metric of the cell moves an end-to-end one it reports
    for m in c.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
    for number in c.limits["numbers"].values():
        assert number["limit"] > 0 and number["fields"]


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.split("/")[0] in BENCH["paths"] and (ROOT / f).exists()


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    base = ROOT.joinpath("perfbench", *parts)
    return sorted(p for p in base.rglob("*.py")
                  if "tests" not in p.relative_to(ROOT / "perfbench").parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_in_the_benchmark(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_port(path):
    assert not {n for n in _imports(path)
                if n in ("njw_tpu_torch",) or n.startswith("njw_tpu")}
    assert "njw_tpu" not in path.read_text()
