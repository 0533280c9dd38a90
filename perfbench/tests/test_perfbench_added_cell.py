"""A cell, with a per-layer metric of its own, is added by files alone.

In a copy of ``BENCHMARK.json``, ``perfbench/`` and ``PERF.md`` (whose
list of layers the manifest's tests read), one one-card cell is appended
with its limits file, and one per-layer metric that only it lists, with
its reader. The copy's own tests of the manifest, of the four-card cell's
entries, of the span readers' lists and the forecast loop of the added
cell must then pass with no other file edited."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ADDED = {"name": "pe512x20.forecast50", "config": "pe512x20",
         "traffic": "pe.forecast50", "chips": 1,
         "why": "an added cell: 50-step forecasts of pe512x20"}
METRIC = {"name": "added.forecast_ms", "unit": "ms", "better": "lower",
          "source": "host_clock", "layer": "driver", "moves": "step_ms",
          "workloads": [ADDED["name"]]}
READER = '''"""added.forecast_ms: the mean forecast's time, in ms."""


def read(record):
    if not record.forecasts:
        return None
    return 1e3 * sum(f.seconds for f in record.forecasts) \\
        / len(record.forecasts)
'''


def test_a_cell_is_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copy(ROOT / "PERF.md", tmp_path)
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(ADDED)
    bench["per_layer"].append(METRIC)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    shutil.copy(bench_dir / "limits" / "pe512x20.forecast.json",
                bench_dir / "limits" / f"{ADDED['name']}.json")
    (bench_dir / "metrics" / f"{METRIC['name']}.py").write_text(READER)

    tests = "perfbench/tests/"
    loop = tests + "test_perfbench_rehearsal.py::test_forecast_loop_on_the_cpu"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "not cuda", tests + "test_perfbench_manifest.py",
         tests + "test_perfbench_mesh.py::"
         "test_the_manifest_takes_one_four_card_cell",
         tests + "test_perfbench_program_spans.py::"
         "test_the_readers_are_the_manifests",
         f"{loop}[False-{ADDED['name']}]", f"{loop}[True-{ADDED['name']}]"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout[-4000:], p.stderr[-2000:])
