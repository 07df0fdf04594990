"""The benchmark's files: every cell's configuration, mix, limits and metric
readers are found by name from BENCHMARK.json, a missing one is refused, and
BENCHMARK.json keeps to its required keys, limits and characters."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["limits"], "a cell compares at least one number"
    kinds = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(m["read"])


def _copy_tree(tmp_path: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.mark.parametrize("missing", ["configs/gru256_fp32.json", "mixes/nlink4096.graphed.json",
                                     "limits/gru256_fp32.nlink4096.graphed.json", "metrics/loop_host_ms.py"])
def test_a_missing_file_is_refused(tmp_path, missing):
    root = _copy_tree(tmp_path)
    (root / "portbench" / missing).unlink()
    with pytest.raises(harness.SpecError, match=Path(missing).stem.split(".")[0]):
        harness.load_spec("gru256_fp32.nlink4096.graphed", root)


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.SpecError, match="no workload"):
        harness.load_spec("no_such.cell")


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [w["traffic"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_departure_from_the_source_is_listed(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert set(data.get("departures", {})) == set(entry["reduced"])
