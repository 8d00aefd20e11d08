"""The harness finds every cell's configuration, mix and metric readers by
name, and BENCHMARK.json keeps to the characters and shapes its readers
allow."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import run as R

HERE = Path(__file__).resolve().parent.parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
END_TO_END = {"proofs_per_s", "call_p95_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    spec = R.load_cell(cell)
    assert spec["config"]["protocol"] in ("ml", "gkr")
    assert spec["mix"]["batch"] >= 1
    assert {m["name"] for m in spec["end_to_end"]} <= END_TO_END
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        reader = R.load_reader(m["name"])
        assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
        assert callable(reader.read)


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        path = HERE.parent / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        assert json.loads(path.read_text())["reduced"] == c["reduced"]


def test_names_units_and_shapes():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {m["name"]: m["layer"] for m in b["per_layer"]}
    assert all(1 <= len(v) <= 200 and "\n" not in v for v in layers.values())
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        # every cell the metric lists reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _imports(path: Path) -> set[str]:
    """Top-level names of every module `path` imports (relative imports
    excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "sumcheck_tpu"}
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        found = _imports(path) & {"sumcheck_tpu_torch", "portbench"}
        assert not found, (path, found)
        tree = ast.parse(path.read_text())
        assert all(n.level <= 1 for n in ast.walk(tree) if isinstance(n, ast.ImportFrom))
