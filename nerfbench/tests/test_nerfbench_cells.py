"""BENCHMARK.json against the contract's shape rules, every cell resolved to
its files, and a cell and a metric added as new files only."""

import json
import re
import shutil

import pytest

from nerfbench.core import spec

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert BENCH["command"] == ["python3", "nerfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nerfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    all_names = names + CELLS + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in all_names)
    assert len(set(all_names)) == len(all_names)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.workload["traffic"] == cell.entry["traffic"]
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert callable(spec.reader(m["name"]).read)
    assert callable(spec.driver(cell).run)
    assert set(cell.workload["limits"]) and all(
        v >= 0 for v in cell.workload["limits"].values())


def test_added_cell_and_metric_are_found(tmp_path):
    """A cell, its traffic file, a driver and a per-layer metric added as new
    files plus entries in BENCHMARK.json: found by name, with no file of
    the harness edited."""
    shutil.copytree(ROOT / "nerfbench", tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-cell", "config":
                               BENCH["configs"][0]["name"],
                               "traffic": "dummy-traffic", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy_metric.serve", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = tmp_path / "nerfbench"
    (pkg / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"traffic": "dummy-traffic", "driver": "dummy", "params": {},
         "limits": {"x": 0.0}}))
    (pkg / "drivers" / "dummy.py").write_text(
        "def run(cell, seed, seconds, trace, t_start):\n    return seed\n")
    (pkg / "metrics" / "dummy_metric.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    cell = spec.load_cell("dummy-cell", root=tmp_path, pkg=pkg)
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric.serve"]
    assert spec.driver(cell, pkg=pkg).run(cell, 7, 1, 0, 0) == 7
    assert spec.reader("dummy_metric.serve", pkg=pkg).read(None) == 42.0
    assert {e["name"] for e in cell.end_to_end} == {"setup_s"}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_config_files_state_the_preset():
    """Each configuration file holds the port's preset as run, with the
    sizes the reference reads beside it."""
    import dataclasses

    from cednerf_torch.engine.config import dnerf_config

    preset = json.loads(json.dumps(dataclasses.asdict(dnerf_config())))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["scene"] == preset
        assert cfg["reduced"] == c["reduced"] == []
        enc = cfg["field"]["encoder"]
        assert enc["n_levels"] == preset["hash_n_levels"]
        assert enc["max_res"] == preset["hash_dst_resolution"]
        assert enc["log2_hashmap_size"] == preset["log2_hashmap_size"]


def test_paths_hold_only_the_benchmark():
    for path in (ROOT / "nerfbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel
