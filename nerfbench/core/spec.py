"""Finding a cell's pieces by name.

`BENCHMARK.json` names the cells, configurations and metrics. Each cell's
pieces are files of their own, found by name:

  * nerfbench/workloads/<cell>.json     its traffic: driver, parameters,
                                        the limits of its comparison
  * the configuration's `file`          sizes, flags and precision
  * nerfbench/drivers/<driver>.py       the code that runs the cell
  * nerfbench/metrics/<metric>.py       one reader per per-layer metric

Adding a cell, a configuration or a metric adds files and entries; no file
here changes.
"""

import dataclasses
import importlib.util
import json
import pathlib
import sys

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    entry: dict           # the cell's entry in BENCHMARK.json
    workload: dict        # nerfbench/workloads/<cell>.json
    config: dict          # the configuration's file
    end_to_end: list      # metric entries that this cell reports
    per_layer: list


def load_benchmark(root=ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root=ROOT, pkg=PKG) -> Cell:
    """The cell `name` of BENCHMARK.json with its workload and configuration
    files read; raises KeyError for a name the benchmark does not have and
    FileNotFoundError for a missing file."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(pathlib.Path(pkg) / "workloads" / f"{name}.json") as fh:
        workload = json.load(fh)
    with open(pathlib.Path(root) / conf["file"]) as fh:
        config = json.load(fh)
    return Cell(name=name, chips=int(entry["chips"]), entry=entry,
                workload=workload, config=config,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_module(path: pathlib.Path, label: str):
    """Import the file at `path` as a module named `label`."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod
    spec.loader.exec_module(mod)
    return mod


def _label(kind: str, name: str) -> str:
    return "nerfbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


def driver(cell: Cell, pkg=PKG):
    """The module nerfbench/drivers/<driver>.py of the cell's workload."""
    name = cell.workload["driver"]
    return load_module(pathlib.Path(pkg) / "drivers" / f"{name}.py",
                       _label("driver", name))


def reader(metric: str, pkg=PKG):
    """The module nerfbench/metrics/<metric>.py: its read(ctx) gives the
    metric's value, or None where it finds nothing to read."""
    return load_module(pathlib.Path(pkg) / "metrics" / f"{metric}.py",
                       _label("metric", metric))
