"""Finds a cell's pieces by name: the cell and its metrics in
`BENCHMARK.json`, its configuration's file, its traffic mix in
`portbench/traffic/<traffic>.json`, and each per-layer metric's reader in
`portbench/metrics/<name>.py`. A configuration, mix or metric is added by
adding its file and its entry; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    root: pathlib.Path = ROOT  # the checkout the files were found in


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell_of(configs[w["config"]]["file"], w["traffic"], root, name,
                   int(w["chips"]))


def cell_of(config_file: str, traffic: str, root: pathlib.Path = ROOT,
            name: "str | None" = None, chips: int = 1) -> Cell:
    """A cell of a configuration file and a traffic mix by their names,
    reporting the metrics `BENCHMARK.json` gives the cell `name` (every
    metric without a `workloads` list when it names no such cell)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = name or f"{pathlib.Path(config_file).stem}.{traffic}"
    config = json.loads((root / config_file).read_text())
    mix = json.loads(
        (root / "portbench" / "traffic" / f"{traffic}.json").read_text())
    return Cell(
        name=name,
        chips=chips,
        config=config,
        traffic=mix,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


def reader(metric: str, root: pathlib.Path = ROOT):
    """The `read(ctx)` function of `portbench/metrics/<metric>.py`."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
