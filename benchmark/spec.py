"""Finding a cell's files by name: ``BENCHMARK.json``, the cell, its
configuration, its block family, its traffic mix and the readers of its
metrics."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells, one without it in every cell
    that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


class Cell:
    """Everything one cell's run reads, resolved by name under ``root``
    (a checkout: ``BENCHMARK.json`` and this folder)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / HERE.name
        self.bench = benchmark(self.root)
        self.name = name
        self.entry = workload(self.bench, name)
        self.settings = load_json(self.dir / "cells" / f"{name}.json")
        config = config_entry(self.bench, self.entry["config"])
        self.config = load_json(self.root / config["file"])
        self.family = family(self.config, self.root)
        self.mix = load_json(self.dir / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = load_module(self.dir / "traffic" / f"{self.mix['kind']}.py")
        self.chips = int(self.entry["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        return metrics_for(self.bench, self.name, trace)

    def metric_reader(self, name: str):
        """The ``read(run)`` function of ``metrics/<name>.py``."""
        return load_module(self.dir / "metrics" / f"{name}.py").read


def family(cfg: dict, root: Path = ROOT):
    """The block family of a configuration: ``families/<name>.py`` for its
    ``"family"`` key, ``dense`` without one.  The module gives the port's
    config and train step, the weights, the reference and the work
    counts of that block."""
    name = cfg.get("family", "dense")
    path = Path(root) / HERE.name / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no block family {name!r}: {path} is missing")
    return load_module(path)


def load_module(path: Path):
    """A module from its file; names may hold dots (``mfu.decode.py``)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark._by_path." + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
