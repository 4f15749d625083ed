"""Finds, by the names in ``BENCHMARK.json``, the files of a cell: its
workload file, its configuration, the configuration's Hamiltonian, entry
and reference modules, the metric readers and the kernels' cost modules."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str | None = None):
    """Imports a file by its path (metric files carry dots in their names)."""
    name = name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration and data files."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = ROOT):
        bench = bench or benchmark(root)
        path = HERE / "workloads" / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no workload file for {name!r}")
        with open(path) as f:
            self.spec = json.load(f)
        # a cell that BENCHMARK.json does not list yet (one held out, or one
        # being proven) runs from its own file and its configuration's
        entry = {"name": name, "config": self.spec["config"], "traffic": self.spec["traffic"],
                 "chips": 1}
        self.name = name
        self.entry = {w["name"]: w for w in bench["workloads"]}.get(name, entry)
        self.bench = bench
        files = {c["name"]: c["file"] for c in bench["configs"]}
        cfg = files.get(self.entry["config"], f"perfbench/configs/{self.entry['config']}.json")
        with open(root / cfg) as f:
            self.config = json.load(f)
        self.chips = int(self.entry["chips"])

    def module(self, kind: str):
        """The configuration's module of one kind: "hamiltonians",
        "entries" or "references"."""
        key = {"hamiltonians": "hamiltonian", "entries": "entry", "references": "reference"}[kind]
        return load_module(HERE / kind / f"{self.config[key]}.py")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in e2e else [])]


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py")


def cost_modules() -> dict:
    """Every kernel with a cost module under ``costs/`` (those naming PATCH)."""
    out = {}
    for path in sorted((HERE / "costs").glob("*.py")):
        mod = importlib.import_module(f"costs.{path.stem}")
        if hasattr(mod, "PATCH"):
            out[path.stem] = mod
    return out
