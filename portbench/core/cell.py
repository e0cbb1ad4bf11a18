"""A cell of BENCHMARK.json and the files it is made of, found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = "portbench"


def load_module(path: Path):
    """A Python file of the benchmark (a metric's reader, a kernel's
    counts), loaded by its path: its name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_file_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Cell:
    def __init__(self, root: Path, manifest: dict, name: str):
        self.root = root
        self.bench = root / BENCH_DIR
        self.scratch = root / "build" / "portbench"
        self.name = name
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(it has {sorted(cells)})")
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads(
            (root / configs[self.workload["config"]]["file"]).read_text())
        self.traffic = json.loads((self.bench / "traffic" /
                                   f"{self.workload['traffic']}.json"
                                   ).read_text())
        check = self.bench / "checks" / f"{name}.json"
        self.check = (json.loads(check.read_text()) if check.exists()
                      else {"limits": {}, "controls": []})
        self.limits = self.check["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if _applies(m, name)]

    @classmethod
    def load(cls, root: Path, name: str) -> "Cell":
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        return cls(root, manifest, name)
