"""What ``BENCHMARK.json`` names, found as files by name.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix.  The configuration is the ``file`` its ``configs`` entry
gives, the mix is ``traffic/<traffic>.json`` and a per-layer metric is
read by ``metrics/<name>.py``, all under this benchmark's folder.  A
later change adds a configuration, a mix or a metric as a new file and a
new entry, and edits no file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir else self.root / BENCH_DIR.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Optional[dict]:
        return next((w for w in self.data["workloads"] if w["name"] == name),
                    None)

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"]
                     if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        path = self.bench_dir / "traffic" / f"{cell['traffic']}.json"
        return json.loads(path.read_text())

    def end_to_end(self, cell: dict) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> List[dict]:
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: str) -> ModuleType:
        return load_reader(self.bench_dir / "metrics" / f"{metric}.py")


def load_reader(path: Path) -> ModuleType:
    """A metric reader module, loaded from its file (a metric's name may
    hold dots, which a module name may not)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(spec: Spec, cell: dict, obs: Dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that finds something to read
    in ``obs``; a reader that finds nothing returns None and its metric
    is left out."""
    out = {}
    for m in spec.per_layer(cell):
        value = spec.reader(m["name"]).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
