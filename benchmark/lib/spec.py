"""A cell of `BENCHMARK.json`, found by its workload name: its
configuration file, its architecture module, its traffic file, its limits
and its metrics."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell:
    def __init__(self, workload: str, bench: dict | None = None):
        bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = cells[workload]
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config_file = ROOT / conf["file"]
        arch_file(self.config())    # a MODEL.NAME without an architecture module fails here
        self.traffic_name = self.entry["traffic"]
        self.end_to_end = [m for m in bench["end_to_end"] if self.name in m.get("workloads",
                                                                                  [self.name])]
        self.per_layer = [m for m in bench["per_layer"] if self.name in m.get("workloads",
                                                                                [self.name])]
        self.limits_file = BENCH_DIR / "limits" / f"{workload}.json"

    def config(self) -> dict:
        return load_config(self.config_file)

    def traffic(self) -> dict:
        return json.loads((BENCH_DIR / "traffic" / f"{self.traffic_name}.json").read_text())

    def limits(self) -> dict:
        return {k: float(v["limit"]) for k, v in json.loads(self.limits_file.read_text()).items()}


def load_config(path) -> dict:
    """The configuration as run: the file without its `source` and `assumed` notes."""
    cfg = json.loads(Path(path).read_text())
    return {k: v for k, v in cfg.items() if k not in ("source", "assumed")}


def arch_file(cfg: dict) -> Path:
    """`arch/<MODEL.NAME lower-cased>.py`: what the harness knows of the
    configuration's network. Raises FileNotFoundError naming the path when
    there is none."""
    name = cfg["MODEL"]["NAME"]
    path = BENCH_DIR / "arch" / f"{name.lower()}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no architecture module {path} for MODEL.NAME {name!r}")
    return path


def arch_module(cfg: dict):
    """The architecture module of configuration `cfg`, loaded from its file
    once a process (as `benchmark.arch.<name>`)."""
    path = arch_file(cfg)
    name = f"benchmark.arch.{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def metric_reader(name: str):
    """The `read` function of `metrics/<name>.py`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
