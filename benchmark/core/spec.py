"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix. The configuration is
``benchmark/configs/<config>.json``; the mix is
``benchmark/traffic/<traffic>.json``, which names its generator
(``benchmark/gen/<generator>.py``) and its driver
(``benchmark/drivers/<driver>.py``); the limits of a cell's ``correct``
are ``benchmark/limits/<workload>.json``; a per-layer metric is read by
``benchmark/metrics/<metric>.py``. Adding any of them is adding files
and entries: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_spec(path: Path = SPEC_FILE) -> dict:
    return json.loads(Path(path).read_text())


def by_name(entries: list[dict]) -> dict[str, dict]:
    return {e["name"]: e for e in entries}


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (file names
    here may hold dots, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_path(spec: dict, config: str) -> Path:
    return ROOT / by_name(spec["configs"])[config]["file"]


def traffic_path(traffic: str) -> Path:
    return BENCH_DIR / "traffic" / f"{traffic}.json"


def generator_path(generator: str) -> Path:
    return BENCH_DIR / "gen" / f"{generator}.py"


def driver_path(driver: str) -> Path:
    return BENCH_DIR / "drivers" / f"{driver}.py"


def limits_path(workload: str) -> Path:
    return BENCH_DIR / "limits" / f"{workload}.json"


def metric_path(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics a cell reports: those whose
    ``workloads`` list it, or that have no such list (a per-layer metric
    without one goes with every cell that reports what it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


class Cell:
    """One workload of the spec with its files read."""

    def __init__(self, name: str, spec: dict | None = None):
        self.spec = spec if spec is not None else load_spec()
        cells = by_name(self.spec["workloads"])
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.config = json.loads(
            config_path(self.spec, self.entry["config"]).read_text())
        self.traffic = json.loads(
            traffic_path(self.entry["traffic"]).read_text())
        self.limits = json.loads(limits_path(name).read_text())
        self.end_to_end, self.per_layer = cell_metrics(self.spec, name)

    def generator(self):
        return load_module(generator_path(self.traffic["generator"]),
                           f"bench_gen_{self.traffic['generator']}")

    def driver(self):
        return load_module(driver_path(self.traffic["driver"]),
                           f"bench_driver_{self.traffic['driver']}")

    def metric_readers(self) -> dict:
        return {m["name"]: load_module(metric_path(m["name"]),
                                       f"bench_metric_{i}")
                for i, m in enumerate(self.per_layer)}
