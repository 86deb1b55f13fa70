"""Find a cell's files by name: ``BENCHMARK.json`` at the root of the
checkout names the cell; its configuration is ``configs/<config>.json``,
its traffic ``traffic/<traffic>.json``, the code that builds and steps its
pipeline ``paths/<kind>.py`` (``path_kind``: the kind the configuration
gives for the traffic's frontend), each per-layer metric
``metrics/<name>.py``, each stage's work count ``work/<stage>.py``, its
correctness limits
``limits/<workload>.json``, and the plain reference's channelizer and
demodulator ``reference/chan_<kind>.py`` and ``reference/demod_<name>.py``
(the kinds the path names). A cell, configuration, traffic mix, metric,
pipeline kind, channelizer or demodulator is added by adding files and
entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """Import the Python file ``path`` under a name of its own."""
    name = f"_bench_{prefix}_" + "".join(
        ch if ch.isalnum() else "_" for ch in path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, manifest: dict, workload: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                           f"{sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.cfg = load_json(BENCH / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(
            BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = path_kind(self.cfg, self.traffic["frontend"])
        self.limits = load_json(BENCH / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def path_module(self):
        return load_module(BENCH / "paths" / f"{self.kind}.py", "path")

    def metric_module(self, name: str):
        return load_module(BENCH / "metrics" / f"{name}.py", "metric")

    def work_module(self, stage: str):
        return load_module(BENCH / "work" / f"{stage}.py", "work")


def path_kind(cfg: dict, frontend: str) -> str:
    """The pipeline kind (``paths/<kind>.py``) of a configuration on a
    frontend: the configuration's ``paths`` entry for it, else
    ``<modulation>_<frontend>``, so a frontend's path is added as a file."""
    return cfg.get("paths", {}).get(frontend,
                                    f"{cfg['modulation']}_{frontend}")


def chan_module(kind: str):
    """The plain reference channelizer ``reference/chan_<kind>.py``."""
    return importlib.import_module(f"benchmark.reference.chan_{kind}")


def demod_module(name: str):
    """The plain reference demodulator ``reference/demod_<name>.py``."""
    return importlib.import_module(f"benchmark.reference.demod_{name}")


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")
