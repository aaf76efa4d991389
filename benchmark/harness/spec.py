"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic mix and metrics. The files behind them are found by those names
alone, so a later cell, configuration or metric is added as files and
entries, never by editing this package:

* a configuration: the JSON file its ``file`` entry names; its ``entry``
  key names the module ``entries/<entry>.py`` that sets up and drives the
  program's entry point for it;
* a traffic mix: ``traffic/<traffic>.json``, data whose ``generator``
  names ``generators/<generator>.py`` and whose ``schedule`` (default
  ``closed``) names ``schedules/<schedule>.py``;
* a per-layer metric ``<base>.<cell suffix>``: the reader
  ``layers/<base>.py``, whose ``read(trace)`` returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at `path` as a module called `name`."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names loaded, from
    the benchmark folder ``<root>/benchmark``."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {', '.join(sorted(cells))})")
        self.name = name
        self.dir = os.path.join(root, "benchmark")
        self.cell = cells[name]
        self.chips = int(self.cell["chips"])
        cfg = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = load_json(os.path.join(
            self.dir, "traffic", self.cell["traffic"] + ".json"))
        self.generator = load_module(
            os.path.join(self.dir, "generators",
                         self.traffic["generator"] + ".py"),
            "bench_generator_" + self.traffic["generator"])
        schedule = self.traffic.get("schedule", "closed")
        self.schedule = load_module(
            os.path.join(self.dir, "schedules", schedule + ".py"),
            "bench_schedule_" + schedule)
        self.entry = load_module(
            os.path.join(self.dir, "entries", self.config["entry"] + ".py"),
            "bench_entry_" + self.config["entry"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in moved]

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's reader."""
        base = metric.split(".")[0]
        return load_module(os.path.join(self.dir, "layers", base + ".py"),
                           "bench_layer_" + base).read


def load(name: str, root: str = ROOT) -> Cell:
    return Cell(load_json(os.path.join(root, "BENCHMARK.json")), name, root)
