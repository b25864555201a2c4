"""Everything a cell is made of, found by name: the cell in BENCHMARK.json,
its configuration in configs/<config>.json, its traffic in
traffic/<traffic>.json, its guest in programs/<guest>.py with the
reference's outputs in reference/<guest>.py, and one reader a metric in
metrics/<metric>.py. Adding a cell, a configuration, a traffic mix, a guest
or a metric adds files; no file here names one.

A metric's reader declares

    UNIT, LAYER, MOVES       as BENCHMARK.json has them (LAYER and MOVES may be
                             None for an end-to-end metric)
    WRAPS                    [(span name, "module:Qualified.name"), ...], the port's
                             functions the traced run times (spans.py); may be empty
    read(run) -> float | None   None where the run has nothing to read
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(path: str, kind: str, name: str):
    """The Python file at `path` as the module zkbench.<kind>.<name>, so that
    its relative imports resolve inside this package, whatever directory
    holds the file."""
    mod_name = f"zkbench.{kind}._{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules and getattr(sys.modules[mod_name], "__file__", None) == path:
        return sys.modules[mod_name]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: str = HERE

    def guest_args(self) -> dict:
        return {**self.config.get("guest_args", {}), **self.traffic.get("guest_args", {})}

    def guest(self):
        return load_module(os.path.join(self.root, "programs", self.config["guest"] + ".py"),
                           "programs", self.config["guest"])

    def expected(self):
        return load_module(os.path.join(self.root, "reference", self.config["guest"] + ".py"),
                           "reference", self.config["guest"])

    def reader(self, metric: str):
        return load_module(os.path.join(self.root, "metrics", metric + ".py"), "metrics", metric)


@dataclass
class Bench:
    path: str = os.path.join(CHECKOUT, "BENCHMARK.json")
    root: str = HERE
    spec: dict = field(init=False)

    def __post_init__(self):
        with open(self.path) as f:
            self.spec = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        if not _NAME.match(name):
            raise ValueError(f"bad {kind} name {name!r}")
        with open(os.path.join(self.root, kind, name + ".json")) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in {self.path}")
        w = found[0]
        e2e = [m for m in self.spec["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        layer = [m for m in self.spec["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
        return Cell(name, int(w["chips"]), self._json("configs", w["config"]),
                    self._json("traffic", w["traffic"]), e2e, layer, self.root)
