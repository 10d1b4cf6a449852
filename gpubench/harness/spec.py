"""The benchmark's data: BENCHMARK.json at the checkout's root, and the
files it names by name.

  configs:   the "file" of each entry of "configs" (JSON);
  traffic:   gpubench/traffic/<traffic>.json;
  entries:   gpubench/entries/<entry>.py, the driver of a traffic file's
             "entry" (its class Driver, cells.py);
  metrics:   gpubench/metrics/<name>.py, a module with read(readings)
             that returns the metric's value or None.

A later cell, mix or metric is a new entry and a new file; nothing here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               f"{name}.json")) as f:
            return json.load(f)

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def _module(self, folder: str, name: str):
        path = os.path.join(self.bench_dir, folder, f"{name}.py")
        mod_spec = importlib.util.spec_from_file_location(
            f"gpubench_{folder}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod

    def driver(self, entry: str):
        return self._module("entries", entry).Driver

    def reader(self, metric: str):
        return self._module("metrics", metric).read
