"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names
the cells; a cell ``<config>.<mix>`` takes ``benchmark/configs/<config>.json``
(the file its configuration entry names) and ``benchmark/traffic/<mix>.json``,
and each metric is read by ``benchmark/metrics/<metric>.py``'s ``read``
(or that of its name without a last ``.<suffix>``).
Adding a cell, a mix or a metric adds files and entries; no file here
changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the mix's file
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def preset(self) -> dict:
        return self.config["presets"][self.driver]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json ({', '.join(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """``read(record)`` of ``benchmark/metrics/<metric>.py``; where there is
    no such file, of the metric's name without its last ``.<suffix>``
    (``device_idle_pct.contigs`` reads as ``device_idle_pct``: one quantity
    split by the end-to-end metric it moves)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        return reader(metric.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location("kbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
