"""Toy sizes of the cells for the CPU tests."""

import json
import os

from benchmark import spec

PROBES = 20_000

# mixes kept for a later cell, with no entry in BENCHMARK.json yet: still
# generated, served and checked here, as one chip would
KEPT = {"bact10.contigs": ("bact10", "contigs")}


def overrides(cell: str, **traffic) -> dict:
    tr = {"pool": 2}
    if cell == "bact10.contigs":
        tr["bases_per_file"] = 300_000
    else:
        tr["reads_per_file"] = 1_200
    tr.update(traffic)
    return {"config": {"probes": PROBES}, "traffic": tr}


def cell(name: str) -> spec.Cell:
    """The cell at toy size: from BENCHMARK.json, or for a kept mix from
    its configuration's and traffic's files (no metrics)."""
    if name in KEPT:
        config, mix = KEPT[name]
        with open(os.path.join(spec.HERE, "configs", config + ".json")) as f:
            conf = json.load(f)
        with open(os.path.join(spec.HERE, "traffic", mix + ".json")) as f:
            traffic = json.load(f)
        c = spec.Cell(name, 1, conf, traffic, [], [])
    else:
        c = spec.load_cell(name)
    for part, values in overrides(name).items():
        getattr(c, part).update(values)
    return c


CELLS = ("bact10.deep", "mito.reads", "bact10.contigs")
