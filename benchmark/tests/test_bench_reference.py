"""The reference: the whole-sample form equals the read-by-read model, and
the port's files equal the reference on the CPU for each traffic kind."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.gen.db import make_db
from benchmark.gen.samples import make_pool
from benchmark.reference import scalar
from benchmark.reference.vector import Probes, Tree, classify, trim
from benchmark.spec import HERE
from benchmark.tests import toy
from benchmark.tests.toy import CELLS, PROBES


@pytest.mark.parametrize("profile", ["uniform", "binary", "low"])
def test_trim_equals_scalar(profile):
    rng = np.random.default_rng(len(profile))
    for _ in range(40):
        lens = rng.integers(31, 90, size=60)
        off = np.concatenate([[0], np.cumsum(lens)])
        n = int(off[-1])
        if profile == "uniform":
            q = rng.integers(33, 75, size=n)
        elif profile == "binary":
            q = np.where(rng.random(n) < 0.7, 74, 35)
        else:
            q = np.where(rng.random(n) < 0.3, 60, rng.integers(33, 50, size=n))
        q = q.astype(np.uint8)
        start, stop, keep = trim(torch.from_numpy(q), torch.from_numpy(off))
        for i in range(len(lens)):
            want = scalar.trim(q[off[i] : off[i + 1]].tobytes().decode())
            assert (int(start[i]), int(stop[i]), bool(keep[i])) == want


def test_msca_equals_scalar():
    db = make_db(4, 1000, 400)
    tree = Tree(db.parent)
    rng = np.random.default_rng(1)
    x, y = rng.integers(1, 400, size=(2, 3000))
    y[:100] = x[:100]
    got = tree.msca(x, y)
    parent = db.parent.tolist()
    assert got.tolist() == [scalar.msca(parent, int(a), int(b)) for a, b in zip(x, y)]


@pytest.mark.parametrize("mix,u_is_t", [("deep", False), ("reads", True), ("contigs", True),
                                        ("shallow", False)])
def test_vector_equals_scalar(mix, u_is_t):
    with open(os.path.join(HERE, "traffic", mix + ".json")) as f:
        t = json.load(f)
    t.update(pool=1, **({"reads_per_file": 900} if "reads_per_file" in t
                        else {"bases_per_file": 300_000, "plant_every": 700}))
    db = make_db(9, PROBES, 300)
    (req,) = make_pool(9, t, db)
    got = classify(req.files, Probes(db.keys, db.targets), Tree(db.parent), 300, u_is_t)
    sim = scalar.Sample(dict(zip(db.keys.tolist(), db.targets.tolist())), db.parent.tolist(),
                        300, u_is_t)
    for f in req.files:
        sim.feed((f.acc(i), f.seq[f.off[i] : f.off[i + 1]].tobytes().decode(),
                  None if f.qual is None else f.qual[f.off[i] : f.off[i + 1]].tobytes().decode())
                 for i in range(f.n))
    assert sum(sim.gcount[2:]) > 0 and sim.saved
    assert got.result == sim.result_lines()
    assert got.reads == sim.reads_text()


@pytest.mark.parametrize("name", CELLS)
def test_port_files_equal_reference_on_cpu(name):
    import time

    from benchmark import cell

    c = toy.cell(name)
    rec, _, (numbers, failed, attempted) = cell.run(c, 12345, 0.3, False, "cpu",
                                                    time.perf_counter())
    assert attempted == len(rec.served) >= 1
    assert failed == 0 and set(numbers.values()) == {0}
