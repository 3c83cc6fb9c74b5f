"""The seeded generator: the same seed gives the same DB and the same file
bytes, every seed the same work, and the port's parsers read back the
records the reference is given."""

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark.gen.db import make_db
from benchmark.gen.dna import key_chars, revcomp
from benchmark.gen.samples import make_pool, write_pool
from benchmark.spec import HERE
from benchmark.tests.toy import PROBES

MIXES = ("deep", "reads", "contigs", "shallow")


def traffic(mix: str) -> dict:
    with open(os.path.join(HERE, "traffic", mix + ".json")) as f:
        t = json.load(f)
    t["pool"] = 2
    if "reads_per_file" in t:
        t["reads_per_file"] = 700
    else:
        t["bases_per_file"] = 200_000
    return t


def test_revcomp_matches_base_by_base():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 60, size=500, dtype=np.uint64)
    letters = key_chars(keys)
    comp = {ord("A"): ord("T"), ord("C"): ord("G"), ord("G"): ord("C"), ord("T"): ord("A")}
    want = np.array([[comp[c] for c in row[::-1]] for row in letters], np.uint8)
    assert np.array_equal(key_chars(revcomp(keys)), want)
    assert np.array_equal(revcomp(revcomp(keys)), keys)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5])
def test_db_same_seed_same_arrays(seed):
    a, b = make_db(seed, PROBES, 300), make_db(seed, PROBES, 300)
    for x, y in ((a.keys, b.keys), (a.targets, b.targets), (a.parent, b.parent)):
        assert np.array_equal(x, y)
    assert len(a.keys) == PROBES and (np.diff(a.keys.astype(np.float64)) > 0).all()
    assert np.array_equal(a.keys, np.minimum(a.keys, revcomp(a.keys)))
    assert a.targets.min() >= 2 and a.targets.max() < 300
    assert (a.parent[3:] < np.arange(3, 300)).all() and (a.parent[3:] >= 1).all()
    assert not np.array_equal(a.keys, make_db(seed + 1, PROBES, 300).keys)


def _digests(seed, mix, tmp_path):
    db = make_db(seed, PROBES, 300)
    pool = make_pool(seed, traffic(mix), db)
    d = tmp_path / f"{mix}-{seed}-{len(list(tmp_path.iterdir()))}"
    write_pool(pool, str(d), traffic(mix)["driver"])
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(d.iterdir())}, pool


@pytest.mark.parametrize("mix", MIXES)
def test_pool_same_seed_same_bytes(mix, tmp_path):
    a, pa = _digests(7, mix, tmp_path)
    b, _ = _digests(7, mix, tmp_path)
    c, pc = _digests(8, mix, tmp_path)
    assert a == b and len(a) == 2 * traffic(mix)["files"]
    assert a != c
    # another seed: the same lengths, in another order
    for ra, rc in zip(pa, pc):
        for fa, fc in zip(ra.files, rc.files):
            assert np.array_equal(np.sort(np.diff(fa.off)), np.sort(np.diff(fc.off)))


@pytest.mark.parametrize("mix", MIXES)
def test_port_parsers_read_the_generated_records(mix, tmp_path):
    from kmer_id_tpu_torch.io.fastx import iter_fasta_plain, iter_fastq_gz

    _, pool = _digests(3, mix, tmp_path)
    for req in pool:
        for f in req.files:
            it = iter_fastq_gz(f.path) if f.fmt == "fastq_gz" else iter_fasta_plain(f.path)
            got = list(it)
            assert len(got) == f.n
            for i in (0, f.n // 2, f.n - 1):
                seq = f.seq[f.off[i] : f.off[i + 1]].tobytes().decode()
                qual = None if f.qual is None else f.qual[f.off[i] : f.off[i + 1]].tobytes().decode()
                assert got[i] == (f.acc(i), seq, qual)
