"""The ``minalign > 0`` verify replay of the PyTorch port (core/align.py,
io/fastx.py's genome loaders, engine/verify.py, and the legacy engine's
``detail`` mode under engine/pipeline.py's SampleProcessor) on the CPU,
against the JAX package on CPU JAX.

* ``banded_align_score`` equals the JAX package's and a cell-by-cell oracle
  of the banded affine-gap recurrence (tests/test_verify.py);
* the genome loaders and ``GenomeCache`` equal the JAX package's;
* every end-to-end case of tests/test_verify.py — genuine reads on both
  strands, quality-trimmed reads within and beyond the band, chimeric
  reads, the live ``gcount < minalign`` trigger in both read orders — runs
  through the port's SampleProcessor at ``minalign`` 0 and > 0, and gives
  the JAX package's gcount, ucount, read count and saved reads exactly,
  and the behaviour that file asserts.

The world: two genomes on disk (two accessions, two targets), probes every
37 bases of each with their true positions and strands.
"""

import gzip
import io

import numpy as np
import pytest

from kmer_id_tpu.config import ClassifyConfig as JaxClassifyConfig
from kmer_id_tpu.core import codec
from kmer_id_tpu.core.align import banded_align_score as jax_align
from kmer_id_tpu.core.taxonomy import Taxonomy as JaxTaxonomy
from kmer_id_tpu.db.probes import pack_probes as jax_pack_probes
from kmer_id_tpu.engine import pipeline as JP
from kmer_id_tpu.engine.verify import GenomeCache as JaxGenomeCache
from kmer_id_tpu.io import fastx as jax_fastx
from kmer_id_tpu_torch.config import ClassifyConfig
from kmer_id_tpu_torch.core.align import BEAM, banded_align_score
from kmer_id_tpu_torch.core.taxonomy import Taxonomy
from kmer_id_tpu_torch.db.probes import ProbeRecords, pack_probes
from kmer_id_tpu_torch.engine import pipeline as P
from kmer_id_tpu_torch.engine.classify import Classifier
from kmer_id_tpu_torch.engine.verify import GenomeCache, revcomp_text
from kmer_id_tpu_torch.io import fastx
from tests.test_verify import _norm, oracle_banded

BASES = "ACGT"
NUM_TARG = 8
TARGETS = (3, 5)  # of accA and accB
EDGES = [(1, 2), (2, 3), (2, 4), (4, 5)]


def _dna(r, n):
    return "".join(BASES[i] for i in r.integers(0, 4, size=n))


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_align_score_matches_jax_and_oracle(seed):
    r = np.random.default_rng(seed)
    for _ in range(30):
        n = int(r.integers(3, 90))
        a = _dna(r, n)
        b = list(a)
        for _ in range(int(r.integers(0, 5))):
            b[int(r.integers(len(b)))] = BASES[int(r.integers(4))]
        if r.random() < 0.5 and len(b) > 10:
            p = int(r.integers(1, len(b) - 1))
            b.insert(p, "G") if r.random() < 0.5 else b.pop(p)
        b = "".join(b) if r.random() < 0.8 else _dna(r, max(1, n + int(r.integers(-12, 13))))
        for x, y in ((a, b), (b, a)):
            got = banded_align_score(x, y)
            assert got == jax_align(x, y)
            assert _norm(got) == _norm(oracle_banded(x, y))
    assert banded_align_score("", "ACGT") == 0
    s = _dna(r, 80)
    assert banded_align_score(s, s[: 80 - BEAM - 5]) < -(10**6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two genomes on disk, wrapped at 80 columns (the second with a second
    contig, lower-case bases and U), and probes every 37 bases of each:
    position = the last base's index in the N-joined genome, fstrand = the
    forward key is the canonical one (kmer_build_vf6.cpp:625)."""
    r = np.random.default_rng(29)
    fadir = tmp_path_factory.mktemp("fadir")
    seqs = {"accA": _dna(r, 900), "accB": _dna(r, 700)}
    joined = {}
    for acc, g in seqs.items():
        with gzip.open(fadir / f"{acc}.fasta.gz", "wt") as f:
            f.write(">contig1\n")
            for s in range(0, len(g), 80):
                f.write(g[s : s + 80] + "\n")
            if acc == "accB":
                f.write(">contig2\nacgtuACGU\n")
        joined[acc] = "N" + g + ("NACGTTACGT" if acc == "accB" else "")
    keys, poss, fstr, orgs, tgts = [], [], [], [], []
    for org, (acc, g) in enumerate(seqs.items()):
        for last in range(codec.KSIZE, len(g), 37):
            fwd, _ = codec.forward_kmers(codec.encode_bases(g[last - codec.KSIZE + 1 : last + 1]))
            fkey = int(fwd[0])
            ckey = min(fkey, codec.revcomp_key(fkey))
            keys.append(ckey)
            poss.append(1 + last)
            fstr.append(ckey == fkey)
            orgs.append(org)
            tgts.append(TARGETS[org])
    records = ProbeRecords(keys=np.array(keys, np.uint64), target=np.array(tgts, np.int32),
                           org=np.array(orgs, np.int32), position=np.array(poss, np.int32),
                           fstrand=np.array(fstr, bool), count=np.ones(len(keys), np.int32))
    return dict(fadir=str(fadir), seqs=seqs, joined=joined, records=records, r=r,
                packed=pack_probes(records, num_targ=NUM_TARG),
                jpk=jax_pack_probes(records, num_targ=NUM_TARG))


def test_genome_loaders_match_jax(world, tmp_path):
    for acc in ("accA", "accB"):
        path = f"{world['fadir']}/{acc}.fasta.gz"
        for u in (False, True):
            got = fastx.load_genome_gz(path, u_is_t=u)
            assert got == jax_fastx.load_genome_gz(path, u_is_t=u)
        assert fastx.load_genome_gz(path, u_is_t=True) == world["joined"][acc]
    txt = tmp_path / "contigs.txt"
    txt.write_text(">a\nAC GT\nx\nacgu\n\n>b\nNNRY\n")
    for u in (False, True):
        assert fastx.load_genome_contigs(str(txt), u) == jax_fastx.load_genome_contigs(str(txt), u)
    gc = GenomeCache(world["fadir"], ["accA", "missing"], max_cached=1)
    jgc = JaxGenomeCache(world["fadir"], ["accA", "missing"], max_cached=1)
    assert gc.get(0) == jgc.get(0) == "N" + world["seqs"]["accA"]
    assert gc.get(1) == jgc.get(1) == ""
    assert list(gc._cache) == [1]  # capped: the first genome was dropped
    assert revcomp_text("ACGTNx") == "NNACGT"


def _run(world, records, minalign, port: bool, engine="legacy"):
    """(gcount, ucount, reads, saved reads) of one sample through one
    package's SampleProcessor."""
    kw = dict(num_targ=NUM_TARG, batch_size=16, max_len=192, minalign=minalign,
              fadir=world["fadir"], accessions=["accA", "accB"], engine=engine)
    out = io.StringIO()
    if port:
        db = P.LoadedDB(world["packed"], Taxonomy.from_edges(EDGES, num_nodes=NUM_TARG), None,
                        NUM_TARG, len(world["packed"]))
        cfg = ClassifyConfig.preset("vf6", **kw)
        clf = P.make_classifier(db, cfg, device="cpu")
        sp = P.SampleProcessor(clf, cfg, reads_out=out)
    else:
        db = JP.LoadedDB(world["jpk"], JaxTaxonomy.from_edges(EDGES, num_nodes=NUM_TARG), None,
                         NUM_TARG, len(world["jpk"]))
        cfg = JaxClassifyConfig.preset("vf6", **kw)
        clf = JP.make_classifier(db, cfg)
        sp = JP.SampleProcessor(clf, cfg, reads_out=out)
    if minalign > 0 or engine == "legacy":
        assert type(clf).__name__ == "Classifier"
    if minalign > 0:
        assert not sp.native  # the replay forces the Python feed
    sp.feed(records)
    res = sp.finish()
    return res.gcount.tolist(), res.ucount.tolist(), res.reads, out.getvalue()


def _both(world, records, minalign):
    """The port's run, after checking it equals the JAX package's."""
    got = _run(world, records, minalign, True)
    assert got == _run(world, records, minalign, False), minalign
    return got


def _genome_read(world, r, n=150, acc=None):
    acc = acc or ("accA", "accB")[int(r.integers(2))]
    g = world["seqs"][acc]
    s = int(r.integers(0, len(g) - n))
    return g[s : s + n]


def test_genuine_reads_pass_gate(world):
    """Reads from either genome on both strands verify: the gated counts
    equal the ungated ones."""
    r = np.random.default_rng(1)
    records = []
    for i in range(24):
        seq = _genome_read(world, r)
        if i % 3 == 2:
            seq = revcomp_text(seq)
        records.append((f"g{i}", seq, "J" * 150))
    base = _both(world, records, 0)
    gated = _both(world, records, 100)
    assert base[0][3] > 0 and base[0][5] > 0
    assert gated[:3] == base[:3] and gated[3] == base[3] != ""
    # the legacy and fingerprint engines agree where no alignment runs
    assert _run(world, records, 0, True, engine="fp") == base


def test_trimmed_genuine_reads_pass_gate(world):
    """A 5-base low-quality head (within the band) still verifies; a
    20-base one (beyond it) is rejected, as the reference's untrimmed k-mer
    coordinate makes it (newkmer_10nx.cpp:532,543)."""
    r = np.random.default_rng(2)
    small, big = [], []
    for i in range(10):
        g = _genome_read(world, r, 150)
        small.append((f"s{i}", _dna(r, 5) + g, "#" * 5 + "J" * 150))
        big.append((f"b{i}", _dna(r, 20) + g, "#" * 20 + "J" * 150))
    base = _both(world, small, 0)
    gated = _both(world, small, 100)
    assert sum(base[0][2:]) > 0 and gated[:2] == base[:2]
    gated_big = _both(world, big, 100)
    assert sum(gated_big[0][2:]) == 0 and gated_big[0][0] == 10


def test_chimeric_reads_rejected(world):
    """A probe 30-mer planted in foreign sequence hits the DB and fails the
    alignment: ungated reads are classified, gated ones are not, and their
    k-mers do not count in ucount."""
    r = np.random.default_rng(3)
    kstr = codec.key_to_string(int(world["packed"].keys[0]))
    records = [(f"c{i}", _dna(r, 60) + kstr + _dna(r, 60), "J" * 150) for i in range(6)]
    base = _both(world, records, 0)
    gated = _both(world, records, 100)
    t = int(world["packed"].target[0])
    assert base[0][t] == 6 and gated[0][t] == 0 and gated[0][0] == 6
    assert gated[1][t] == 0 and base[1][t] == 1


def test_gate_stops_after_minalign(world):
    """Once gcount[target] reaches minalign, later reads are not aligned: a
    chimera after enough genuine reads is accepted, one before them is
    rejected (the live trigger, newkmer_10nx.cpp:530)."""
    g = world["seqs"]["accA"]
    genuine = [(f"g{i}", g[37 * i : 37 * i + 150], "J" * 150) for i in range(3)]
    kstr = codec.key_to_string(int(world["packed"].keys[np.nonzero(
        world["packed"].target == TARGETS[0])[0][0]]))
    chimera = [("c0", _dna(np.random.default_rng(4), 60) + kstr
                + _dna(np.random.default_rng(5), 60), "J" * 150)]
    res = _both(world, genuine + chimera, 2)
    assert res[0][TARGETS[0]] == 4
    res2 = _both(world, chimera + genuine, 2)
    assert res2[0][TARGETS[0]] == 3 and res2[0][0] == 1


def test_long_reads_are_not_replayed(world):
    """A read longer than max_len takes the legacy engine's long-read path
    unverified.  The port accounts it in read order; the JAX package
    accounts it on its collector thread while the calling thread replays
    the next batch, so only its counts, not its saved-read order, are
    compared here."""
    r = np.random.default_rng(6)
    g = world["seqs"]["accA"]
    records = [("long", g[:400], None), ("g0", _genome_read(world, r, acc="accB"), "J" * 150),
               ("chim", _dna(r, 100) + g[112:142] + _dna(r, 150), None)]  # a probe
    got = _run(world, records, 100, True)
    want = _run(world, records, 100, False)
    assert got[:3] == want[:3]
    assert sorted(got[3].splitlines()) == sorted(want[3].splitlines())
    assert [line for line in got[3].splitlines() if line[0] == ">"] == [
        f">{TARGETS[0]}:long", f">{TARGETS[1]}:g0", f">{TARGETS[0]}:chim"]


def test_verify_needs_the_legacy_engine_api(world):
    """make_classifier gives the legacy engine under minalign > 0 even when
    the fingerprint engine is asked for."""
    db = P.LoadedDB(world["packed"], Taxonomy.from_edges(EDGES, num_nodes=NUM_TARG), None,
                    NUM_TARG, len(world["packed"]))
    cfg = ClassifyConfig.preset("vf6", num_targ=NUM_TARG, minalign=5, engine="fp")
    assert isinstance(P.make_classifier(db, cfg, device="cpu"), Classifier)
