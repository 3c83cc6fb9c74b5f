"""The port's copies of the JAX package's host modules against their
originals (``kmer_id_tpu_torch/{core,db,io,report}`` vs ``kmer_id_tpu/...``),
on fixtures made with numpy from a seed.  One parametrised test per area:

* ``build_fpdb``: every table, slot map and salt, the Bloom filter, the
  ``tinfo`` rows and the taxonomy's chain tables;
* the packed-DB and ``fpdb`` caches: written by one package, byte-identical
  to the other's, and read back by the other package field for field;
* ``pack_codes``: packed words and exception lists, the overflow case;
* the batches of ``ReadBatcher`` (with the FASTQ/FASTA parsers) and of
  ``NativePlaneFeeder``, long reads included, and the native fill's packed
  words and exception lists against ``pack_codes`` of its own batches;
* the rollup CSV bytes of ``m3_report`` and ``readc_report``.
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest

from kmer_id_tpu.core.taxonomy import Taxonomy as JTaxonomy
from kmer_id_tpu.db import fpdb as JFP
from kmer_id_tpu.db import probes as JPR
from kmer_id_tpu.io import batch as JB
from kmer_id_tpu.io import fastx as JFX
from kmer_id_tpu.io import native_feed as JNF
from kmer_id_tpu.report import rollup as JRU
from kmer_id_tpu_torch.core.taxonomy import Taxonomy as TTaxonomy
from kmer_id_tpu_torch.db import fpdb as TFP
from kmer_id_tpu_torch.db import probes as TPR
from kmer_id_tpu_torch.io import batch as TB
from kmer_id_tpu_torch.io import fastx as TFX
from kmer_id_tpu_torch.io import native_feed as TNF
from kmer_id_tpu_torch.report import rollup as TRU

PKG = {"jax": (JTaxonomy, JFP, JPR), "torch": (TTaxonomy, TFP, TPR)}


def _equal(a, b, what=""):
    """Deep equality of dataclass fields, arrays and plain values."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, what
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    else:
        assert a == b, what


def _db(pkg, seed, n_probes, num_targ):
    """(packed DB, taxonomy, fpdb) of one package from the same seeded
    records and tree."""
    tax_cls, fp, pr = PKG[pkg]
    r = np.random.default_rng(seed)
    raw = np.unique(r.integers(0, 1 << 60, size=n_probes, dtype=np.uint64))
    n = len(raw)
    rec = pr.ProbeRecords(keys=raw, target=r.integers(0, num_targ, size=n).astype(np.int32),
                          org=r.integers(0, 9, size=n).astype(np.int32),
                          position=r.integers(0, 10_000, size=n).astype(np.int32),
                          fstrand=r.random(n) < 0.5, count=np.ones(n, np.int32))
    parent = np.ones(num_targ, dtype=np.int32)
    for i in range(3, num_targ):
        parent[i] = int(r.integers(1, i))
    packed = pr.pack_probes(rec, num_targ=num_targ)
    tax = tax_cls(parent)
    return packed, tax, fp.build_fpdb(packed, tax)


@pytest.mark.parametrize("seed,n_probes,num_targ", [(1, 3000, 8), (2, 40_000, 64),
                                                    (3, 150_000, 300)])
def test_build_fpdb_matches_jax(seed, n_probes, num_targ):
    jpk, jtax, jfp = _db("jax", seed, n_probes, num_targ)
    tpk, ttax, tfp = _db("torch", seed, n_probes, num_targ)
    _equal(tpk, jpk, "packed")
    _equal(tfp, jfp, "fpdb")
    assert tfp.bloom is not None and tfp.nb2 > 0 or n_probes < 10_000
    np.testing.assert_array_equal(TFP.build_tinfo(ttax), JFP.build_tinfo(jtax))
    for t, j in zip(ttax.chain_tables(), jtax.chain_tables()):
        np.testing.assert_array_equal(t, j)


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("cache", ["packed", "fpdb"])
def test_caches_are_shared_both_ways(cache, writer, tmp_path):
    """Each package writes its own cache; the files are byte-identical, and
    the other package reads the writer's files into equal objects."""
    reader = "torch" if writer == "jax" else "jax"
    built = {pkg: _db(pkg, 5, 20_000, 32) for pkg in PKG}
    save = {"packed": "save_packed", "fpdb": "save_fpdb"}[cache]
    load = {"packed": "load_packed", "fpdb": "load_fpdb"}[cache]
    idx, mod = (0, 2) if cache == "packed" else (2, 1)
    for pkg, objs in built.items():
        getattr(PKG[pkg][mod], save)(objs[idx], tmp_path / pkg)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    got = getattr(PKG[reader][mod], load)(tmp_path / writer)
    _equal(got, built[writer][idx], f"{reader} reading {writer}'s {cache}")
    if cache == "packed":
        ck, want = got.cuckoo(), built[writer][0].cuckoo()
        assert (ck.nb, ck.s1, ck.s2) == (want.nb, want.s1, want.s2)
        np.testing.assert_array_equal(ck.table, want.table)


@pytest.mark.parametrize("case", ["clean", "exceptions", "ragged", "overflow"])
def test_pack_codes_matches_jax(case):
    r = np.random.default_rng(11)
    b, l = (64, 100) if case == "ragged" else (128, 160)
    codes = r.integers(0, 4, size=(b, l), dtype=np.uint8)
    lengths = r.integers(0, l + 1, size=b).astype(np.int32)
    if case != "clean":
        share = 0.2 if case == "overflow" else 0.01
        codes[r.random((b, l)) < share] = r.choice(np.array([4, 5, 255], np.uint8))
    got, want = TB.pack_codes(codes, lengths), JB.pack_codes(codes, lengths)
    if case == "overflow":
        assert got == want == (None, None)
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] >= 0).any() == (case != "clean")


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """A FASTQ.gz (Ns, U, low-quality tails, reads longer than the plane)
    and a plain FASTA (short, long and sub-KSIZE records)."""
    r = np.random.default_rng(13)
    d = tmp_path_factory.mktemp("reads")

    def dna(n, alphabet="ACGT"):
        s = np.frombuffer(alphabet.encode(), np.uint8)[r.integers(0, len(alphabet), size=n)]
        return s.tobytes().decode()

    lines = []
    for i in range(300):
        n = int(r.choice([60, 100, 150, 400]))
        seq = dna(n, "ACGTN" if i % 7 == 0 else "ACGU" if i % 11 == 0 else "ACGT")
        qual = "J" * n if i % 5 else "J" * (n - 30) + "#" * 30
        lines.append(f"@r{i} x\n{seq}\n+\n{qual}\n")
    fq = d / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        f.write("".join(lines))
    fa = d / "contigs.fasta"
    fa.write_text("".join(f">c{i} contig\n{dna(n, 'ACGTNU')}\n"
                          for i, n in enumerate([20, 31, 90, 500, 3000, 128, 129])))
    return {"fastq": fq, "fasta": fa}


def _item_fields(item):
    if isinstance(item, (JB.Batch, TB.Batch)):
        metas = [None if m is None else dataclasses.astuple(m) for m in item.metas]
        return ("batch", item.codes, item.lengths, item.packed, item.exc, item.n_rows, metas)
    return ("long", dataclasses.astuple(item.meta), item.codes)


def _python_feed(fx, bmod, files, u_is_t):
    rb = bmod.ReadBatcher(32, 128, u_is_t=u_is_t, stage_factor=2)
    out = []
    for rec in list(fx.iter_fastq_gz(str(files["fastq"]))) + list(
            fx.iter_fasta_plain(str(files["fasta"]))):
        out += [_item_fields(it) for it in rb.add(*rec)]
    return out + [_item_fields(it) for it in rb.flush()]


def _native_fields(nb, u_is_t):
    b, m = nb.batch, nb.batch.metas
    return (b.codes, b.lengths, b.packed, b.exc, b.n_rows, nb.long_rows,
            m.acc_bytes, m.acc_off, m.seq_bytes, m.seq_off, m.n_rows,
            [m.seq_codes(i, u_is_t) for i in nb.long_rows])


def _native_feed(nf, files, u_is_t):
    feeder = nf.NativePlaneFeeder(32, 128, u_is_t)
    out = []
    for path in (files["fastq"], files["fasta"]):
        for nb in list(feeder.feed_path(str(path))) + list(feeder.flush()):
            out.append(_native_fields(nb, u_is_t))
    return out


def _deep_equal(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _deep_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def large_files(tmp_path_factory):
    """Read files of several MiB each, so that many records and lines straddle
    the native reader's read-ahead blocks (1 MiB): a FASTQ.gz and a plain
    FASTQ (Ns, U, CRLF lines, low-quality tails, reads longer than the plane,
    headers with fields), and a multi-line FASTA.gz (records of 20 bp to 40
    kb, lines of 50-80, some empty lines)."""
    r = np.random.default_rng(23)
    d = tmp_path_factory.mktemp("large")
    bases = np.frombuffer(b"ACGTNU", np.uint8)

    def dna(n):
        s = bases[r.choice(6, size=n, p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02])]
        return s.tobytes().decode()

    def fastq(n_reads):
        out = []
        for i in range(n_reads):
            n = int(r.choice([60, 100, 150, 150, 150, 250, 400]))
            qual = "J" * n if i % 10 else "J" * (n - 25) + "#" * 25
            eol = "\r\n" if i % 13 == 0 else "\n"
            out.append(f"@read{i} {i % 7}:N:0{eol}{dna(n)}{eol}+{eol}{qual}{eol}")
        return "".join(out)

    with gzip.open(d / "reads.fastq.gz", "wt", compresslevel=1) as f:
        f.write(fastq(14_000))
    (d / "reads.fastq").write_text(fastq(12_000))
    with gzip.open(d / "contigs.fasta.gz", "wt", compresslevel=1) as f:
        for i in range(400):
            seq = dna(int(r.integers(20, 40_000)))
            w = int(r.integers(50, 81))
            lines = [seq[j:j + w] for j in range(0, len(seq), w)]
            f.write(f">contig{i} len={len(seq)}\n" + "\n".join(lines)
                    + ("\n\n" if i % 9 == 0 else "\n"))
    return d


def _large_feed(nf, d, u_is_t):
    feeder = nf.NativePlaneFeeder(256, 160, u_is_t)
    out = []
    for name in ("reads.fastq.gz", "reads.fastq", "contigs.fasta.gz"):
        for nb in list(feeder.feed_path(str(d / name))) + list(feeder.flush()):
            out.append(_native_fields(nb, u_is_t))
    return out


@pytest.mark.parametrize("u_is_t", [False, True])
@pytest.mark.parametrize("feed", ["python", "native", "native_large"])
def test_batches_match_jax(read_files, feed, u_is_t, request):
    if feed == "python":
        got = _python_feed(TFX, TB, read_files, u_is_t)
        want = _python_feed(JFX, JB, read_files, u_is_t)
        assert {x[0] for x in got} == {"batch", "long"}
    elif feed == "native_large":
        d = request.getfixturevalue("large_files")
        for name in ("reads.fastq.gz", "reads.fastq", "contigs.fasta.gz"):
            opener = gzip.open if name.endswith(".gz") else open
            with opener(d / name, "rb") as f:
                assert len(f.read()) > (4 << 20), name  # several read-ahead blocks
        got = _large_feed(TNF, d, u_is_t)
        want = _large_feed(JNF, d, u_is_t)
        assert any(x[5] for x in got)  # long rows
    else:
        assert TNF.native_available(), "the port's native decoder did not build (g++)"
        got = _native_feed(TNF, read_files, u_is_t)
        want = _native_feed(JNF, read_files, u_is_t)
        assert any(x[5] for x in got)  # long rows
    assert len(got) == len(want) > 2
    _deep_equal(got, want)


def _in_thread(fn, timeout_s=120):
    """``fn()`` on a daemon thread, joined with a timeout: its result, or a
    failure where it did not return."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"did not return within {timeout_s} s"
    assert out, "raised"
    return out[0]


@pytest.mark.parametrize("cut", [0.37, 0.81])
def test_truncated_gz_matches_jax(large_files, tmp_path, cut):
    """A .fastq.gz cut short ends, without hanging, at the same record as the
    JAX package's native feeder, which reads the stream on the calling
    thread 64 KiB at a time."""
    data = (large_files / "reads.fastq.gz").read_bytes()
    path = tmp_path / "cut.fastq.gz"
    path.write_bytes(data[: int(len(data) * cut)])

    def feed(nf):
        feeder = nf.NativePlaneFeeder(256, 160, False)
        return [_native_fields(nb, False)
                for nb in list(feeder.feed_path(str(path))) + list(feeder.flush())]

    got = _in_thread(lambda: feed(TNF))
    want = feed(JNF)
    assert len(got) > 4
    _deep_equal(got, want)


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def test_readers_closed_mid_file_stop_their_workers(large_files):
    """Fifty readers over a multi-MiB .fastq.gz, each filled once and closed
    mid-file (half through the feeder's generator, abandoned after its first
    batch; some after the worker has filled its ring and blocked): each close
    returns within seconds and the process's threads come back to their
    count."""
    import time

    from kmer_id_tpu_torch.io.native import NativeFileReader

    path = str(large_files / "reads.fastq.gz")
    start = _threads()
    b, l = 256, 160
    for i in range(50):
        if i % 2:
            gen = TNF.NativePlaneFeeder(b, l, False).feed_path(path)
            before = _threads()
            assert next(gen).batch.n_rows == b
            assert _threads() == before + 1  # the reader's worker
            close = gen.close  # feed_path's finally closes the reader
        else:
            reader = NativeFileReader(path, "fastq_gz", False)
            codes = np.empty((b, l), np.uint8)
            n, eof, (blocks, waits, wait_ns) = reader.fill(
                0, codes, np.zeros(b, np.int32), np.empty((b, 10), np.uint32),
                np.full(64, -1, np.int32), np.zeros(1, np.int32),
                np.zeros(b * 256, np.uint8), np.zeros(b + 1, np.int64),
                np.zeros(b * 1024, np.uint8), np.zeros(b + 1, np.int64))
            assert n == b and not eof and blocks == 1 and waits in (0, 1) and wait_ns >= 0
            if i % 10 == 0:
                time.sleep(0.3)  # the worker fills the ring and waits for a free block
            close = reader.close
        t = time.perf_counter()
        close()
        assert time.perf_counter() - t < 5
    # a closed reader's worker is joined; a Python thread that an earlier
    # test joined may still be leaving the list, so give the count a moment
    deadline = time.perf_counter() + 5
    while _threads() > start and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert _threads() <= start


@pytest.fixture(scope="module")
def pack_files(tmp_path_factory):
    """Two FASTQ.gz files of a pair (N in 1 read of 4, U in 1 of 9, reads
    longer than the plane, some with N), and one whose first 32 reads are 40%
    N (more than ``EXC_CAP`` in-length exceptions in one batch of 32 x 128)
    before reads of 2% N."""
    r = np.random.default_rng(19)
    d = tmp_path_factory.mktemp("pack")

    def fastq(path, reads):
        with gzip.open(path, "wt") as f:
            f.write("".join(f"@{acc}\n{seq}\n+\n{'J' * len(seq)}\n" for acc, seq in reads))

    def dna(n, n_share=0.0, u=False):
        s = np.frombuffer(b"ACGU" if u else b"ACGT", np.uint8)[r.integers(0, 4, size=n)]
        s[r.random(n) < n_share] = ord("N")
        return s.tobytes().decode()

    for name in ("r1", "r2"):
        fastq(d / f"{name}.fastq.gz",
              [(f"{name}_{i}", dna(int(r.choice([45, 100, 128, 129, 150, 400])),
                                   0.03 if i % 4 == 0 else 0.0, u=i % 9 == 0))
               for i in range(203)])
    fastq(d / "ns.fastq.gz", [(f"n{i}", dna(120, 0.4 if i < 32 else 0.02)) for i in range(75)])
    return d


# case: (batch, max_len, the feeder's blob caps per row, files fed before one flush)
PACK_CASES = {
    "two_files": (32, 128, {}, ("r1", "r2")),
    "early_flush": (32, 128, {"acc_cap_per_row": 8, "seq_cap_per_row": 48}, ("r1",)),
    "overflow": (32, 128, {}, ("ns",)),
    "partial": (64, 128, {}, ("r1",)),
    "long_rows": (32, 128, {}, ("r2",)),
    "odd_width": (48, 150, {}, ("r1", "r2")),
}


def _feed_all(nf, d, case, u_is_t, **kw):
    b, l, caps, names = PACK_CASES[case]
    feeder = nf.NativePlaneFeeder(b, l, u_is_t, **caps, **kw)
    out = []
    for name in names:
        out += feeder.feed_path(str(d / f"{name}.fastq.gz"))
    return out + list(feeder.flush())


@pytest.mark.parametrize("u_is_t", [False, True])
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_native_words_match_pack_codes(pack_files, case, u_is_t):
    """The words and exception list the native fill writes equal
    ``pack_codes`` of the batch's own code plane at its device lengths, and
    every field equals the JAX package's feeder's (which calls
    ``pack_codes``)."""
    from kmer_id_tpu_torch.utils import timing

    assert TNF.native_available(), "the port's native decoder did not build (g++)"
    b, l = PACK_CASES[case][:2]
    tr = timing.SampleTrace()
    got = _feed_all(TNF, pack_files, case, u_is_t, trace=tr)
    want = _feed_all(JNF, pack_files, case, u_is_t)
    _deep_equal([_native_fields(nb, u_is_t) for nb in got],
                [_native_fields(nb, u_is_t) for nb in want])
    overflowed = 0
    for nb in got:
        bt = nb.batch
        assert bt.codes.shape == (b, l)
        ref = TB.pack_codes(bt.codes, np.minimum(bt.lengths, l))
        if ref[0] is None:
            overflowed += 1
            assert bt.packed is None and bt.exc is None
            continue
        _deep_equal([bt.packed, bt.exc], list(ref))
        assert bt.packed.shape == (b, (l + 15) // 16)
        assert not bt.packed[bt.n_rows:].any()  # padding rows pack as zeros
        rows = bt.exc[bt.exc >= 0] // l
        assert not set(rows.tolist()) & set(nb.long_rows)  # long rows add none
    assert tr.counters["pack.plane"] == overflowed == (case == "overflow")
    n_rows = [nb.batch.n_rows for nb in got]
    accs = [bytes(nb.batch.metas.acc_bytes) for nb in got]
    if case == "two_files":
        assert any(b"r1_" in a and b"r2_" in a for a in accs)
    elif case == "early_flush":
        assert any(0 < n < b for n in n_rows[:-1])
    elif case == "partial":
        assert 0 < n_rows[-1] < b and all(n == b for n in n_rows[:-1])
    elif case == "long_rows":
        assert any((nb.batch.codes[nb.long_rows] >= 4).any() for nb in got)
    assert any(nb.batch.exc is not None and (nb.batch.exc >= 0).any() for nb in got)


def _m3_fixture(d, r, crlf):
    n = 40
    eol = "\r\n" if crlf else "\n"
    rows = [f"{t}\tk_p_c_o_f_s{t}\t{int(r.integers(1, 90))}\t{int(r.integers(5, 40))}\t"
            f"{int(r.integers(50, 200))}\t{int(r.integers(1000, 20000))}\t{int(r.integers(0, 3))}"
            for t in range(n)]
    (d / "refkey.txt").write_bytes(
        ("target\tname\tcount\thit\ttested\tgsize\tnstrains" + eol + eol.join(rows) + eol)
        .encode())
    (d / "result.txt").write_text("".join(
        f"{t},{int(r.integers(0, 50)) if t else 7},{int(r.integers(0, 9))}\n"
        for t in range(n)))


def _readc_fixture(d, r):
    n = 30
    (d / "key.txt").write_text("".join(f"{t}\tname{t}\n" for t in range(n)))
    (d / "count.txt").write_text("".join(f"{t},{int(r.integers(10, 90))}\n" for t in range(n)))
    jobs = ["zeta", "alpha", "mid"]
    (d / "jobs.txt").write_text("".join(f"{j} 1\nf_{j}.fastq\n" for j in jobs))
    for j in jobs:
        (d / f"{j}_result.txt").write_text("".join(
            f"{t},{int(r.integers(0, 40))},{int(r.integers(0, 5))}\n" for t in range(n)))


@pytest.mark.parametrize("report", ["m3", "m3_crlf_stripped", "readc"])
def test_rollup_csv_bytes_match_jax(report, tmp_path):
    r = np.random.default_rng(17)
    out = {}
    if report == "readc":
        _readc_fixture(tmp_path, r)
        for name, mod in (("jax", JRU), ("torch", TRU)):
            mod.readc_report(str(tmp_path), "jobs", str(tmp_path / "key.txt"),
                             str(tmp_path / "count.txt"), str(tmp_path / f"{name}.csv"))
    else:
        strip = report != "m3"
        _m3_fixture(tmp_path, r, crlf=strip)
        for name, mod in (("jax", JRU), ("torch", TRU)):
            mod.m3_report(str(tmp_path / "result.txt"), str(tmp_path / "refkey.txt"),
                          str(tmp_path / f"{name}.csv"), strip_cr=strip)
    got, want = ((tmp_path / f"{n}.csv").read_bytes() for n in ("torch", "jax"))
    assert got == want and got.count(b"\n") > 4
