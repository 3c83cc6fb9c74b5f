"""``build-db`` of the PyTorch port against the JAX package's, on the CPU.

On the genome worlds of ``tests/test_builder.py``, ``test_builder_native.py``
and ``test_spill.py`` (made again here from their seeds), the port's CLI
must write ``<name>_probes.txt`` and ``<name>_count.txt`` byte-identical to
``kmer_id_tpu.cli build-db``: in RAM and with ``--spill``, with the port's
native builder library and without it (``_lib`` patched away, as
``tests/test_spill.py`` does).  Also the spill at forced tiny batches, a
missing genome (exit status 1), the entropy filter, the native decode and
sorts and the probe-text writer against their numpy forms and the JAX
package.
"""

import gzip

import numpy as np
import pytest

from kmer_id_tpu import cli as jax_cli
from kmer_id_tpu.core import codec as jcodec
from kmer_id_tpu.db.entropy import check_entropy_keys as jax_check_entropy_keys
from kmer_id_tpu.db.probes import ProbeRecords as JaxProbeRecords
from kmer_id_tpu.db.probes import write_probes_text as jax_write_probes_text
from kmer_id_tpu.db.spill import build_probes_spill as jax_build_probes_spill
from kmer_id_tpu_torch import cli
from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.db import native as kn
from kmer_id_tpu_torch.db.entropy import check_entropy_keys
from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text
from kmer_id_tpu_torch.db.spill import build_probes_spill
from kmer_id_tpu_torch.io.fastx import load_genome_contigs, load_genome_gz

BASES = np.array(list("ACGT"))


def _dna(rng, n):
    return "".join(BASES[rng.integers(0, 4, size=n)])


def _fasta_gz(path, name, seq, width=70):
    with gzip.open(path, "wt") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width] + "\n")


def _corpus(tmp_path, name, rng, n_orgs, body, shared_len, outg_len, tail, outg_orgs, n_run,
            tree):
    """test_builder_native's and test_spill's worlds: ``n_orgs`` genomes of
    ``body`` random bases, a shared block and ``tail`` more, the outgroup
    block in ``outg_orgs``, ``n_run`` = (org, position, length) of an N run
    and a filtered outgroup genome gOUT."""
    wdir, fadir = tmp_path / name, tmp_path / "fa"
    wdir.mkdir()
    fadir.mkdir()
    shared, outg = _dna(rng, shared_len), _dna(rng, outg_len)
    data, edges = [], []
    for i in range(n_orgs):
        seq = _dna(rng, body) + shared + _dna(rng, tail)
        if i in outg_orgs:
            seq += outg
        if i == n_run[0]:
            seq = seq[: n_run[1]] + "N" * n_run[2] + seq[n_run[1] :]
        _fasta_gz(fadir / f"org{i}.fasta.gz", f"org{i}", seq)
        data.append(f"{i + 2}\torg{i}")
        edges.append(tree(i))
    with gzip.open(fadir / "gOUT.fasta.gz", "wt") as f:
        f.write(">gOUT\n" + outg + "\n")
    (wdir / f"{name}_data.txt").write_text("\n".join(data) + "\n")
    (wdir / f"{name}_tree.txt").write_text("\n".join(edges) + "\n")
    (wdir / f"{name}_filter.txt").write_text("gOUT\n")


def make_world(kind, tmp_path):
    """The world of tests/test_builder.py (``builder``), of
    tests/test_builder_native.py (``native``) or of tests/test_spill.py
    (``spill``) under ``tmp_path``; returns its DB name."""
    if kind == "builder":  # tiny_world
        rng = np.random.default_rng(11)
        shared, outg = _dna(rng, 300), _dna(rng, 250)
        a1, a2, b1 = _dna(rng, 400), _dna(rng, 400), _dna(rng, 400)
        genomes = {"accA1": a1 + shared + outg, "accA2": shared + a2, "accB1": b1,
                   "accOUT": _dna(rng, 150) + outg}
        (tmp_path / "tiny").mkdir()
        (tmp_path / "fa").mkdir()
        for acc, seq in genomes.items():
            _fasta_gz(tmp_path / "fa" / f"{acc}.fasta.gz", acc, seq)
        (tmp_path / "tiny" / "tiny_data.txt").write_text("3\taccA1\n4\taccA2\n6\taccB1\n")
        (tmp_path / "tiny" / "tiny_tree.txt").write_text("1\t2\n2\t3\n2\t4\n1\t5\n5\t6\n")
        (tmp_path / "tiny" / "tiny_filter.txt").write_text("accOUT\n")
        return "tiny"
    if kind == "native":  # small_world
        _corpus(tmp_path, "nat", np.random.default_rng(23), 5, 3000, 400, 300, 500, (0,),
                (2, 1000, 3), lambda i: f"1\t{i + 2}")
        return "nat"
    _corpus(tmp_path, "sp", np.random.default_rng(41), 6, 4000, 500, 400, 600, (0, 3),
            (2, 1500, 2), lambda i: f"1\t{i + 2}" if i < 3 else f"2\t{i + 2}")
    return "sp"


def _outputs(tmp_path, name):
    return tuple((tmp_path / name / f"{name}_{k}.txt").read_bytes() for k in ("probes", "count"))


@pytest.fixture
def no_native(monkeypatch):
    """The port without its native builder library."""
    monkeypatch.setattr(kn, "_lib", None)
    monkeypatch.setattr(kn, "_lib_tried", True)


SPILL = ["--spill", "--spill-shard-bits", "4", "--spill-batch-mb", "1"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("spill", [False, True], ids=["in_ram", "spill"])
@pytest.mark.parametrize("kind", ["builder", "native", "spill"])
def test_build_db_cli_matches_jax_cli(kind, spill, native, tmp_path, request):
    name = make_world(kind, tmp_path)
    argv = ["build-db", "-name", name, "-fadir", str(tmp_path / "fa"), "--root", str(tmp_path)]
    argv += SPILL if spill else []
    assert jax_cli.main(argv) == 0
    want = _outputs(tmp_path, name)
    assert want[0].count(b"\n") > 0
    if native:
        assert kn.native_available()
    else:
        request.getfixturevalue("no_native")
        assert not kn.native_available()
    assert cli.main(argv) == 0
    assert _outputs(tmp_path, name) == want
    assert not (tmp_path / name / ".spill").exists()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_spill_tiny_batches_matches_jax(native, tmp_path, request):
    """The spill at 256-KiB batches and 16 shards (several shard merge
    rounds, shard-sliced poisoning and candidate spools), against the JAX
    package's at the same settings."""
    name = make_world("spill", tmp_path)
    fadir = str(tmp_path / "fa")
    jres = jax_build_probes_spill(name, fadir, root=str(tmp_path), shard_bits=4,
                                  batch_bytes=1 << 18)
    want = _outputs(tmp_path, name)
    if not native:
        request.getfixturevalue("no_native")
    res = build_probes_spill(name, fadir, root=str(tmp_path), shard_bits=4, batch_bytes=1 << 18)
    assert _outputs(tmp_path, name) == want
    assert res.table_size == jres.table_size and res.pcount.tolist() == jres.pcount.tolist()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_missing_genome_exits_1(native, tmp_path, request):
    """A data.txt accession without a genome file ends the build with status
    1 (kmer_build_vf6.cpp:772), as in the JAX package."""
    name = make_world("builder", tmp_path)
    with open(tmp_path / name / f"{name}_data.txt", "a") as f:
        f.write("5\taccMISSING\n")
    argv = ["build-db", "-name", name, "-fadir", str(tmp_path / "fa"), "--root", str(tmp_path)]
    with pytest.raises(SystemExit) as jax_exit:
        jax_cli.main(argv)
    if not native:
        request.getfixturevalue("no_native")
    with pytest.raises(SystemExit) as port_exit:
        cli.main(argv)
    assert port_exit.value.code == jax_exit.value.code == 1


def _entropy_kmers(rng):
    return [_dna(rng, 30) for _ in range(500)] + [
        "A" * 30, "AC" * 15, "ACG" * 10, "ACGT" * 7 + "AC", "A" * 12 + _dna(rng, 18),
        "A" * 11 + _dna(rng, 19), "AATT" * 7 + "AA", "AAAAACCCCCGGGGGTTTTT" + _dna(rng, 10),
        "AACCGGTTAACCGGTTAACCGGTTAACCGG"]


def test_entropy_filter_matches_jax_and_native():
    keys = np.array([jcodec.string_to_key(s) for s in _entropy_kmers(np.random.default_rng(23))],
                    dtype=np.uint64)
    want = jax_check_entropy_keys(keys)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(check_entropy_keys(keys), want)
    np.testing.assert_array_equal(kn.check_entropy_keys(keys), want)


def test_native_extraction_and_sorts_match_numpy(tmp_path):
    """The port's native library against numpy: unique counts and first
    occurrences of a messy genome (lowercase, N runs, U, CRLF, empty lines,
    contigs kind), the int32 radix argsort and the key decode."""
    rng = np.random.default_rng(5)
    seq1 = _dna(rng, 500).lower() + "NN" + _dna(rng, 300)
    seq2 = _dna(rng, 80) + "U" + _dna(rng, 200)
    gz = tmp_path / "messy.fasta.gz"
    with gzip.open(gz, "wt") as f:
        f.write(">contig1 desc\r\n" + "".join(seq1[i : i + 61] + "\r\n"
                                              for i in range(0, len(seq1), 61)))
        f.write("\n>contig2\n" + "".join(seq2[i : i + 70] + "\n" for i in range(0, len(seq2), 70)))
    contigs = tmp_path / "x_contigs.fasta"
    contigs.write_text(f">c1\n{_dna(rng, 200)}\nA\n  {_dna(rng, 50)}  \n>c2\n{_dna(rng, 100)}\n")
    for path, kind, u_is_t in ((gz, "gz", False), (gz, "gz", True), (contigs, "contigs", False)):
        genome = (load_genome_gz(str(path), u_is_t=u_is_t) if kind == "gz"
                  else load_genome_contigs(str(path)))
        lut = codec.CODE_LUT_U if u_is_t else codec.CODE_LUT
        keys, gpos, fwd = codec.canonical_kmers(lut[np.frombuffer(genome.encode(), np.uint8)])
        uk, first, counts = np.unique(keys, return_index=True, return_counts=True)
        got = kn.genome_unique_counts(str(path), kind, u_is_t=u_is_t)
        np.testing.assert_array_equal(got[0], uk)
        np.testing.assert_array_equal(got[1], counts.astype(np.int32))
        got = kn.genome_unique_first(str(path), kind, u_is_t=u_is_t)
        np.testing.assert_array_equal(got[0], uk)
        np.testing.assert_array_equal(got[1], gpos[first].astype(np.int32))
        np.testing.assert_array_equal(got[2], fwd[first])
    a = rng.integers(0, 1 << 60, size=200).astype(np.uint64)
    b = rng.integers(0, 1 << 31, size=30_000).astype(np.int32)
    b[100:200] = b[0]
    np.testing.assert_array_equal(kn.argsort_i32(b), np.argsort(b, kind="stable"))
    assert [s.decode() for s in kn.keys_to_strings(a)] == [
        codec.key_to_string(k) for k in a] == [jcodec.key_to_string(k) for k in a]


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_probe_writer_matches_jax(suffix, tmp_path, monkeypatch):
    """write_probes_text by the native writer, by the native key decode (a
    gzip file) and by numpy (no library): the JAX package's bytes."""
    rng = np.random.default_rng(9)
    n = 500
    cols = dict(keys=rng.integers(0, 1 << 60, size=n).astype(np.uint64),
                target=rng.integers(0, 6000, size=n).astype(np.int32),
                org=rng.integers(0, 90, size=n).astype(np.int32),
                position=rng.integers(0, 1 << 30, size=n).astype(np.int32),
                fstrand=rng.random(n) < 0.5, count=rng.integers(1, 2048, size=n).astype(np.int32))
    jax_write_probes_text(JaxProbeRecords(**cols), str(tmp_path / f"jax{suffix}"))
    write_probes_text(ProbeRecords(**cols), str(tmp_path / f"lib{suffix}"))
    monkeypatch.setattr(kn, "_lib", None)
    monkeypatch.setattr(kn, "_lib_tried", True)
    write_probes_text(ProbeRecords(**cols), str(tmp_path / f"numpy{suffix}"))

    def text(name):
        with (gzip.open if suffix.endswith(".gz") else open)(tmp_path / name, "rb") as f:
            return f.read()

    assert text(f"lib{suffix}") == text(f"numpy{suffix}") == text(f"jax{suffix}")
