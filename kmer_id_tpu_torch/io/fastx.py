"""Streaming FASTQ/FASTA parsers with reference-parity record semantics.

Each generator mirrors one reference parser's observable behavior (which
header text becomes the saved-read accession, how empty/odd lines shift
state), because the saved-read capture files embed the accession verbatim:

* :func:`iter_fastq_gz`   ⇔ ``process_fqgz``  (``newkmer_10nx.cpp:762-816``):
  4-phase line counter that only advances on *non-empty* lines; accession is
  the full header line **including** the leading ``@``; seq/qual are full
  lines.
* :func:`iter_fastq_plain`⇔ ``process_fastq``/``process_fq``
  (``kmer_read_vf6.cpp:831-870``): each line reduced to its first whitespace
  token; a line whose extraction fails re-uses the previous token (stale-token
  quirk preserved).
* :func:`iter_fasta_gz`   ⇔ ``process_fagz`` (``newkmer_10nx.cpp:818-875``):
  accession = full header line minus ``>``; sequence lines concatenated
  verbatim; records shorter than KSIZE+1 are dropped by the caller's gate.
* :func:`iter_fasta_plain`⇔ ``process_fa`` (``newkmer_10nx.cpp:877-913``):
  first-token lines (so ``>acc desc`` keeps only ``>acc`` and sequence lines
  lose anything after whitespace), with the same stale-token quirk.

Records are yielded as (acc, seq, qual) string tuples (qual=None for FASTA).
Gates that decide whether a record reaches the classifier (trim keep, FASTA
length > KSIZE) belong to the engine, matching where the reference applies
them.

Copy of ``kmer_id_tpu/io/fastx.py``: the read parsers, and the genome
loaders that the verify replay reads genomes with (engine/verify.py).
"""

from __future__ import annotations

import gzip
from typing import Iterator, Optional

from kmer_id_tpu_torch.core.codec import KSIZE

Record = tuple[str, str, Optional[str]]


def _lines(path, gz: bool) -> Iterator[str]:
    opener = gzip.open if gz else open
    with opener(path, "rt", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.endswith("\r"):
                line = line[:-1]
            yield line


def iter_fastq_gz(path) -> Iterator[Record]:
    mod4 = 0
    acc = seq = ""
    for line in _lines(path, gz=True):
        if len(line) == 0:
            continue  # phase does not advance on empty lines
        if mod4 == 0:
            acc = line
        elif mod4 == 1:
            seq = line
        elif mod4 == 3:
            yield acc, seq, line
        mod4 = (mod4 + 1) % 4


def iter_fastq_plain(path) -> Iterator[Record]:
    mod4 = 0
    acc = seq = ""
    tok = ""
    for line in _lines(path, gz=False):
        parts = line.split()
        if parts:
            tok = parts[0]
        if len(tok) == 0:
            continue
        if mod4 == 0:
            acc = tok
        elif mod4 == 1:
            seq = tok
        elif mod4 == 3:
            yield acc, seq, tok
        mod4 = (mod4 + 1) % 4


def iter_fasta_gz(path) -> Iterator[Record]:
    acc = ""
    seq_parts: list[str] = []
    for line in _lines(path, gz=True):
        if len(line) == 0:
            continue
        if line[0] == ">":
            seq = "".join(seq_parts)
            if len(seq) > KSIZE:
                yield acc, seq, None
            seq_parts = []
            acc = line[1:]
        else:
            seq_parts.append(line)
    seq = "".join(seq_parts)
    if len(seq) > KSIZE:
        yield acc, seq, None


def iter_fasta_plain(path) -> Iterator[Record]:
    acc = ""
    tok = ""
    seq_parts: list[str] = []
    for line in _lines(path, gz=False):
        parts = line.split()
        if parts:
            tok = parts[0]
        if not tok:
            continue
        if tok[0] == ">":
            seq = "".join(seq_parts)
            if len(seq) > KSIZE:
                yield acc, seq, None
            seq_parts = []
            acc = tok[1:]
        else:
            seq_parts.append(tok)
    seq = "".join(seq_parts)
    if len(seq) > KSIZE:
        yield acc, seq, None


# ----------------------------------------------------------- genome loaders


def load_genome_gz(path, u_is_t: bool = False) -> str:
    """Concatenated genome string with 'N' contig separators.

    Mirrors the reference DB build's ``process_gz``
    (``kmer_build_vf6.cpp:305-351``):
    each ``>`` header contributes an ``N``; lowercase normalized; non-ACGT(U)
    become ``N``.
    """
    return _concat_genome(_lines(path, gz=True), u_is_t=u_is_t)


def load_genome_contigs(path, u_is_t: bool = False) -> str:
    """Plain-text contigs loader, mirroring ``load_data2``
    (``kmer_build_vf6.cpp:263-295``): strips all whitespace and skips lines
    of length <= 1 (a single-character line is dropped entirely)."""
    def lines():
        for line in _lines(path, gz=False):
            line = "".join(line.split())
            if len(line) > 1:
                yield line

    return _concat_genome(lines(), u_is_t=u_is_t)


def _norm_table(u_is_t: bool) -> bytes:
    tbl = bytearray(b"N" * 256)
    for c in b"ACGT":
        tbl[c] = c
        tbl[c + 32] = c  # lowercase
    if u_is_t:
        tbl[ord("U")] = ord("T")
        tbl[ord("u")] = ord("T")
    return bytes(tbl)


_NORM_TBL = _norm_table(False)
_NORM_TBL_U = _norm_table(True)


def _concat_genome(lines, u_is_t: bool) -> str:
    # bytes.translate normalizes at C speed (the per-character python dict
    # walk was the hotspot of the DB build's passes 1 and 3 on
    # multi-k-genome rebuilds)
    tbl = _NORM_TBL_U if u_is_t else _NORM_TBL
    out: list[str] = []
    for line in lines:
        if not line:
            continue
        if line[0] == ">":
            out.append("N")
        else:
            out.append(line.encode("latin-1", "replace").translate(tbl).decode("latin-1"))
    return "".join(out)
