"""Alignment-verification mode (``minalign > 0``): exact host-side replay.

Reference flow (``newkmer_10nx.cpp:530-587``): while a target's read count is
still below ``minalign``, each k-mer hit on it is verified by aligning the
read against the hit org's genome window (position/strand from the probe
record); a score below ``5*len(read)/2`` voids that hit for the fold and the
unique-k-mer accounting.  The trigger depends on the *live* ``gcount`` as
reads stream, so the decision chain is inherently sequential — all shipped
reference configs disable it (``minalign = 0``, ``:27``).

kmer_id_tpu keeps the fast batch engine for production and switches to this
exact replay only when ``minalign > 0``: the device still does the heavy
lifting (k-mer extraction + DB lookup, returning a per-window detail plane of
hit indices + read-strand bits), and the host replays the reference's
per-read loop — alignment checks, msca fold, kmer_seen/ucount, saved-read
capture — in read order.

Copy of ``kmer_id_tpu/engine/verify.py`` on the port's modules; the device
half is engine/classify.py's ``detail`` mode.
"""

from __future__ import annotations

import os

import numpy as np

from kmer_id_tpu_torch.core.align import banded_align_score
from kmer_id_tpu_torch.core.codec import KSIZE
from kmer_id_tpu_torch.io.fastx import load_genome_gz

_RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp_text(seq: str) -> str:
    """Reverse complement, non-ACGT -> 'N' (newkmer_10nx.cpp:552-574)."""
    return "".join(_RC.get(c, "N") for c in reversed(seq))


class GenomeCache:
    """fadir/<accession>.fasta.gz loader with N-joined contigs, capped LRU."""

    def __init__(self, fadir: str, accessions: list[str], u_is_t: bool = False,
                 max_cached: int = 64):
        self.fadir = fadir
        self.accessions = accessions
        self.u_is_t = u_is_t
        self.max_cached = max_cached
        self._cache: dict[int, str] = {}

    def get(self, org: int) -> str:
        if org in self._cache:
            return self._cache[org]
        path = os.path.join(self.fadir, self.accessions[org] + ".fasta.gz")
        seq = load_genome_gz(path, u_is_t=self.u_is_t) if os.path.exists(path) else ""
        if len(self._cache) >= self.max_cached:
            self._cache.pop(next(iter(self._cache)))
        self._cache[org] = seq
        return seq


class AlignVerifier:
    """Per-hit verification decisions (newkmer_10nx.cpp:530-587)."""

    def __init__(self, genomes: GenomeCache, db, minalign: int):
        self.genomes = genomes
        self.db = db  # PackedDB: org/position/fstrand per probe index
        self.minalign = minalign

    def check(self, trimmed_seq: str, full_len: int, probe_idx: int,
              kmer_end: int, read_fstrand: bool) -> bool:
        """True = hit stands, False = rejected (score below threshold)."""
        org = int(self.db.org[probe_idx])
        position = int(self.db.position[probe_idx])
        db_fstrand = bool(self.db.fstrand[probe_idx])
        genome = self.genomes.get(org)
        stlen2 = len(genome)
        readlength = len(trimmed_seq)
        minscr = 5 * full_len // 2  # integer division as in C++ (:474)
        readlen2 = readlength
        if read_fstrand == db_fstrand:
            st2 = position - kmer_end
            if st2 < 0:
                st2 = 0
            if st2 + readlen2 > stlen2:
                readlen2 = stlen2 - st2
            dna1 = trimmed_seq
        else:
            st2 = position - KSIZE + 2 + kmer_end - readlength
            if st2 < 0:
                st2 = 0
            if st2 + readlen2 > stlen2:
                readlen2 = stlen2 - st2
            dna1 = revcomp_text(trimmed_seq)
        dna2 = genome[st2 : st2 + max(readlen2, 0)]
        return banded_align_score(dna1, dna2) >= minscr


def replay_read(
    tax,
    db,
    detail_row: np.ndarray,
    trimmed_seq: str,
    full_len: int,
    verifier: AlignVerifier,
    gcount: np.ndarray,
    ucount: np.ndarray,
    kmer_seen: set,
    keys_row: np.ndarray,
    trim_start: int = 0,
) -> int:
    """Replay one read's per-window loop exactly (newkmer_10nx.cpp:526-616).

    ``detail_row``: per-window packed hit info — 0 = miss, else
    ``(probe_idx+1) * (+1 fwd / -1 rev)``; window s's k-mer ends at
    ``s + KSIZE - 1`` *within the trimmed read* — the reference's ``it1``
    counts from the full sequence start, so the verifier gets
    ``trim_start + s + KSIZE - 1``.
    ``full_len``: UNtrimmed read length (minscr base, newkmer_10nx.cpp:474).
    ``keys_row``: canonical uint64 key per window (for kmer_seen).
    """
    final = 0
    for s in np.nonzero(detail_row)[0]:
        v = int(detail_row[s])
        probe_idx = abs(v) - 1
        read_fstrand = v > 0
        target = int(db.target[probe_idx])
        if (
            target > 0
            and verifier.minalign > 0
            and gcount[target] < verifier.minalign
            and target != final
        ):
            if not verifier.check(
                trimmed_seq,
                full_len,
                probe_idx,
                trim_start + int(s) + KSIZE - 1,
                read_fstrand,
            ):
                target = 0
        if final > 0 and target > 0:
            final = int(tax.msca(target, final))
        elif target > 0:
            final = target
        if target > 1:
            key = int(keys_row[s])
            if key not in kmer_seen:
                ucount[target] += 1
                kmer_seen.add(key)
    return final
