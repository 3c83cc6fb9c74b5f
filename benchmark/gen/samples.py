"""The pool of requests of a traffic mix: read or contig files made from the
seed by one general generator, driven by the mix's parameters
(``benchmark/traffic/<mix>.json``):

* ``format``: ``fastq_gz`` (reads with qualities) or ``fasta`` (contigs);
* ``files``: files per request (2: a read pair, fed R1 then R2);
* ``reads_per_file``, or ``bases_per_file`` (as many records as the mean
  length gives);
* ``length`` [lo, hi]: record lengths, spread evenly and shuffled;
  ``long_share`` of the records take ``long_length`` [lo, hi] instead;
* ``community``: the sample's genomes and their abundances:
  ``genomes`` leaves of the DB's tree, with log-normal shares
  (``abundance`` "lognormal", ``mu``, ``sigma``: the quantiles of that
  law, dealt to the genomes by the seed); each record comes from one genome,
  and records are dealt to the genomes by their shares;
* ``plants_per_read`` [lo, hi]: probes planted per record, spread evenly
  and shuffled, or ``plant_every``: one probe per that many bases; a plant
  is a probe drawn uniformly from the record's genome's lineage (the probes
  of its target and of every ancestor), on either strand, so a record's
  hits follow one lineage as a real read's do;
* ``n_share``: records with one N; ``tail_share``: FASTQ records whose last
  ``tail_length`` qualities are '#' (trimmed away); ``u_share``: records
  with every T written as U;
* ``pool``: requests made; the window cycles through them.

Every count is fixed by the parameters, so two seeds give the same work in
another order and on other probes."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

from benchmark.gen.db import ProbeDB, rng_for
from benchmark.gen.dna import ACGT, KSIZE, key_chars, revcomp, spread

DIGITS = 7  # accession digits of a FASTQ record


@dataclass
class ReadFile:
    """One input file, as the arrays it is written from."""

    fmt: str  # "fastq_gz" or "fasta"
    tag: str  # accession prefix
    seq: np.ndarray  # uint8, every record's letters back to back
    off: np.ndarray  # int64 [n + 1], record i is seq[off[i]:off[i + 1]]
    qual: np.ndarray | None  # uint8 like seq (FASTQ), None for FASTA
    path: str = ""

    @property
    def n(self) -> int:
        return len(self.off) - 1

    def acc(self, i: int) -> str:
        """Record i's accession as the classifier reports it: a FASTQ.gz
        header line whole, with its '@'; a plain FASTA header's first token
        without its '>'."""
        if self.fmt == "fastq_gz":
            return f"@{self.tag}{i:0{DIGITS}d}"
        return f"{self.tag}{i}"


@dataclass
class Request:
    index: int
    files: list = field(default_factory=list)

    @property
    def reads(self) -> int:
        return sum(f.n for f in self.files)

    @property
    def bases(self) -> int:
        return sum(int(f.off[-1]) for f in self.files)


@dataclass
class Community:
    """The genomes a request's records come from (see the module doc)."""

    genomes: np.ndarray  # int64 [G]: leaf targets of the DB's tree
    share: np.ndarray  # float64 [G], summing to 1
    path: np.ndarray  # int64 [G, D]: each genome's lineage, leaf first; -1 past the root
    total: np.ndarray  # int64 [G]: probes on each lineage
    db: ProbeDB

    def deal(self, rng, n: int) -> np.ndarray:
        """Indices into ``genomes`` of n records: each genome's count is its
        share of n, rounded by the largest remainders, in the seed's order."""
        exact = self.share * n
        count = np.floor(exact).astype(np.int64)
        count[np.argsort(count - exact, kind="stable")[: n - int(count.sum())]] += 1
        return rng.permutation(np.repeat(np.arange(len(count)), count))

    def draw(self, rng, g: np.ndarray) -> np.ndarray:
        """Keys: one probe drawn uniformly from the lineage of each genome
        index in g, on either strand."""
        db = self.db
        r = (rng.random(len(g)) * self.total[g]).astype(np.int64)
        pick = np.full(len(g), -1, dtype=np.int64)
        for d in range(self.path.shape[1]):
            node = self.path[g, d]
            c = np.where(node >= 0, np.diff(db.target_start)[np.maximum(node, 0)], 0)
            hit = (pick < 0) & (r < c)
            pick[hit] = db.by_target[db.target_start[node[hit]] + r[hit]]
            r = np.where(pick < 0, r - c, r)
        keys = db.keys[pick]
        flip = rng.random(len(g)) < 0.5
        keys[flip] = revcomp(keys[flip])
        return keys


def community(rng, traffic: dict, db: ProbeDB) -> Community:
    c = traffic["community"]
    if c.get("abundance", "lognormal") != "lognormal":
        raise ValueError(f"unknown abundance law {c['abundance']!r}")
    has_child = np.zeros(db.num_targ, dtype=bool)
    has_child[db.parent[2:]] = True
    leaves = np.nonzero(~has_child[2:])[0] + 2
    genomes = np.sort(rng.choice(leaves, size=min(int(c["genomes"]), len(leaves)),
                                 replace=False)).astype(np.int64)
    q = NormalDist(float(c["mu"]), float(c["sigma"]))
    w = np.exp([q.inv_cdf((i + 0.5) / len(genomes)) for i in range(len(genomes))])
    share = rng.permutation(w / w.sum())
    cols, cur = [], genomes.copy()
    while (cur >= 2).any():
        cols.append(np.where(cur >= 2, cur, -1))
        cur = np.where(cur >= 2, db.parent[np.maximum(cur, 0)], 1)
    path = np.stack(cols, axis=1)
    per = np.diff(db.target_start)
    total = np.where(path >= 0, per[np.maximum(path, 0)], 0).sum(axis=1)
    if (total == 0).any():
        raise ValueError("a genome's lineage holds no probe")
    return Community(genomes, share, path, total, db)


def _lengths(rng, traffic: dict, n: int) -> np.ndarray:
    n_long = int(round(n * traffic.get("long_share", 0.0)))
    parts = [spread(n - n_long, *traffic["length"])]
    if n_long:
        parts.append(spread(n_long, *traffic["long_length"]))
    return rng.permutation(np.concatenate(parts))


def _records(traffic: dict) -> int:
    if "reads_per_file" in traffic:
        return int(traffic["reads_per_file"])
    lo, hi = traffic["length"]
    return max(1, int(round(traffic["bases_per_file"] / ((lo + hi) / 2))))


def _pick(rng, n: int, share: float) -> np.ndarray:
    return rng.choice(n, size=int(round(n * share)), replace=False)


def make_file(rng, traffic: dict, com: Community, tag: str) -> ReadFile:
    """One file's records (see the module doc)."""
    n = _records(traffic)
    lens = _lengths(rng, traffic, n)
    if lens.min() <= KSIZE:
        raise ValueError("records must be longer than 30 bases")
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    seq = ACGT[rng.integers(0, 4, size=int(off[-1]), dtype=np.uint8)]
    src = com.deal(rng, n)
    if "plant_every" in traffic:
        k = lens // int(traffic["plant_every"])
    else:
        k = rng.permutation(spread(n, *traffic["plants_per_read"]))
    for j in range(int(k.max(initial=0))):
        rows = np.nonzero(k > j)[0]
        pos = off[rows] + (rng.random(len(rows)) * (lens[rows] - KSIZE)).astype(np.int64)
        seq[pos[:, None] + np.arange(KSIZE)[None, :]] = key_chars(com.draw(rng, src[rows]))
    rows = _pick(rng, n, traffic.get("n_share", 0.0))
    seq[off[rows] + (rng.random(len(rows)) * lens[rows]).astype(np.int64)] = ord("N")
    rows = _pick(rng, n, traffic.get("u_share", 0.0))
    if len(rows):
        flag = np.zeros(n, dtype=bool)
        flag[rows] = True
        seq[np.repeat(flag, lens) & (seq == ord("T"))] = ord("U")
    qual = None
    if traffic["format"] == "fastq_gz":
        qual = np.full(len(seq), ord("J"), dtype=np.uint8)
        tl = int(traffic.get("tail_length", 0))
        rows = _pick(rng, n, traffic.get("tail_share", 0.0))
        if tl and len(rows):
            qual[(off[rows + 1][:, None] - tl + np.arange(tl)[None, :]).reshape(-1)] = ord("#")
        if n >= 10**DIGITS:
            raise ValueError(f"{n} records need more than {DIGITS} accession digits")
    return ReadFile(traffic["format"], tag, seq, off, qual)


def make_pool(seed: int, traffic: dict, db: ProbeDB) -> list:
    """The mix's ``pool`` requests (arrays only; :func:`write_pool` writes
    them)."""
    com = community(rng_for(seed, 1), traffic, db)
    pool = []
    tags = "ab" if traffic["files"] == 2 else "rcdefgh"[: traffic["files"]]
    for r in range(int(traffic["pool"])):
        req = Request(r)
        for f in range(int(traffic["files"])):
            req.files.append(make_file(rng_for(seed, 2, r, f), traffic, com, tags[f]))
        pool.append(req)
    return pool


def fastq_bytes(rf: ReadFile, i0: int, i1: int) -> bytes:
    """Records [i0, i1) of a FASTQ file as text: header, sequence, '+'
    line and qualities of each record placed at its offset in one buffer."""
    lens = np.diff(rf.off[i0 : i1 + 1])
    n = len(lens)
    head = np.frombuffer(b"@" + rf.tag.encode(), dtype=np.uint8)
    h = len(head) + DIGITS + 1
    size = h + 2 * lens + 4
    at = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(size, out=at[1:])
    buf = np.empty(int(at[-1]), dtype=np.uint8)
    rows = at[:-1]
    idx = np.arange(i0, i1, dtype=np.int64)
    for j, c in enumerate(head):
        buf[rows + j] = c
    for d in range(DIGITS):
        buf[rows + len(head) + d] = ord("0") + (idx // 10 ** (DIGITS - 1 - d)) % 10
    buf[rows + h - 1] = ord("\n")
    flat = np.arange(int(rf.off[i0]), int(rf.off[i1]), dtype=np.int64)
    shift = np.repeat(rows + h - rf.off[i0:i1], lens)
    buf[flat + shift] = rf.seq[flat]
    for j, c in enumerate(b"\n+\n"):
        buf[rows + h + lens + j] = c
    buf[flat + shift + np.repeat(lens + 3, lens)] = rf.qual[flat]
    buf[at[1:] - 1] = ord("\n")
    return buf.tobytes()


def fasta_bytes(rf: ReadFile) -> bytes:
    parts = []
    for i in range(rf.n):
        parts.append(f">{rf.tag}{i}\n".encode())
        parts.append(rf.seq[rf.off[i] : rf.off[i + 1]].tobytes())
        parts.append(b"\n")
    return b"".join(parts)


def write_file(rf: ReadFile, path: str) -> None:
    if rf.fmt == "fasta":
        with open(path, "wb") as f:
            f.write(fasta_bytes(rf))
    else:
        z = zlib.compressobj(1, zlib.DEFLATED, 31)  # gzip framing, fastest level
        step = max(1, (16 << 20) // int(np.diff(rf.off).max()))
        with open(path, "wb") as f:
            for i0 in range(0, rf.n, step):
                f.write(z.compress(fastq_bytes(rf, i0, min(i0 + step, rf.n))))
            f.write(z.flush())
    rf.path = path


def file_name(req: Request, f: int, driver: str) -> str:
    if driver == "nx":
        return f"s{req.index}_R{f + 1}_tr.fastq.gz"
    return f"s{req.index}_{f}." + ("fasta" if req.files[f].fmt == "fasta" else "fastq.gz")


def write_pool(pool: list, directory: str, driver: str, threads: int = 4) -> None:
    """Writes every request's files into ``directory`` (several at once:
    zlib works outside the interpreter lock)."""
    os.makedirs(directory, exist_ok=True)
    jobs = [(rf, os.path.join(directory, file_name(req, f, driver)))
            for req in pool for f, rf in enumerate(req.files)]
    with ThreadPoolExecutor(threads) as ex:
        for fut in [ex.submit(write_file, rf, p) for rf, p in jobs]:
            fut.result()
