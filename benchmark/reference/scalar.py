"""Read-by-read model of the reference classifier (``newkmer_10nx.cpp``,
``kmer_read_vf6.cpp``, ``kmer_read_m3.cpp``): quality trim, rolling
canonical 30-mers, probe lookup, the msca fold, per-target read counts,
unique-probe counts and the first ``savenum`` reads saved per target.  Slow
and plain; the tests hold ``vector.py`` to it at toy sizes."""

from __future__ import annotations

KSIZE = 30
MASK = (1 << (2 * KSIZE)) - 1
HI_SHIFT = 2 * (KSIZE - 1)
_CODE = {c: i for i, c in enumerate("ACGT")}
_CODE.update({c.lower(): i for i, c in enumerate("ACGT")})


def rolling_kmers(seq: str, u_is_t: bool):
    """Canonical keys of every 30-base run of valid letters, in order
    (``newkmer_10nx.cpp:452-528``)."""
    code = dict(_CODE)
    if u_is_t:
        code.update(U=3, u=3)
    fwd = rev = run = 0
    for ch in seq:
        c = code.get(ch)
        if c is None:
            fwd = rev = run = 0
            continue
        fwd = ((fwd << 2) & MASK) | c
        rev = (rev >> 2) | ((3 - c) << HI_SHIFT)
        run += 1
        if run == KSIZE:
            yield min(fwd, rev)
            run -= 1


def msca(parent, x: int, y: int, root: int = 1) -> int:
    """``newkmer_10nx.cpp:118-144``: the deeper of x and y where one is an
    ancestor of the other, else their lowest common ancestor."""

    def up(z):
        return parent[z] if (z != root and z > 0) else root

    anc = {root}
    z = x
    while z != root:
        anc.add(z)
        z = up(z)
    if y in anc:
        return x
    z = y
    while z not in anc:
        z = up(z)
        if z == x:
            return y
    return z


def trim(qual: str) -> tuple[int, int, bool]:
    """process_qual's trim (``newkmer_10nx.cpp:714-760``): (start, stop,
    keep)."""
    cutoff, w = 49, 4
    wcut = 17 * w
    q = [ord(c) for c in qual]
    start, stop = 0, len(q) - 1
    while q[start] < cutoff and start < stop:
        start += 1
    while q[stop] < cutoff and stop > start:
        stop -= 1
    if start < stop - w:
        wv = sum(q[start + i] - 32 for i in range(w))
        while wv < wcut and start < stop - w:
            wv += q[start + w] - q[start]
            start += 1
    if start < stop - w:
        wv = sum(q[stop - i] - 32 for i in range(w))
        while wv < wcut and start < stop - w:
            wv += q[stop - w] - q[stop]
            stop -= 1
    return start, stop, (stop - start) >= KSIZE


class Sample:
    """One sample (one counter reset): feed records in order, then read
    ``result_lines()`` and ``saved``."""

    def __init__(self, probes: dict, parent, num_targ: int, u_is_t: bool,
                 savenum: int = 12, save_main: bool = True):
        self.probes = probes  # canonical key -> target
        self.parent = parent
        self.u_is_t = u_is_t
        self.savenum = savenum
        self.save_main = save_main
        self.gcount = [0] * num_targ
        self.ucount = [0] * num_targ
        self.seen: set = set()
        self.saved: list = []  # (final, acc, trimmed sequence)

    def read(self, acc: str, seq: str) -> int:
        final = 0
        for key in rolling_kmers(seq, self.u_is_t):
            t = self.probes.get(key, 0)
            if t > 0:
                final = msca(self.parent, t, final) if final > 0 else t
            if t > 1 and key not in self.seen:
                self.ucount[t] += 1
                self.seen.add(key)
        if self.save_main and final > 1 and self.gcount[final] < self.savenum:
            self.saved.append((final, acc, seq))
        self.gcount[final] += 1
        return final

    def feed(self, records) -> None:
        """(acc, seq, qual) records; qual None for FASTA."""
        for acc, seq, qual in records:
            if qual is not None:
                start, stop, keep = trim(qual)
                if keep:
                    self.read(acc, seq[start : stop + 1])
            elif len(seq) > KSIZE:
                self.read(acc, seq)

    def result_lines(self) -> list:
        return [f"{i},{g},{u}" for i, (g, u) in enumerate(zip(self.gcount, self.ucount))]

    def reads_text(self) -> str:
        return "".join(f">{t}:{a}\n{s}\n" for t, a, s in self.saved)
