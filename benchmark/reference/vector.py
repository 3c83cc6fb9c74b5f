"""The reference's outputs for whole requests at the cells' sizes: the same
semantics as ``scalar.py``, in plain PyTorch over blocks of records (on the
card after the window, on the CPU in the tests), the fold and the outputs
in NumPy.

Per block: the quality trim of every record (its four loops as first and
last indices over the block's padded rows), the codes of the kept ranges
(everything else invalid), every 30-mer as a 60-bit word built by doubling
(2, 4, 8, 16 bases, then 16 + 8 + 4 + 2), its validity from a running count
of invalid codes, its canonical form, and the exact probe lookup (a binary
search of the sorted probe keys).  Then per request: each read's hits
folded by msca in window order, the counters and the first ``savenum``
reads per target in read order."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

KSIZE = 30
INVALID = 4
CUTOFF, W, WCUT = 49, 4, 68  # process_qual's quality cutoff, window, window cutoff
BLOCK_CELLS = 1 << 24  # padded cells (records x longest record) per block


def code_table(u_is_t: bool) -> np.ndarray:
    lut = np.full(256, INVALID, dtype=np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = lut[c + 32] = i
    if u_is_t:
        lut[ord("U")] = lut[ord("u")] = 3
    return lut


def revcomp(x: torch.Tensor) -> torch.Tensor:
    """Reverse complement of 60-bit keys (int64): every 2-bit code
    complemented, the 32 codes of the word reversed (pairs, nibbles, then
    bytes), the two zero codes shifted out."""
    x = x ^ ((1 << 60) - 1)
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = x.contiguous().view(torch.uint8).view(-1, 8).flip(1).contiguous().view(torch.int64)
    return (x.view(-1) >> 4) & ((1 << 60) - 1)


class Probes:
    """Exact lookup of canonical keys in the probe list (sorted keys < 2^60)."""

    def __init__(self, keys: np.ndarray, targets: np.ndarray, device: str = "cpu"):
        self.keys = torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)).to(device)
        self.targets = torch.from_numpy(np.asarray(targets, np.int32)).to(device)
        self.device = device
        if len(keys) > 1 and not bool((self.keys[1:] > self.keys[:-1]).all()):
            raise ValueError("the probe keys must be sorted and distinct")

    def find(self, q: torch.Tensor):
        """(indices into q that are probes, their targets)."""
        if len(self.keys) == 0 or len(q) == 0:
            return q[:0].long(), self.targets[:0]
        i = torch.searchsorted(self.keys, q).clamp_(max=len(self.keys) - 1)
        hit = torch.nonzero(self.keys[i] == q).view(-1)
        return hit, self.targets[i[hit]]


class Tree:
    """msca on the parent list: the deeper of two nodes where one is an
    ancestor of the other, else their lowest common ancestor."""

    def __init__(self, parent, root: int = 1):
        up = np.asarray(parent, dtype=np.int64).copy()
        up[0] = root
        up[root] = root
        depth = np.zeros(len(up), dtype=np.int64)
        for _ in range(len(up)):
            nxt = np.where(np.arange(len(up)) == root, 0, depth[up] + 1)
            if np.array_equal(nxt, depth):
                break
            depth = nxt
        self.up, self.depth = up, depth

    def msca(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        a, b = x.astype(np.int64), y.astype(np.int64)
        da, db = self.depth[a], self.depth[b]
        for s, ds, do in ((a, da, db), (b, db, da)):
            while True:
                m = ds > do
                if not m.any():
                    break
                s[m] = self.up[s[m]]
                ds[m] -= 1
        while True:
            m = a != b
            if not m.any():
                break
            a[m] = self.up[a[m]]
            b[m] = self.up[b[m]]
        return np.where(a == y, x, np.where(a == x, y, a))


def trim(qual: torch.Tensor, off: torch.Tensor):
    """process_qual's (start, stop, keep) of records [i] = qual[off[i]:off[i+1]]
    (see scalar.trim); int64 tensors."""
    lens = off[1:] - off[:-1]
    n, w = len(lens), int(lens.max())
    col = torch.arange(w, device=qual.device)
    inside = col[None, :] < lens[:, None]
    src = (off[:-1, None] + col).clamp_(max=len(qual) - 1)
    q = torch.where(inside, qual[src], 0).to(torch.int32)
    good = q >= CUTOFF
    anyg = good.any(dim=1)
    start = torch.minimum(torch.where(anyg, good.int().argmax(dim=1), w), lens - 1)
    last_good = w - 1 - good.flip(1).int().argmax(dim=1)
    stop = torch.maximum(torch.where(anyg, last_good, -1), start)
    cq = torch.zeros((n, w + 1), dtype=torch.int32, device=qual.device)
    cq[:, 1:] = torch.cumsum(q, dim=1)
    ws = (cq[:, W:] - cq[:, :-W] - 32 * W) >= WCUT  # window sum from s, s in [0, w - 4]
    scol = col[None, : w - W + 1]
    ok = ws & (scol >= start[:, None])
    first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1), w)
    act = start < stop - W
    start = torch.where(act, torch.minimum(first, stop - W), start)
    ok = ws & (scol <= (stop - W + 1)[:, None])  # window ending at e = s + 3 <= stop
    last = torch.where(ok.any(dim=1), (w - W) - ok.flip(1).int().argmax(dim=1), -w)
    act = start < stop - W
    stop = torch.where(act, torch.maximum(last + W - 1, start + W), stop)
    return start, stop, (stop - start) >= KSIZE


def _windows(codes: torch.Tensor, lens: torch.Tensor):
    """(valid window starts, their canonical keys) of a block's flat codes
    (invalid where not to be read); windows never cross records."""
    n = len(codes)
    dev = codes.device
    if n < KSIZE:
        return torch.zeros(0, dtype=torch.long, device=dev), torch.zeros(0, dtype=torch.long,
                                                                           device=dev)
    bad = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    bad[1:] = torch.cumsum(codes > 3, dim=0)
    rec_start = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    room = torch.repeat_interleave(lens, lens) - (torch.arange(n, device=dev) - rec_start)
    nw = n - KSIZE + 1
    valid = torch.nonzero(((bad[KSIZE:] - bad[:-KSIZE]) == 0) & (room[:nw] >= KSIZE)).view(-1)
    c = (codes & 3).long()
    k2 = (c[:-1] << 2) | c[1:]
    k4 = (k2[:-2] << 4) | k2[2:]
    k8 = (k4[:-4] << 8) | k4[4:]
    k16 = (k8[:-8] << 16) | k8[8:]
    fwd = (k16[valid] << 28) | (k8[valid + 16] << 12) | (k4[valid + 24] << 4) | k2[valid + 28]
    return valid, torch.minimum(fwd, revcomp(fwd))


@dataclass
class FileHits:
    start: np.ndarray  # int64 [n], kept range of each record
    stop: np.ndarray
    keep: np.ndarray  # bool [n]
    rec: np.ndarray  # int64 [h], record of each hit, in (record, window) order
    key: np.ndarray  # int64 [h]
    target: np.ndarray  # int32 [h]


def file_hits(seq, off, qual, probes: Probes, lut: np.ndarray) -> FileHits:
    """Every probe hit of one file's kept records (FASTQ: the trimmed
    range; FASTA: records longer than 30 bases, whole)."""
    dev = probes.device
    n = len(off) - 1
    per = max(1, BLOCK_CELLS // int(np.diff(off).max()))
    table = torch.from_numpy(lut).to(dev)
    parts = []
    for i0 in range(0, n, per):
        i1 = min(i0 + per, n)
        o = torch.from_numpy(off[i0 : i1 + 1] - off[i0]).to(dev)
        lens = o[1:] - o[:-1]
        if qual is not None:
            q = torch.from_numpy(qual[off[i0] : off[i1]]).to(dev)
            start, stop, keep = trim(q, o)
        else:
            start, stop, keep = torch.zeros_like(lens), lens - 1, lens > KSIZE
        codes = table[torch.from_numpy(seq[off[i0] : off[i1]]).to(dev).long()]
        pos = torch.arange(len(codes), device=dev) - torch.repeat_interleave(o[:-1], lens)
        out = ((pos < torch.repeat_interleave(start, lens))
               | (pos > torch.repeat_interleave(stop, lens))
               | ~torch.repeat_interleave(keep, lens))
        codes[out] = INVALID
        at, key = _windows(codes, lens)
        idx, tgt = probes.find(key)
        rec = torch.searchsorted(o[1:], at[idx], right=True) + i0
        parts.append([x.cpu().numpy() for x in (start, stop, keep, rec, key[idx], tgt)])
    cat = [np.concatenate(x) for x in zip(*parts)]
    return FileHits(cat[0].astype(np.int64), cat[1].astype(np.int64), cat[2], cat[3].astype(
        np.int64), cat[4], cat[5].astype(np.int32))


@dataclass
class Outputs:
    result: list  # "t,gcount,ucount" lines
    reads: str  # the saved reads' text ("" where none are saved)


def fold(tree: Tree, read: np.ndarray, target: np.ndarray, n_reads: int) -> np.ndarray:
    """Each read's final: its hits' targets folded by msca in order (0
    without hits).  ``read`` is nondecreasing."""
    final = np.zeros(n_reads, dtype=np.int64)
    if len(read) == 0:
        return final
    first = np.nonzero(np.concatenate([[True], read[1:] != read[:-1]]))[0]
    count = np.diff(np.concatenate([first, [len(read)]]))
    acc = target[first].astype(np.int64)
    for k in range(1, int(count.max())):
        m = count > k
        acc[m] = tree.msca(target[first[m] + k].astype(np.int64), acc[m])
    final[read[first]] = acc
    return final


def classify(files, probes: Probes, tree: Tree, num_targ: int, u_is_t: bool,
             savenum: int = 12, save_main: bool = True, dedup: str = "sample") -> Outputs:
    """One request's outputs.  ``files``: objects with ``seq``, ``off``,
    ``qual`` and ``acc(i)``, fed in order.  ``dedup`` is where a probe
    stops counting towards ucount: once per ``sample`` (the reference), or
    once per ``read`` (the control, see README.md)."""
    lut = code_table(u_is_t)
    hits = [file_hits(f.seq, f.off, f.qual, probes, lut) for f in files]
    base = np.cumsum([0] + [len(h.keep) for h in hits])  # first read of each file
    read = np.concatenate([h.rec + b for h, b in zip(hits, base)])
    key = np.concatenate([h.key for h in hits])
    target = np.concatenate([h.target for h in hits])
    keep = np.concatenate([h.keep for h in hits])
    final = fold(tree, read, target, len(keep))[keep]
    gcount = np.bincount(final, minlength=num_targ)[:num_targ]
    big = target > 1
    if dedup == "sample":
        _, first = np.unique(key[big], return_index=True)
    else:
        _, first = np.unique(np.stack([read[big], key[big]]), axis=1, return_index=True)
    ucount = np.bincount(target[big][first], minlength=num_targ)[:num_targ]
    result = [f"{i},{g},{u}" for i, (g, u) in enumerate(zip(gcount.tolist(), ucount.tolist()))]
    text = ""
    if save_main:
        kept = np.nonzero(keep)[0]  # global read ids of the processed reads
        cand = np.nonzero(final > 1)[0]
        order = np.argsort(final[cand], kind="stable")
        sf = final[cand][order]
        grp = np.concatenate([[0], np.nonzero(sf[1:] != sf[:-1])[0] + 1]) if len(sf) else sf
        start = np.zeros(len(sf), dtype=np.int64)
        start[grp] = grp
        np.maximum.accumulate(start, out=start)
        rank = np.empty(len(sf), dtype=np.int64)
        rank[order] = np.arange(len(sf)) - start
        saved = cand[rank < savenum]
        r = kept[saved]
        fi = np.searchsorted(base, r, side="right") - 1
        parts = []
        for j, r_, f_ in zip(saved.tolist(), r.tolist(), fi.tolist()):
            f, h, i = files[f_], hits[f_], r_ - int(base[f_])
            s = f.seq[f.off[i] + h.start[i] : f.off[i] + h.stop[i] + 1].tobytes().decode("latin-1")
            parts.append(f">{final[j]}:{f.acc(i)}\n{s}\n")
        text = "".join(parts)
    return Outputs(result, text)
