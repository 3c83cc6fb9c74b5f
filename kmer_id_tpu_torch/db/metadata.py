"""Loaders for the reference's side-car metadata files.

* ``*data.txt`` — one ``target accession`` pair per line; org index = line
  order (``newkmer_10nx.cpp:951-971``).  The vf6/m3 loaders skip lines of
  length <= 1 and tolerate CR (``kmer_read_vf6.cpp:1059-1089``).
* ``*tree.txt`` — ``parent child`` int pairs (``newkmer_10nx.cpp:973-984``).

Copy of ``kmer_id_tpu/db/metadata.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StrainList:
    accession: list[str]
    targno: np.ndarray  # int32 [num_orgs]
    num_targ: int  # max target id + 1
    ntargorgs: np.ndarray = field(default=None)  # direct org count per target

    @property
    def num_orgs(self) -> int:
        return len(self.accession)


def load_data_txt(path) -> StrainList:
    """Parse a ``*data.txt`` strain list.

    ``ntargorgs[t]`` counts orgs *directly* labeled ``t`` — reproducing the
    reference-builder quirk where the parent walk runs before tree edges load
    so every parent is still the root (``kmer_build_vf6.cpp:724-732``); the
    nx classifier computes the same direct counts (``newkmer_10nx.cpp:961``).
    """
    accession: list[str] = []
    targno: list[int] = []
    with open(path, "r", newline="") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if len(line) <= 1:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            targno.append(int(parts[0]))
            accession.append(parts[1])
    targno_arr = np.asarray(targno, dtype=np.int32)
    num_targ = int(targno_arr.max(initial=0)) + 1
    ntargorgs = np.zeros(num_targ, dtype=np.int32)
    for t in targno:
        if t > 0:
            ntargorgs[t] += 1
    return StrainList(accession, targno_arr, num_targ, ntargorgs)


def load_tree_edges(path) -> list[tuple[int, int]]:
    edges = []
    with open(path, "r", newline="") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                edges.append((int(parts[0]), int(parts[1])))
    return edges
