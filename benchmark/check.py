"""The comparison that decides ``correct``: every request the run served
(the window's and, in a traced run, the profiled ones), its files against
the reference's outputs for its input, line by line.

The guarantee is exactness: ``_result.txt`` (per target: reads, unique
probes) and ``_reads.txt`` (the first 12 reads of each target in read
order) equal to the C++ reference's.  So each number compared has the limit
0: sound runs read 0, and the control (the reference with ucount counted
once per read, README.md) reads thousands."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

LIMITS = {"result_lines_off": 0, "saved_reads_off": 0}


def _off(got: list, want: list) -> int:
    """Entries that differ, position by position, plus the length gap."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def _records(text: str) -> list:
    lines = text.split("\n")
    return ["\n".join(lines[i : i + 2]) for i in range(0, len(lines) - 1, 2)]


def _read(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def compare(served, refs: dict, saves: bool) -> tuple[dict, int]:
    """(numbers compared, requests that failed).  ``served``: objects with
    ``pool`` (the input's index) and ``out`` (the files' prefix); ``refs``:
    {pool index: reference Outputs}."""
    numbers = dict.fromkeys(LIMITS if saves else ["result_lines_off"], 0)
    failed = 0
    for s in served:
        want = refs[s.pool]
        got = _read(s.out + "_result.txt")
        off = {"result_lines_off": _off(got.splitlines() if got is not None else [],
                                         want.result)}
        if saves:
            got = _read(s.out + "_reads.txt")
            off["saved_reads_off"] = _off(_records(got) if got is not None else [],
                                          _records(want.reads)) + (got is None)
        for k, v in off.items():
            numbers[k] += v
        failed += any(off.values())
    return numbers, failed


def write_outputs(out: str, outputs, saves: bool) -> None:
    """Outputs as the drivers' files (the control, put in the program's
    place)."""
    with open(out + "_result.txt", "w") as f:
        f.write("".join(line + "\n" for line in outputs.result))
    if saves:
        with open(out + "_reads.txt", "w") as f:
            f.write(outputs.reads)


def reference_outputs(pool, used, db, u_is_t: bool, savenum: int, saves: bool,
                      dedup: str = "sample", device: str = "cpu", threads: int = 4) -> dict:
    """{pool index: Outputs} of the pool's requests in ``used``, several
    at once (their host parts overlap)."""
    from benchmark.reference.vector import Probes, Tree, classify

    probes = Probes(db.keys, db.targets, device)
    tree = Tree(db.parent)

    def one(i):
        return i, classify(pool[i].files, probes, tree, db.num_targ, u_is_t, savenum,
                           save_main=saves, dedup=dedup)

    with ThreadPoolExecutor(max(1, min(threads, len(used)))) as ex:
        return dict(ex.map(one, sorted(used)))
