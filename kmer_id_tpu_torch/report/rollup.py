"""Report rollups with bit-identical CSV formatting.

Reimplements the four reference report scripts' arithmetic and string
formatting exactly (same float operations in the same order, same ``str()``
rendering), so outputs diff clean against the originals:

* :func:`readbatch_10`  ⇔ ``readbatch_10.py``  (bact10 directory rollup)
* :func:`readbatch_c3`  ⇔ ``readbatch_c3.py``  (chloroplast rollup, 7-col
  refkey with coverage factors)
* :func:`m3_report`     ⇔ the report half of ``kmer_read_m3.py`` (Galaxy
  mitokmer single-sample CSV)
* :func:`readc_report`  ⇔ the report half of ``kmer_readc.py`` (job rollup)

Parity quirks preserved (SURVEY.md §2.2): ``kmer_read_m3.py``'s count filter
compares a *string* to a float — inert under Python 2 ordering — so no count
filter is applied here either; the shipped CRLF ``mitochondria_refkey.txt``
makes ``nstrains`` parse as ``"0\\r"`` and the reference divides by zero —
faithful by default, with ``strip_cr=True`` as the usable escape hatch.

Copy of ``kmer_id_tpu/report/rollup.py``.
"""

from __future__ import annotations

import os
from typing import Sequence

# Default exclusion sets, readbatch_10.py:14-21.
DEFAULT_EXCLUDE_I = {
    4178, 1744, 2539, 5624, 1575, 5647, 323, 2728, 268, 5317, 297, 3867,
    314, 1344, 2947, 2935, 4213, 4976, 2767, 2763, 118, 3390, 1757,
}
DEFAULT_EXCLUDE_S = set(range(1928, 2339))


def _read_lines(path: str, keep_cr: bool = False) -> list[str]:
    """Read and split on '\\n' like the reference scripts.

    ``keep_cr=True`` mirrors the Python-2 scripts (kmer_read_m3.py,
    kmer_readc.py), whose text mode does not translate CRLF, so a '\\r'
    survives at line ends; the Python-3 scripts (readbatch_10/_c3) read with
    universal newlines and never see it.
    """
    with open(path, "r", newline="" if keep_cr else None) as f:
        data = f.read()
    return data.split("\n")


def readbatch_10(
    result_dir: str,
    refkey_path: str,
    out_path: str,
    mincount: float = 2.0,
    minuniq: float = 3.0,
    maxrat: float = 80000.0,
    exclude: set[int] | None = None,
    ext1: str = "_result.txt",
) -> None:
    """bact10 rollup (``readbatch_10.py``): counts + %-abundance CSV."""
    exclude_b = (
        (DEFAULT_EXCLUDE_I | DEFAULT_EXCLUDE_S) if exclude is None else exclude
    )
    count_list: list[float] = []
    name_list: list[str] = []
    in_use: list[int] = []
    lines = _read_lines(refkey_path)
    lines.pop(0)  # header
    for line in lines:
        if len(line) > 1:
            target, name, count, use = line.split("\t")
            if int(target) in exclude_b:
                use = "0"
            in_use.append(int(use))
            if use == "1":
                count_list.append(float(count) + 10.0)  # readbatch_10.py:42
                name_list.append(name)
    num_targs = len(name_list)

    resultfiles = [
        f
        for f in os.listdir(result_dir)
        if os.path.isfile(os.path.join(result_dir, f)) and f.endswith(ext1)
    ]
    num_cols = len(resultfiles)
    noid_list: list[int] = []
    read_ct: list[float] = []
    file_list: list[str] = []
    m = [[0 for _ in range(num_cols)] for _ in range(num_targs)]
    col = 0
    for f in resultfiles:
        fname = os.path.join(result_dir, f)
        pos = f.find(ext1)
        if pos > -1:
            f = f[:pos]
        file_list.append(f)
        read_ct.append(0.0)
        index = 0
        for line in _read_lines(fname):
            if len(line) > 1:
                row = line.split(",")
                target = int(row[0])
                count = float(row[1])
                uniq = float(row[2]) if len(row) > 2 else count
                count2 = count
                if count2 < mincount or uniq < minuniq or (count2 / uniq > maxrat):
                    count2 = 0.0
                read_ct[col] += count
                if target > 0:
                    if in_use[target] == 1:
                        m[index][col] = count2
                        index += 1
                else:
                    noid_list.append(int(count))
        col += 1

    rowmax = [0 for _ in range(num_targs)]
    b = [[0 for _ in range(num_cols)] for _ in range(num_targs)]
    sums = [0 for _ in range(num_cols)]
    for col in range(num_cols):
        sums[col] = 0
        for row in range(num_targs):
            b[row][col] = m[row][col] / count_list[row]
            sums[col] += b[row][col]
        if sums[col] < 0.00000009:
            sums[col] = 0.0000001
        for row in range(num_targs):
            b[row][col] = b[row][col] * 100.0 / sums[col]
            rowmax[row] = max(rowmax[row], b[row][col])

    order_col = sorted(range(num_cols), key=lambda k: file_list[k])
    with open(out_path, "w") as out:
        out.write("name," + "".join(file_list[order_col[i]] + ",," for i in range(num_cols)) + "\n")
        out.write("total," + "".join(str(read_ct[order_col[i]]) + ",," for i in range(num_cols)) + "\n")
        out.write("no_id," + "".join(str(noid_list[order_col[i]]) + ",," for i in range(num_cols)) + "\n")
        for i in range(num_targs):
            if rowmax[i] > 0.000:
                output = name_list[i]
                for j in range(num_cols):
                    k = order_col[j]
                    output += "," + str(m[i][k]) + "," + str(b[i][k])
                out.write(output + "\n")


def _parse_7col_refkey(lines, mincount_filter: bool, min_ranks: int, exclude_b):
    """Shared 7-col refkey scan (readbatch_c3.py:28-47 / kmer_read_m3.py:50-67).

    ``mincount_filter=False`` reproduces kmer_read_m3.py's inert
    string-vs-float count comparison.
    """
    factor_list: list[float] = []
    name_list: list[str] = []
    in_use: list[int] = []
    for line in lines:
        if len(line) > 1:
            target, name, count, hit, tested, gsize, nstrains = line.split("\t")
            row = name.split("_")
            target = int(target)
            hit = float(hit)
            if nstrains != "0":
                gensize = float(gsize) / float(nstrains)
            else:
                gensize = 1.0
            tested = float(tested)
            use = "1"
            bad_count = mincount_filter and float(count) < 10.0
            if target in exclude_b or bad_count or hit < 10.0 or len(row) < min_ranks:
                use = "0"
            in_use.append(int(use))
            if use == "1":
                name_list.append(name)
                factor_list.append(tested / hit / gensize)
    return factor_list, name_list, in_use


def m3_report(
    result_path: str,
    refkey_path: str,
    out_path: str,
    strip_cr: bool = False,
) -> None:
    """Mitokmer single-sample CSV (report half of ``kmer_read_m3.py``)."""
    lines = _read_lines(refkey_path, keep_cr=True)
    if strip_cr:
        lines = [ln.rstrip("\r") for ln in lines]
    lines.pop(0)
    factor_list, name_list, in_use = _parse_7col_refkey(
        lines, mincount_filter=False, min_ranks=5, exclude_b=set()
    )
    num_targs = len(name_list)

    noid_list: list[int] = []
    m = [0.0 for _ in range(num_targs)]
    read_ct = 0.0
    index = 0
    for line in _read_lines(result_path, keep_cr=True):
        if len(line) > 1:
            t_s, count, uniq = line.split(",")
            target = int(t_s)
            read_ct += float(count)
            if target > 0:
                if in_use[target]:
                    m[index] = float(count)
                    index += 1
            else:
                noid_list.append(int(count))

    total = 0.0
    b = []
    for i in range(num_targs):
        b1 = m[i] * factor_list[i]
        total += b1
        b.append(b1)
    total /= 100.0
    for i in range(num_targs):
        b[i] /= total
    with open(out_path, "w") as out:
        out.write("taxid,reads,abundance\n")
        out.write("total," + str(read_ct) + ",," + "\n")
        out.write("no_id," + str(noid_list[0]) + ",," + "\n")
        for i in range(num_targs):
            if m[i] > 0:
                out.write(
                    name_list[i] + "," + "{0:.0f}".format(m[i]) + ","
                    + "{0:.3f}".format(b[i]) + "\n"
                )


def readbatch_c3(
    result_dir: str,
    refkey_path: str,
    out_path: str,
    mincount: float = 2.0,
    minuniq: float = 2.0,
    maxrat: float = 80.0,
    exclude: set[int] | None = None,
) -> None:
    """Chloroplast rollup (``readbatch_c3.py``), numpy arithmetic preserved."""
    import numpy as np

    lines = _read_lines(refkey_path)
    lines.pop(0)
    factor_list, name_list, in_use = _parse_7col_refkey(
        lines, mincount_filter=True, min_ranks=6, exclude_b=exclude or set()
    )
    factor_arr = np.array(factor_list)
    num_targs = len(name_list)

    onlyfiles = [
        f
        for f in os.listdir(result_dir)
        if os.path.isfile(os.path.join(result_dir, f)) and f[-11:] == "_result.txt"
    ]
    num_cols = len(onlyfiles)
    noid_list: list[int] = []
    read_ct: list[float] = []
    file_list: list[str] = []
    m = np.zeros((num_targs, num_cols))
    u = np.zeros((num_targs, num_cols))
    col = 0
    for f in onlyfiles:
        fname = result_dir + "/" + f
        file_list.append(f[:-11])
        read_ct.append(0.0)
        index = 0
        for line in _read_lines(fname):
            if len(line) > 1:
                row = line.split(",")
                target = int(row[0])
                count = float(row[1])
                uniq = float(row[2])
                count2 = count
                if count2 < mincount or uniq < minuniq or (count2 / uniq > maxrat):
                    count2 = 0.0
                read_ct[col] += float(count)
                if target > 0:
                    if in_use[target] == 1:
                        m[index, col] = float(count2)
                        u[index, col] = uniq
                        index += 1
                else:
                    noid_list.append(int(count))
        col += 1

    b = m * factor_arr[:, None]
    sums = np.sum(b, axis=0)
    for col in range(num_cols):
        if sums[col] < 0.00000009:
            sums[col] = 0.0000001
    b = b / sums[None, :]
    b = b * 100.0
    order_col = sorted(range(num_cols), key=lambda k: file_list[k])
    rowmax = b.max(axis=1) if num_cols else np.zeros(num_targs)
    with open(out_path, "w") as out:
        out.write("name," + "".join(file_list[order_col[i]] + ",," for i in range(num_cols)) + "\n")
        out.write("total," + "".join(str(read_ct[order_col[i]]) + ",," for i in range(num_cols)) + "\n")
        out.write("no_id," + "".join(str(noid_list[order_col[i]]) + ",," for i in range(num_cols)) + "\n")
        for i in range(num_targs):
            if rowmax[i] > 0.000:
                output = name_list[i]
                for j in range(num_cols):
                    k = order_col[j]
                    output += "," + str(m[i, k]) + "," + str(b[i, k])
                out.write(output + "\n")


def readc_report(
    jobs_dir: str,
    jobs_name: str,
    key_path: str,
    count_path: str,
    out_path: str,
) -> None:
    """Chloroplast job rollup (report half of ``kmer_readc.py``)."""
    import numpy as np

    name_dict: dict[str, str] = {}
    for line in _read_lines(key_path, keep_cr=True):
        if len(line) > 1:
            target, name = line.split("\t")
            name_dict[target] = name

    job_list: list[str] = []
    skip = 0
    for line in _read_lines(os.path.join(jobs_dir, jobs_name + ".txt"), keep_cr=True):
        if len(line) > 1:
            if skip == 0:
                jname, skip_s = line.split()
                job_list.append(jname)
                skip = int(skip_s)
            else:
                skip -= 1

    count_list: list[float] = []
    name_list: list[str] = []
    in_use: list[bool] = []
    for line in _read_lines(count_path, keep_cr=True):
        if len(line) > 1:
            target, count = line.split(",")
            use = int(count) > 35  # kmer_readc.py:58
            in_use.append(use)
            if use:
                name_list.append(name_dict[target])
                count_list.append(float(count) + 10.0)
    count_arr = np.array(count_list)
    num_targs = len(name_list)

    num_cols = len(job_list)
    read_ct: list[float] = []
    noid_list: list[int] = []
    m = np.zeros((num_targs, num_cols))
    u = [0 for _ in range(num_targs)]
    col = 0
    for f in job_list:
        fname = os.path.join(jobs_dir, f + "_result.txt")
        read_ct.append(0.0)
        index = 0
        for line in _read_lines(fname, keep_cr=True):
            if len(line) > 1:
                t_s, count, uniq = line.split(",")
                target = int(t_s)
                read_ct[col] += float(count)
                if target > 0:
                    if in_use[target]:
                        m[index, col] = float(count)
                        u[index] = uniq
                        index += 1
                else:
                    noid_list.append(int(count))
        col += 1

    b = m / count_arr[:, None]
    sums = np.sum(b, axis=0)
    for i in range(len(sums)):
        if sums[i] < 0.000001:
            sums[i] = 0.000001
    b = b / sums[None, :]
    b = b * 100.0
    order_col = sorted(range(num_cols), key=lambda k: job_list[k])
    rowmax = b.max(axis=1) if num_cols else np.zeros(num_targs)
    with open(out_path, "w") as out:
        out.write("name," + "".join(job_list[order_col[i]] + ",,," for i in range(num_cols)) + "\n")
        out.write("total," + "".join(str(read_ct[order_col[i]]) + ",,," for i in range(num_cols)) + "\n")
        out.write("no_id," + "".join(str(noid_list[order_col[i]]) + ",,," for i in range(num_cols)) + "\n")
        for i in range(num_targs):
            if rowmax[i] > 0.000:
                output = name_list[i]
                for j in range(num_cols):
                    k = order_col[j]
                    output += "," + str(m[i, k]) + "," + str(u[i]) + "," + str(b[i, k])
                out.write(output + "\n")
