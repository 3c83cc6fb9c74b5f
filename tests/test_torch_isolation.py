"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

* An AST scan of every module of ``kmer_id_tpu_torch/`` and of
  ``chip_smoke.py``: no ``import`` of ``jax``, ``jaxlib`` or ``kmer_id_tpu``
  anywhere in the file, imports inside functions included.
* One subprocess with a ``sys.meta_path`` finder that refuses those names
  runs every subcommand of the port's CLI on the CPU against a tiny DB made
  here with the port's own host modules: the five classify subcommands
  (``classify-nx``, ``classify-jobs``, ``classify-m3``, ``mitokmer``,
  ``readc``) with each engine, ``classify-m3 --profile``, ``pack-db``,
  ``report-b10``, ``report-c3`` and ``build-db`` in RAM and with
  ``--spill``; each must exit 0, write its files and leave no blocked
  module in ``sys.modules``.
"""

import ast
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from kmer_id_tpu_torch.core import codec
from kmer_id_tpu_torch.db.probes import ProbeRecords, write_probes_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "kmer_id_tpu")
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(ROOT, "kmer_id_tpu_torch"))
    for f in files if f.endswith(".py")
) + ["chip_smoke.py"]
NUM_TARG = 12
ENGINE = ["--batch-size", "32", "--max-len", "128", "--device", "cpu"]


def blocked_imports(source: str) -> list[str]:
    """Names of the blocked packages that ``source`` imports, at any depth
    of the syntax tree (top level, functions, branches)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in BLOCKED]
    return found


def test_scan_finds_lazy_and_nested_imports():
    src = ("import os\nimport kmer_id_tpu_torch.ops\n"
           "def f():\n    if True:\n        from kmer_id_tpu.core import codec\n"
           "class C:\n    def g(self):\n        import jax.numpy as jnp, jaxlib\n")
    assert blocked_imports(src) == ["kmer_id_tpu.core", "jax.numpy", "jaxlib"]


@pytest.mark.parametrize("path", SOURCES)
def test_module_imports_no_jax_and_no_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        assert blocked_imports(f.read()) == [], path


def test_scan_covers_the_package():
    assert len(SOURCES) >= 30 and "kmer_id_tpu_torch/ops/gate.py" in SOURCES


# ------------------------------------------------- the CLI under a blocker

_RUN = """
import importlib.abc, json, sys

BLOCKED = {blocked!r}


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("import of " + name + " refused")
        return None


sys.meta_path.insert(0, _Refuse())
from kmer_id_tpu_torch import cli

rcs = {{}}
for label, argv in json.loads(sys.argv[1]):
    rcs[label] = cli.main(argv)
print(json.dumps({{"rcs": rcs, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


def _write_db(d, names, keys, targets, parent):
    """The data, tree and gzipped probe files ``names`` in ``d``."""
    data, tree, probes = names
    d.mkdir(parents=True, exist_ok=True)
    (d / data).write_text("".join(f"{t}\tACC{t}\n" for t in range(2, NUM_TARG)))
    (d / tree).write_text("".join(f"{parent[t]}\t{t}\n" for t in range(2, NUM_TARG)))
    n = len(keys)
    txt = d / "probes.tmp"
    write_probes_text(ProbeRecords(keys=keys, target=targets, org=np.zeros(n, np.int32),
                                   position=np.zeros(n, np.int32), fstrand=np.ones(n, bool),
                                   count=np.ones(n, np.int32)), str(txt))
    with open(txt, "rb") as f, gzip.open(d / probes, "wb") as g:
        g.write(f.read())
    txt.unlink()


@pytest.fixture(scope="module")
def blocked_run(tmp_path_factory):
    """(exit codes and blocked modules of the subprocess, {subcommand:
    files it must have written})."""
    r = np.random.default_rng(31)
    root = tmp_path_factory.mktemp("isolation")
    parent = [1] * NUM_TARG
    for i in range(3, NUM_TARG):
        parent[i] = int(r.integers(1, i))
    genome = r.integers(0, 4, size=600).astype(np.uint8)
    keys = np.unique(codec.canonical_kmers(genome)[0])
    targets = r.integers(2, NUM_TARG, size=len(keys)).astype(np.int32)
    gstr = "".join("ACGT"[i] for i in genome)

    def seq(n):
        s = list("".join("ACGT"[i] for i in r.integers(0, 4, size=n)))
        for _ in range(int(r.integers(0, 3))):
            p, g = int(r.integers(0, n - 30)), int(r.integers(0, len(gstr) - 30))
            s[p : p + 30] = gstr[g : g + 30]
        return "".join(s)

    reads = "".join(f"@r{i}\n{seq(100)}\n+\n{'J' * 100}\n" for i in range(40))
    fq = root / "fq"
    fq.mkdir()
    for mate in ("R1", "R2"):
        with gzip.open(fq / f"s_{mate}_tr.fastq.gz", "wt") as f:
            f.write(reads)
    fasta = root / "contigs.fasta"
    fasta.write_text("".join(f">c{i}\n{seq(n)}\n" for i, n in enumerate((80, 400, 1500))))

    db = (keys, targets, parent)
    _write_db(root / "nxdb", ("bData10.txt", "btree_10.txt", "probes10.txt.gz"), *db)
    _write_db(root / "db", ("db_data.txt", "db_tree.txt", "db_probes.txt.gz"), *db)
    (root / "db" / "db_key.txt").write_text("".join(f"{t}\tname{t}\n" for t in range(NUM_TARG)))
    (root / "db" / "db_count.txt").write_text(
        "".join(f"{t},{int(r.integers(20, 200))}\n" for t in range(NUM_TARG)))
    mito = root / "mito"
    _write_db(mito, [f"mitochondria_{n}" for n in ("data.txt", "tree.txt", "probes.txt.gz")],
              *db)
    (mito / "mitochondria_refkey.txt").write_text(
        "target\tname\tcount\thit\ttested\tgsize\tnstrains\n" + "".join(
            f"{t}\tk_p_c_o_f_g_s{t}\t{t + 5}\t{20 + t}\t{100 + 3 * t}\t{1000 + t}\t1\n"
            for t in range(NUM_TARG)))
    for job in ("j", "rj", "j_legacy", "rj_legacy"):
        (root / job).mkdir()
        (root / job / f"{job}.txt").write_text(f"a 2\n{fq / 's_R1_tr.fastq.gz'}\n{fasta}\n")
    fq_legacy, mito_legacy = root / "fq_legacy", root / "mito_legacy"
    shutil.copytree(fq, fq_legacy)
    shutil.copytree(mito, mito_legacy)
    (root / "refkey10.txt").write_text("target\tname\tcount\tuse\n" + "".join(
        f"{t}\tname{t}\t{t + 10}\t1\n" for t in range(NUM_TARG)))
    fa = root / "fa"  # build-db: three genomes sharing a block, one outgroup
    fa.mkdir()
    shared, outg = seq(300), seq(200)
    for acc, body in (("g1", seq(800) + shared + outg), ("g2", shared + seq(700)),
                      ("g3", seq(900)), ("gout", seq(100) + outg)):
        with gzip.open(fa / f"{acc}.fasta.gz", "wt") as f:
            f.write(f">{acc}\n{body}\n")
    for bd in ("bd", "bds"):
        (root / bd).mkdir()
        (root / bd / f"{bd}_data.txt").write_text("3\tg1\n4\tg2\n6\tg3\n")
        (root / bd / f"{bd}_tree.txt").write_text("1\t2\n2\t3\n2\t4\n1\t5\n5\t6\n")
        (root / bd / f"{bd}_filter.txt").write_text("gout\n")

    def classify(legacy):
        sfx, eng = ("_legacy", ["--engine", "legacy"]) if legacy else ("", [])
        m = mito_legacy if legacy else mito
        return [
            (f"classify-nx{sfx}", ["classify-nx", str(fq_legacy if legacy else fq), "--db-dir",
                                   str(root / "nxdb"), "--num-targ", str(NUM_TARG)]),
            (f"classify-jobs{sfx}", ["classify-jobs", "-name", "db", "-jname", f"j{sfx}",
                                     "--root", str(root)]),
            (f"classify-m3{sfx}", ["classify-m3", "-wdir", str(m), "-f1", str(fasta),
                                   "-f2", "none"]),
            (f"mitokmer{sfx}", ["mitokmer", "-w", str(m), "-d", str(root / f"mk{sfx}"), "-i",
                                str(fasta), "none"]),
            (f"readc{sfx}", ["readc", "--jobs-name", f"rj{sfx}", "--folder", "db", "--root",
                             str(root)]),
        ], eng

    runs = []
    for legacy in (False, True):
        argvs, eng = classify(legacy)
        runs += [(label, argv + ENGINE + eng) for label, argv in argvs]
    runs += [
        ("classify-m3 --profile", ["classify-m3", "-wdir", str(mito), "-f1", str(fasta),
                                   "--profile", str(root / "trace")] + ENGINE),
        ("pack-db", ["pack-db", str(root / "db" / "db_probes.txt.gz"), str(root / "packed"),
                     "--num-targ", str(NUM_TARG)]),
        ("report-b10", ["report-b10", str(fq), str(root / "refkey10.txt"),
                        str(root / "b10.csv")]),
        ("report-c3", ["report-c3", str(fq), str(mito / "mitochondria_refkey.txt"),
                       str(root / "c3.csv")]),
        ("build-db", ["build-db", "-name", "bd", "-fadir", str(fa), "--root", str(root)]),
        ("build-db --spill", ["build-db", "-name", "bds", "-fadir", str(fa), "--root", str(root),
                              "--spill"]),
    ]
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(blocked=BLOCKED), json.dumps(runs)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    files = {}
    for legacy in (False, True):
        sfx = "_legacy" if legacy else ""
        m, d = (mito_legacy, fq_legacy) if legacy else (mito, fq)
        files.update({
            f"classify-nx{sfx}": [d / "s_result.txt", d / "s_reads.txt"],
            f"classify-jobs{sfx}": [root / f"j{sfx}" / "a_result.txt",
                                    root / f"j{sfx}" / "a_reads.txt"],
            f"classify-m3{sfx}": [m / "result.txt"],
            f"mitokmer{sfx}": [root / f"mk{sfx}" / "mitokmer_result.csv"],
            f"readc{sfx}": [root / f"rj{sfx}" / "a_result.txt", root / f"rj{sfx}" / f"rj{sfx}.csv"],
        })
    files.update({
        "classify-m3 --profile": [m / "result.txt" for m in (mito,)] + [
            p for p in (root / "trace").glob("*.json")],
        "pack-db": [root / "packed" / n for n in ("manifest.json", "cuckoo.npy", "keys.npy")],
        "report-b10": [root / "b10.csv"],
        "report-c3": [root / "c3.csv"],
        "build-db": [root / "bd" / f"bd_{k}.txt" for k in ("probes", "count")],
        "build-db --spill": [root / "bds" / f"bds_{k}.txt" for k in ("probes", "count")],
    })
    return json.loads(out.stdout.strip().splitlines()[-1]), files


CLASSIFY = ["classify-nx", "classify-jobs", "classify-m3", "mitokmer", "readc"]


@pytest.mark.parametrize("cmd", CLASSIFY + [c + "_legacy" for c in CLASSIFY] + [
    "classify-m3 --profile", "pack-db", "report-b10", "report-c3", "build-db",
    "build-db --spill"])
def test_subcommand_runs_with_jax_and_jax_package_refused(blocked_run, cmd):
    result, files = blocked_run
    assert result["rcs"][cmd] == 0
    assert result["loaded"] == []
    assert files[cmd]
    for p in files[cmd]:
        assert p.exists() and p.stat().st_size > 0, p
