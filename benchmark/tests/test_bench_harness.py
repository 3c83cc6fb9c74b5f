"""The harness: its last line, its import check, and that its check finds
the control and each fault of the timed path that a cell can have."""

import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import cell, control, run, spec
from benchmark.tests import toy
from benchmark.tests.toy import CELLS, overrides

ROOT = spec.ROOT


def _cli(name: str, trace: int, extra: str = ""):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {extra}\n"
            "from benchmark import run\n"
            "from benchmark.tests.toy import overrides\n"
            f"sys.exit(run.main(['--workload', {name!r}, '--seed', '4294967311', '--seconds', "
            f"'0.3', '--trace', '{trace}'], device='cpu', overrides=overrides({name!r})))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_keys(trace):
    p = _cli("bact10.deep", trace)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "submit_ms_per_batch" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"reads_per_s", "setup_s"}
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k} {v['value']} limit {v['limit']}"
                    for k, v in line["checks"].items()]


def test_refused_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmer_id_tpu_torch.x", types.ModuleType("kmer_id_tpu_torch.x"))
    assert "kmer_id_tpu_torch.x" not in run.refused_modules(sys.modules)
    monkeypatch.setitem(sys.modules, "kmer_id_tpu.x", types.ModuleType("kmer_id_tpu.x"))
    assert "kmer_id_tpu.x" in run.refused_modules(sys.modules)
    assert run.refused_modules(["jax", "jaxlib.xla", "kmer_id_tpu_torchx", "benchmark"]) == [
        "jax", "jaxlib.xla"]


def test_a_refused_module_fails_the_run():
    p = _cli("bact10.deep", 0, "import types; sys.modules['kmer_id_tpu.x'] = "
             "types.ModuleType('kmer_id_tpu.x')")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "kmer_id_tpu.x" in p.stderr


def test_no_card_no_result():
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\nimport torch\n"
            "torch.cuda.is_available = lambda: False\nfrom benchmark import run\n"
            "sys.exit(run.main(['--workload', 'bact10.deep', '--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    c = toy.cell(name)
    for seed in (1, 2, 3):
        got = control.control_numbers(c, seed, str(tmp_path))
        assert got["failed"] > 0 and got["numbers"]["result_lines_off"] > 0


def _unchanged_state(monkeypatch):
    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor

    def account_batch(self, finals, metas):  # reads counted, gcount left as it was
        self.reads += len(finals)

    def account(self, final, meta, metas=None, i=-1):
        self.reads += 1
    monkeypatch.setattr(SampleProcessor, "_account_batch", account_batch)
    monkeypatch.setattr(SampleProcessor, "_account", account)


def _half_batch(monkeypatch):
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier

    orig = FpClassifier.submit_batch

    def submit_batch(self, seen, batch):  # the second half of the rows left out
        lens = np.array(batch.lengths, copy=True)
        lens[batch.n_rows // 2 : batch.n_rows] = 0
        return orig(self, seen, dataclasses.replace(batch, lengths=lens))
    monkeypatch.setattr(FpClassifier, "submit_batch", submit_batch)


def _altered_answer(monkeypatch):
    from kmer_id_tpu_torch.engine.fpclassify import FpClassifier

    orig = FpClassifier._finish_collect

    def finish_collect(self, seen, arr, pending):  # one read's final changed where made
        seen, finals = orig(self, seen, arr, pending)
        hit = np.nonzero(finals > 1)[0]
        if len(hit):
            finals[hit[0]] = 1
        return seen, finals
    monkeypatch.setattr(FpClassifier, "_finish_collect", finish_collect)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("name", ["bact10.deep", "mito.reads"])
def test_faults_are_not_correct(fault, name, monkeypatch):
    """Each fault the cells can have, planted under the timed path; the
    exchange between chips has no cell to break (every cell is on one)."""
    c = toy.cell(name)
    fault(monkeypatch)
    _, _, (numbers, failed, attempted) = cell.run(c, 77, 0.3, False, "cpu", time.perf_counter())
    assert attempted >= 1 and failed > 0 and numbers["result_lines_off"] > 0


@pytest.mark.cuda
def test_toy_cell_on_the_card(cuda_card, capsys):
    rc = run.main(["--workload", "bact10.deep", "--seed", "5", "--seconds", "1"],
                  overrides=overrides("bact10.deep"))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_every_metric_has_a_reader():
    """Each metric of BENCHMARK.json finds its reader by name (a name with a
    ``.<suffix>`` may share the reader of the name without it)."""
    with open(f"{ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]
    assert spec.reader("device_idle_pct.contigs").__module__ == "kbench_metric_device_idle_pct"
