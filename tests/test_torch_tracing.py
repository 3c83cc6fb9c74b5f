"""The port's tracing (``kmer_id_tpu_torch/utils/timing.py``) on the CPU: the
spans and counters of the sample loop, on the drivers tests' small world.

* Off (the default, no profiler): nothing is kept, ``recent()`` stays
  empty and no ``record_function`` is entered.
* With the switch on: every span on its thread (the decoder's on the
  files' feed threads), the counters against what the feeders emitted and
  the group rule, each submit and collect span under a batch id the
  decoder packed, the kernel-build span.
* Under ``torch.profiler`` without the switch: the sample is traced and the
  ``kmerid::`` ranges are among the profile's events; ``--profile`` writes
  them into its Chrome trace.
* The output files are byte-identical with tracing on and off; ``recent()``
  keeps at most its bound; the benchmark's readers of the spans and
  counters, the native reader's read-ahead counters among them.
"""

import io
import json
import os
import threading
import time

import pytest
import torch

from kmer_id_tpu_torch.utils import timing
from tests.test_torch_drivers import NUM_TARG, world  # noqa: F401  (the fixture)

CALLING = {"sample.start", "feed.join", "sample.finish", "sample.write"}
FEED = {"decode.fill", "decode.pack", "feed.wait"}  # each file's kmer-feed thread
SUBMITTER = {"submit", "submit.wait"}
COLLECTOR = {"collect", "collect.fetch", "collect.replay", "collect.lane", "collect.account"}
METRICS = ["decode_fill_ms_per_batch", "decode_pack_ms_per_batch",
           "decode_offcpu_ms_per_batch", "feed_wait_ms_per_batch", "submit_wait_ms_per_batch",
           "submit_sync_ms_per_batch", "collect_fetch_ms_per_batch",
           "collect_lane_ms_per_batch", "fetches_per_batch", "sample_overhead_ms",
           "decode_inflate_wait_ms_per_batch"]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with the switch off and no summaries kept."""
    prev = timing.set_tracing(False)
    timing._recent.clear()
    yield
    timing.set_tracing(prev)
    timing._recent.clear()


@pytest.fixture(scope="module")
def engines(world):  # noqa: F811
    """The fingerprint engine on the world's DB, one per (batch size, max
    length): ``engines(b, l)``."""
    from kmer_id_tpu_torch.engine.pipeline import load_db, make_classifier

    d = world["root"] / "db"
    db = load_db(*[str(d / f"db_{n}") for n in ("data.txt", "tree.txt", "probes.txt.gz")],
                 num_targ=NUM_TARG)
    made = {}

    def get(batch_size=8, max_len=512):
        if (batch_size, max_len) not in made:
            made[batch_size, max_len] = make_classifier(
                db, _cfg(batch_size=batch_size, max_len=max_len), device="cpu")
        return made[batch_size, max_len]

    return get


class Slow:
    """Engine proxy whose submits and collects sleep, so both queues fill:
    the calling thread waits on the submitter and the submitter on the
    collector."""

    def __init__(self, eng, submit_s=0.002, collect_s=0.03):
        self._eng, self._s, self._c = eng, submit_s, collect_s

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def submit_batch(self, seen, batch):
        time.sleep(self._s)
        return self._eng.submit_batch(seen, batch)

    def collect(self, seen, pending):
        time.sleep(self._c)
        return self._eng.collect(seen, pending)

    def collect_many(self, seen, pendings):
        time.sleep(self._c)
        return self._eng.collect_many(seen, pendings)


def _cfg(**kw):
    from kmer_id_tpu_torch.config import ClassifyConfig

    base = dict(num_targ=NUM_TARG, batch_size=8, max_len=512)
    base.update(kw)
    return ClassifyConfig.preset("vf6", **base)


def _sample(world, eng, files=("short.fastq.gz", "contigs.fasta"), out=None,  # noqa: F811
            target_out=None):
    """One sample through SampleProcessor on the native feed; with ``out``,
    its ``_result.txt`` and ``_reads.txt`` written there; with
    ``target_out``, target 2's reads saved there (so its files go one at a
    time).  Returns (processor, result)."""
    from kmer_id_tpu_torch.engine.pipeline import SampleProcessor, write_result

    reads_out = open(f"{out}_reads.txt", "w") if out else io.StringIO()
    kw = {} if target_out is None else {"save_target": 2}
    try:
        sp = SampleProcessor(eng, _cfg(batch_size=eng.batch_size, max_len=eng.max_len, **kw),
                             reads_out=reads_out, target_reads_out=target_out,
                             use_native=True)
        assert sp.native and sp.collect_group == 4
        for name in files:
            sp.feed_file(str(world["reads"] / name))
        res = sp.finish()
    finally:
        reads_out.close()
    write_result(f"{out}_result.txt" if out else os.devnull, res)
    return sp, res


class _Counting:
    """Stands in for the profiler's ranges (``record_function`` and the
    function-scope record), counting the ranges entered."""

    entered = 0

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _count_ranges(monkeypatch):
    _Counting.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)


def _feeders(monkeypatch) -> list:
    """The native feeders the sample loop makes from now on."""
    from kmer_id_tpu_torch.engine import pipeline

    made, cls = [], pipeline.NativePlaneFeeder

    def make(*a, **kw):
        made.append(cls(*a, **kw))
        return made[-1]

    monkeypatch.setattr(pipeline, "NativePlaneFeeder", make)
    return made


def test_off_keeps_nothing(world, engines, monkeypatch):  # noqa: F811
    _count_ranges(monkeypatch)
    feeders = _feeders(monkeypatch)
    sp, res = _sample(world, engines())
    assert sp.trace is None and res.trace is None and res.stage_s == {}
    assert len(feeders) == 2 and all(f.trace is None for f in feeders)
    assert timing.recent() == [] and timing.current() is None
    assert _Counting.entered == 0
    assert timing.span(None, "submit") is timing.span(None, "collect")  # one shared no-op


def test_spans_on_their_threads_and_counters(world, engines, monkeypatch):  # noqa: F811
    _count_ranges(monkeypatch)
    feeders = _feeders(monkeypatch)
    timing.set_tracing(True)
    sp, res = _sample(world, Slow(engines()))
    tr = sp.trace
    assert tr is not None and res.trace is tr and res.stage_s is tr.summary
    assert timing.recent() == [tr.summary] and timing.current() is None
    assert _Counting.entered == 0  # no profiler: no ranges
    threads: dict = {}
    for name, _, thread, t0, t1, cpu in tr.spans:
        threads.setdefault(name, set()).add(thread.split("_")[0])
        assert t1 >= t0
        assert (cpu is not None and cpu >= 0) if name in timing.CPU_SPANS else cpu is None
    # the engine's branches: ``sync`` on the submitter, the long lane's
    # ``collect.lane.sync`` on the collector
    assert set(threads) == (CALLING | FEED | SUBMITTER | COLLECTOR
                            | {"sync", "collect.lane.sync"})
    for name in CALLING:
        assert threads[name] == {threading.main_thread().name}, name
    for name in FEED:
        assert threads[name] == {"kmer-feed"}, name
    for name in ("submit", "sync"):
        assert threads[name] == {"kmer-submit"}, name
    # the collector's depth, waited for by the submitter and by finish's last
    # group, which holds a short batch where the files' batches end with one
    assert "kmer-submit" in threads["submit.wait"]
    assert threads["submit.wait"] <= {"kmer-submit", threading.main_thread().name}
    for name in COLLECTOR | {"collect.lane.sync"}:
        assert threads[name] == {"kmer-collect"}, name

    c = tr.counters
    assert c["batches"] == sum(f.emitted for f in feeders) and c["rows"] == res.reads
    assert 0 <= c["feed.overlap"] <= c["batches"]
    assert c["pack.plane"] == 0  # every batch shipped the fill's words
    # a batch with long rows closes the group where it finds one open: how
    # the two files' batches interleave decides (the group rule's own test)
    assert c.get("flush.long", 0) <= sum(1 for s in tr.spans if s[0] == "collect.lane")
    assert c["fetches"] == sum(1 for s in tr.spans if s[0] == "collect.fetch")
    summary = tr.summary
    assert summary["sample"] == tr.sample and summary["counters"] == c
    assert summary["spans"]["submit"]["count"] == c["batches"]
    for name, s in summary["spans"].items():
        assert s["wall_ns"] >= 0 and (s["cpu_ns"] >= 0 if name in timing.CPU_SPANS
                                      else "cpu_ns" not in s)

    # the files' feeders share one counter: every batch id is unique
    packed = [b for name, b, *_ in tr.spans if name == "decode.pack"]
    assert len(set(packed)) == len(packed) == c["batches"]
    assert {b for name, b, *_ in tr.spans if name == "submit"} == set(packed)
    for name, b, *_ in tr.spans:
        if name in ("submit", "collect", "collect.fetch", "collect.account"):
            assert b in packed, (name, b)


def test_inflate_counters(world, engines, monkeypatch):  # noqa: F811
    """The native reader's read-ahead counters: none in an untraced sample;
    in a traced one the blocks the fills took (each small file is one),
    how many of them they waited for and the microseconds waited, read by
    ``decode_inflate_wait_ms_per_batch``."""
    from benchmark import spec

    read = spec.reader("decode_inflate_wait_ms_per_batch")
    feeders = _feeders(monkeypatch)
    sp, res = _sample(world, engines())
    assert all(f.trace is None for f in feeders) and res.stage_s == {}
    assert timing.recent() == []
    assert read(None) is None
    timing.set_tracing(True)
    sp, res = _sample(world, engines())
    c = res.trace.counters
    assert c["inflate.blocks"] >= 2 and c["inflate.blocks"] >= c["inflate.waits"] >= 0
    assert c["inflate.wait_us"] >= 0
    assert read(None) == pytest.approx(c["inflate.wait_us"] / 1000 / c["batches"], rel=1e-12)


def test_kernel_build_span(monkeypatch):
    from kmer_id_tpu_torch.kernels import build

    monkeypatch.setattr(build, "_build_many", lambda names: {
        n: (f"lib{n}.so", {"seconds": 1.0 if n == "gate" else 0.0, "ptxas": ""}) for n in names})
    tr = timing.SampleTrace()
    with timing.using(tr):
        build.build_many(["gate", "probe"])
    assert [s[0] for s in tr.spans] == ["kernel.build"]
    assert tr.counters == {}
    assert build.build_many(["gate"])["gate"][0] == "libgate.so"  # no trace: no record


@pytest.mark.parametrize("files, one_at_a_time, want", [
    # 150 reads in batches of 17: 9 batches, groups of 4, 4 and the last
    # closed by finish: 3 fetches
    (("short.fastq.gz",), False, {"batches": 9, "fetches": 3, "flush.full": 2,
                                  "flush.finish": 1, "flush.long": 0}),
    # then contigs past max_len, the files one at a time (a target's reads
    # saved): the first batch with long rows closes the group of short
    # batches before it, and is fetched alone
    (("short.fastq.gz", "contigs.fasta"), True, {"batches": 11, "flush.full": 2,
                                                 "flush.long": 1}),
    # at once: in batches of 16, 10, and the 24 contigs in 2 of their own
    # file, each drained alone; how the two files' batches interleave, and
    # so which groups a drained batch closes early, is the threads' timing
    (("short.fastq.gz", "contigs.fasta"), False, {"batches": 12}),
])
def test_fetches_follow_the_group_rule(world, engines, files, one_at_a_time, want,  # noqa: F811
                                       monkeypatch):
    feeders = _feeders(monkeypatch)
    timing.set_tracing(True)
    sp, res = _sample(world, engines(16 + (len(files) == 1), 128), files=files,
                      target_out=io.StringIO() if one_at_a_time else None)
    assert sp._at_once != one_at_a_time
    c = sp.trace.counters
    assert {k: c.get(k, 0) for k in want} == want
    assert c["batches"] == sum(f.emitted for f in feeders) and c["rows"] == res.reads
    # one fetch per group closed, and one per batch drained with its long rows
    drained = sum(1 for s in sp.trace.spans if s[0] == "collect.lane")
    closed = sum(c.get(k, 0) for k in ("flush.full", "flush.long", "flush.finish"))
    assert c["fetches"] == closed + drained
    assert drained == 2 * (len(files) == 2)
    # the short batches in groups of at most 4, a group closed early only by
    # a drained batch or by finish
    assert c.get("flush.full", 0) <= 2 and c.get("flush.long", 0) <= drained
    assert c.get("flush.finish", 0) <= 1 and closed >= 3


def test_profiler_traces_without_the_switch(world, engines):  # noqa: F811
    from torch.profiler import ProfilerActivity, profile

    assert not timing.profiler_recording()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        assert timing.profiler_recording()
        sp, _ = _sample(world, engines())
    assert sp.trace is not None and len(timing.recent()) == 1
    ranges = [e for e in prof.events() if e.name.startswith("kmerid::")]
    # the calling thread's (the profiler records the thread that started it)
    assert {"kmerid::sample.start", "kmerid::feed.join",
            "kmerid::sample.finish"} <= {e.name for e in ranges}
    # host-side records only: nothing among the device's events
    assert {str(e.device_type) for e in ranges} == {"DeviceType.CPU"}
    assert {e.kwinputs["sample"] for e in ranges} == {sp.trace.sample}
    # where the calling thread decodes (files one at a time: a target's
    # reads saved), its ranges carry the batch ids too
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        sp, _ = _sample(world, engines(), target_out=io.StringIO())
    assert sp._feeder is not None
    packs = [e.kwinputs for e in prof.events() if e.name == "kmerid::decode.pack"]
    assert [k["sample"] for k in packs] == [sp.trace.sample] * len(packs)
    assert sorted(k["batch"] for k in packs) == list(range(len(packs)))
    # after the profile, samples are untraced again
    sp, _ = _sample(world, engines(), files=("short.fastq.gz",))
    assert sp.trace is None


def test_profile_flag_writes_the_spans(world, tmp_path):  # noqa: F811
    """``classify-jobs --profile DIR``: the Chrome trace holds the spans of
    the calling thread and of both workers."""
    from tests.test_torch_drivers import ENGINE, _jobs
    from kmer_id_tpu_torch import cli

    d = _jobs(world, "tj")
    prof = tmp_path / "prof"
    assert cli.main(["classify-jobs", "-name", "db", "-jname", "tj", "--root",
                     str(world["root"]), *ENGINE, "--device", "cpu",
                     "--profile", str(prof)]) == 0
    assert not timing.set_tracing(False)  # the switch is off again after the command
    (path,) = prof.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name", "").startswith("kmerid::"):
            assert e.get("cat") == "cpu_op", e  # a host record, no user annotation
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert {"kmerid::sample.start", "kmerid::decode.pack", "kmerid::submit",
            "kmerid::collect", "kmerid::sample.write"} <= set(tids)
    main, sub, col = (tids["kmerid::" + n] for n in ("sample.start", "submit", "collect"))
    assert len(main) == 1 and sub and col and not (main & sub or main & col or sub & col)
    assert (d / "a_result.txt").exists()


def test_outputs_identical_on_and_off(world, engines, tmp_path):  # noqa: F811
    files = {}
    for on in (False, True):
        timing.set_tracing(on)
        out = tmp_path / f"s{int(on)}"
        sp, _ = _sample(world, engines(), out=str(out))
        assert (sp.trace is not None) == on
        files[on] = [(tmp_path / f"s{int(on)}{end}").read_bytes()
                     for end in ("_result.txt", "_reads.txt")]
    assert files[True] == files[False] and files[True][1]


def test_recent_is_bounded():
    traces = [timing.SampleTrace() for _ in range(timing.RECENT + 10)]
    for tr in traces:
        tr.add("batches")
        tr.finish()
    got = timing.recent()
    assert len(got) == timing.RECENT
    assert [s["sample"] for s in got] == [tr.sample for tr in traces[10:]]


def test_switch_and_tracing_block():
    assert timing.new_trace() is None
    with timing.tracing(None):
        assert timing.new_trace() is None
    with timing.tracing("m.jsonl"):
        assert isinstance(timing.new_trace(), timing.SampleTrace)
    assert timing.set_tracing(True) is False and timing.set_tracing(False) is True


def _expected(metric: str, got: list):
    batches = sum(s["counters"]["batches"] for s in got)

    def wall(*names, offcpu=False):
        return sum(s["spans"].get(n, {}).get("wall_ns", 0)
                   - (s["spans"].get(n, {}).get("cpu_ns", 0) if offcpu else 0)
                   for s in got for n in names) / 1e6

    return {
        "decode_fill_ms_per_batch": wall("decode.fill") / batches,
        "decode_pack_ms_per_batch": wall("decode.pack") / batches,
        "decode_offcpu_ms_per_batch": wall("decode.fill", "decode.pack", offcpu=True) / batches,
        "feed_wait_ms_per_batch": wall("feed.wait") / batches,
        "submit_wait_ms_per_batch": wall("submit.wait") / batches,
        "submit_sync_ms_per_batch": wall("sync") / batches,
        "collect_fetch_ms_per_batch": wall("collect.fetch") / batches,
        "collect_lane_ms_per_batch": wall("collect.lane") / batches,
        "fetches_per_batch": sum(s["counters"]["fetches"] for s in got) / batches,
        "sample_overhead_ms": wall("sample.start", "sample.finish", "sample.write") / len(got),
        "decode_inflate_wait_ms_per_batch":
            sum(s["counters"]["inflate.wait_us"] for s in got) / 1000 / batches,
    }[metric]


@pytest.mark.parametrize("metric", METRICS)
def test_reader(world, engines, metric):  # noqa: F811
    from benchmark import spec

    read = spec.reader(metric)
    assert read(None) is None  # no traced sample
    timing.set_tracing(True)
    _sample(world, Slow(engines()))
    _sample(world, engines(), files=("short.fastq.gz",))
    got = timing.recent()
    assert len(got) == 2
    value = read(None)
    assert value is not None and value >= 0
    assert value == pytest.approx(_expected(metric, got), rel=1e-12)
    if metric in ("feed_wait_ms_per_batch", "submit_wait_ms_per_batch",
                  "collect_lane_ms_per_batch", "fetches_per_batch"):
        assert value > 0
