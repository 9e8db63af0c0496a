"""The port's tracer (``cammiq_tpu_torch/utils/timing.py``) on the CPU.

- Off, a span is the shared no-op and nothing is recorded, also under an
  active ``torch.profiler``.
- On, the query's spans nest (``query.run`` > ``query.pass`` > the batch
  spans and ``pass.drain``) and carry the read set's name; the batch spans
  fold, so a pass of many batches keeps as many records as one of few;
  a pass re-run on overflow is one more ``query.pass``.
- Under a CPU ``torch.profiler`` the spans are host ranges of the trace,
  as long as the tracer's own intervals.
- ``build_problem`` and ``solve_quant`` give the same answers with the
  tracer on and off; ``solve_quant``'s ``stage_s`` are its stage spans
  (``Stages``).
- Session start: ``session.open``, ``session.index_to_device``,
  ``session.pair_keys`` and ``kernels.load``.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import cammiq_tpu_torch.kernels.build as kbuild
import cammiq_tpu_torch.query.sortjoin as tsj
from cammiq_tpu_torch.config import BuildConfig, FineParams, QueryConfig
from cammiq_tpu_torch.index.artifact import (load_merged_artifact,
                                             save_merged_artifact)
from cammiq_tpu_torch.index.builder import build_index, save_index
from cammiq_tpu_torch.index.table import load_flat_index_pair
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.models.quant import build_problem, solve_quant
from cammiq_tpu_torch.query.merged import build_merged_index
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.utils import timing
from cammiq_tpu_torch.utils.timing import (Stages, Timings, span, stage_timer,
                                           take, tracing)
from torch_fixture import (ALPHA, QUANT_CONSTRAINED, pair_genomes, pair_reads,
                           quant_problem)

G = 6
BATCH_SPANS = ("pass.stage", "pass.classify", "pass.pair_lookup")

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_tracer():
    """Each test starts and ends with the tracer off and empty."""
    timing.disable()
    take()
    yield
    timing.disable()
    take()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """A 5-genome index with planted genome pairs (its ``.npz`` pair and
    merged artifact on disk) and 400 reads, half from the planted pairs."""
    gs, planted = pair_genomes(21, glen=500, seg=100)
    corpus = corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs])
    art = build_index(corpus, BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both"),
                      engine="numpy")
    d = tmp_path_factory.mktemp("trace_index")
    save_index(art, str(d))
    m = build_merged_index(art.unique_index, art.doubly_index)
    save_merged_artifact(m, art.unique_index, art.doubly_index, str(d / "merged"))
    reads = pair_reads(gs, planted, 22, n=400, seg=100)
    return art, reads, d


def _session(art, batch_size=128, engine="sortjoin"):
    return QuerySession(art.unique_index, art.doubly_index, G,
                        QueryConfig(h=12, batch_size=batch_size), device="cpu",
                        engine=engine)


def _counts_equal(a, b):
    for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.nundet, a.nconf, a.pair_counts) == (b.nundet, b.nconf, b.pair_counts)


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_span_is_the_shared_noop_and_records_nothing(pairs):
    art, reads, _ = pairs
    assert not timing.TRACER.on
    assert span("a") is span("b", read_set="r", fold=True)
    sess = _session(art)
    sess.run(reads, sc_mode=True)
    with stage_timer("s", Timings()):
        pass
    rec = take()
    assert (rec.spans, rec.folded) == ([], {})


def test_profiler_does_not_switch_the_tracer_on(pairs):
    art, reads, _ = pairs
    sess = _session(art)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert not timing.TRACER.on
        assert span("a") is span("b")
        sess.run(reads)
    assert not [e for e in prof.events() if e.name.startswith(("query.", "pass."))]
    rec = take()
    assert (rec.spans, rec.folded) == ([], {})


@pytest.mark.parametrize("sc_mode", [False, True])
def test_spans_nest_and_carry_the_read_set(pairs, sc_mode):
    art, reads, _ = pairs
    sess = _session(art)
    want = sess.run(reads, sc_mode=sc_mode)
    take()
    with tracing():
        got = sess.run(reads, sc_mode=sc_mode)
    _counts_equal(got, want)
    rec = take()
    (run,) = _named(rec, "query.run")
    (pas,) = _named(rec, "query.pass")
    (drain,) = _named(rec, "pass.drain")
    assert run.parent is None and pas.parent is run and drain.parent is pas
    assert {s.read_set for s in rec.spans} == {"pairs"}
    assert run.start_ns <= pas.start_ns <= drain.start_ns
    assert drain.end_ns <= pas.end_ns <= run.end_ns
    nb = -(-reads.num_reads // sess.batch_size(reads))
    # each batch's making and its copy, and the call that finds none left
    assert pas.folded["pass.stage"][0] == 2 * nb + 1
    assert pas.folded["pass.classify"][0] == nb
    assert ("pass.pair_lookup" in pas.folded) == sc_mode
    assert "pass.upload_wait" not in pas.folded     # a CPU session's copy
    folded_ns = sum(t[1] for t in pas.folded.values())
    assert folded_ns + drain.ns <= pas.ns
    for n, total, mx in pas.folded.values():
        assert 0 <= mx <= total
    tot = rec.totals()
    assert tot["query.pass"] == [1, pas.ns, pas.ns]
    assert tot["pass.classify"] == pas.folded["pass.classify"]
    assert tot["query.run"] == [1, run.ns, run.ns]
    assert rec.totals("pairs") == tot and rec.totals("other") == {}


def test_many_batches_keep_a_fixed_number_of_records(pairs):
    art, reads, _ = pairs
    kept = {}
    for bs in (256, 16):
        sess = _session(art, batch_size=bs)
        with tracing():
            sess.run(reads, sc_mode=True)
        rec = take()
        kept[bs] = ([s.name for s in rec.spans],
                    _named(rec, "query.pass")[0].folded["pass.classify"][0])
    assert kept[256][0] == kept[16][0]
    assert (kept[256][1], kept[16][1]) == (2, 25)


def test_passes_count_the_reruns_on_slot_overflow(pairs):
    """maxm 1 overflows its slots: the pass re-runs with maxm doubled."""
    art, reads, _ = pairs
    sess = _session(art)
    want = sess.run(reads)
    sess = _session(art)
    sess.maxm = 1
    with tracing():
        _counts_equal(sess.run(reads), want)
        reruns = len(_named(take(), "query.pass")) - 1
        assert reruns >= 1 and sess.maxm == 1 << reruns
        sess.run(reads)        # the widening sticks
        assert len(_named(take(), "query.pass")) == 1


def test_passes_count_the_reruns_on_hit_overflow(pairs, monkeypatch):
    """frac 1024 leaves the match list 20 slots: the pass re-runs as frac
    halves, to 128 or below."""
    art, reads, _ = pairs
    want = _session(art).run(reads, sc_mode=True)
    monkeypatch.setattr(tsj, "HIT_FLOOR", 16)
    monkeypatch.setattr(tsj, "LIST_SLACK", 0)
    sess = _session(art)
    sess.frac = 1024
    with tracing():
        _counts_equal(sess.run(reads, sc_mode=True), want)
    rec = take()
    assert sess.frac <= 128
    assert len(_named(rec, "query.pass")) >= 4
    assert rec.totals()["query.pass"][0] == len(_named(rec, "query.pass"))
    assert len(_named(rec, "query.run")) == 1


def test_spans_are_host_ranges_of_the_profiler(pairs):
    """Under a CPU profiler each span is also a range of the trace: the
    pass holds its batch spans, each as long as the tracer measured."""
    art, reads, _ = pairs
    sess = _session(art, batch_size=64)
    sess.run(reads, sc_mode=True)
    with tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sess.run(reads, sc_mode=True)
    rec = take()
    (pas,) = _named(rec, "query.pass")
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    ((ps, pe),) = ranges["query.pass"]
    assert abs((pe - ps) * 1e3 - pas.ns) <= 0.05 * pas.ns
    for name in BATCH_SPANS:
        rs = ranges[name]
        assert len(rs) == pas.folded[name][0]
        assert all(ps <= s <= e <= pe for s, e in rs)
    # the batch spans together: the profiler's ranges against the tracer's
    prof_ns = sum((e - s) * 1e3 for n in BATCH_SPANS for s, e in ranges[n])
    mem_ns = sum(pas.folded[n][1] for n in BATCH_SPANS)
    assert abs(prof_ns - mem_ns) <= 0.05 * mem_ns


def _problem(art, counts, fine):
    gl = np.full(G, 500, np.int64)
    gl[0] = 0
    nus = np.full(G, 1e4)
    return build_problem(art.unique_index, art.doubly_index, counts.rcount_u,
                         counts.rcount_d, counts.cnts_u.astype(np.float64),
                         counts.cnts_d.astype(np.float64), nus, nus.copy(), gl,
                         counts.mean_read_len, counts.num_reads, 0.01, fine)


def _assert_same_problem(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("source", ["session", "instance"])
def test_build_problem_bit_identical_with_the_tracer_on(pairs, source):
    art, reads, _ = pairs
    if source == "session":
        counts = _session(art).run(reads)
        fine = FineParams(read_cnt_thres=1, easy_to_identify_thres=1, ilp_alpha=1e-9)
        off = _problem(art, counts, fine)
        with tracing():
            on = _problem(art, counts, fine)
    else:
        off = quant_problem(3, **QUANT_CONSTRAINED)
        with tracing():
            on = quant_problem(3, **QUANT_CONSTRAINED)
    assert off.exist0.any() and len(off.ug) and len(off.downer)
    _assert_same_problem(on, off)
    rec = take()
    (whole,) = _named(rec, "quant.build_problem")
    stages = [s for s in rec.spans if s.parent is whole]
    assert [s.name for s in stages] == [
        "problem.prefilter", "problem.entry_sizes", "problem.entry_weights",
        "problem.terms", "problem.bounds"]
    assert sum(s.ns for s in stages) <= whole.ns
    # the doubly table's share of three of them, one span each inside
    inner = [s for s in rec.spans if s.name.startswith("problem.")
             and s.parent is not whole]
    assert [(s.name, s.parent.name) for s in inner] == [
        ("problem.doubly_sizes", "problem.entry_sizes"),
        ("problem.doubly_weights", "problem.entry_weights"),
        ("problem.doubly_terms", "problem.terms")]
    assert all(s.ns <= s.parent.ns for s in inner)


def test_solve_quant_stages_are_its_spans():
    prob = quant_problem(3, **QUANT_CONSTRAINED)
    ex_off, cov_off, info_off = solve_quant(prob, device="cpu")
    with tracing():
        ex_on, cov_on, info_on = solve_quant(prob, device="cpu")
    np.testing.assert_array_equal(ex_on, ex_off)
    np.testing.assert_array_equal(cov_on, cov_off)
    assert info_on.keys() == info_off.keys()
    for k in ("objective", "candidates", "fista_chunks", "bnb_nodes",
              "stopped_by", "enum_rounds"):
        assert info_on[k] == info_off[k], k
    stage_s = info_on["stage_s"]
    assert list(stage_s) == ["prepare", "relax", "enum", "bnb"]
    assert list(info_off["stage_s"]) == list(stage_s)
    assert sum(stage_s.values()) <= info_on["solve_time"]
    rec = take()
    (whole,) = _named(rec, "quant.solve")
    for k, sec in stage_s.items():
        (s,) = _named(rec, f"solve.{k}")
        assert s.parent is whole
        # the stage timer's clock and the span's read a few us apart
        assert abs(s.ns / 1e9 - sec) <= 1e-3 + 0.05 * sec


def test_session_start_spans(pairs):
    art, reads, d = pairs
    with tracing():
        artifact = load_merged_artifact(str(d / "merged"))
        artifact.payloads()
        sess = QuerySession.from_artifact(artifact, G, QueryConfig(h=12),
                                          device="cpu")
        sess.run(reads, sc_mode=True)
        sess.run(reads, sc_mode=True)       # the pair keys are built once
        iu, idd = load_flat_index_pair(str(d / "index_u.npz"), str(d / "index_d.npz"))
        QuerySession(iu, idd, G, QueryConfig(h=12), device="cpu")
        QuerySession(iu, idd, G, QueryConfig(h=12), device="cpu", engine="gather")
    rec = take()
    names = [s.name for s in rec.spans if s.name.startswith("session.")]
    assert names == ["session.open", "session.open", "session.index_to_device",
                     "session.pair_keys", "session.open",
                     "session.index_to_device", "session.index_to_device"]
    (keys,) = _named(rec, "session.pair_keys")
    assert keys.parent.name == "query.pass"


def test_kernel_library_load_is_a_span(monkeypatch, tmp_path):
    """``kernels.load`` covers the library's build and opening, once."""
    class Lib:
        cammiq_error_string = type("F", (), {})()

    opened = []
    monkeypatch.setattr(kbuild, "_lib", None)
    monkeypatch.setattr(kbuild, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(kbuild.ctypes, "CDLL",
                        lambda p: opened.append(p) or time.sleep(0.01) or Lib())
    with tracing():
        assert kbuild.load() is kbuild.load()
    (s,) = take().spans
    assert (s.name, len(opened)) == ("kernels.load", 1)
    assert s.ns >= 10_000_000


def test_stage_timer_still_times_and_prints(capsys):
    tm = Timings()
    with stage_timer("query", tm, verbose=True):
        time.sleep(0.002)
    (stage, sec), = tm.records
    assert stage == "query" and sec >= 0.002
    assert capsys.readouterr().err.startswith("Time for query: ")
    assert not hasattr(timing, "GLOBAL_TIMINGS")
    assert not hasattr(Timings, "report")


def test_folded_span_without_an_open_parent():
    with tracing():
        for _ in range(3):
            with span("pass.upload_wait", fold=True):
                with span("inner", fold=True):
                    pass
    rec = take()
    assert rec.spans == []
    assert rec.folded["pass.upload_wait"][0] == 3
    assert rec.folded["inner"][0] == 3
    assert take().folded == {}


def test_stages_are_back_to_back_spans():
    with tracing():
        with span("whole"):
            t0 = time.perf_counter()
            st = Stages("st.", t0)
            st.begin("a")
            time.sleep(0.002)
            st.begin("b")
            st.end()
        total = time.perf_counter() - t0
    rec = take()
    assert [s.name for s in rec.spans] == ["st.a", "st.b", "whole"]
    assert all(s.parent is rec.spans[2] for s in rec.spans[:2])
    assert list(st.seconds) == ["a", "b"] and st.seconds["a"] >= 0.002
    assert sum(st.seconds.values()) <= total
    # a stage an exception leaves open is closed with its function's span
    with tracing(), pytest.raises(ValueError):
        with span("whole"):
            Stages("st.", time.perf_counter()).begin("a")
            raise ValueError
    assert [s.name for s in take().spans] == ["whole"]
    assert timing.TRACER.stack == []
    st = Stages("st.", time.perf_counter())     # off: the seconds alone
    st.begin("a")
    st.end()
    assert list(st.seconds) == ["a"] and take().spans == []


def test_cli_device_trace_restores_the_tracer(tmp_path):
    from cammiq_tpu_torch.utils.profiling import device_trace, trace_path

    with device_trace(str(tmp_path), "cpu"):
        assert timing.TRACER.on
        with span("probe.me", read_set="r1"), span("probe.inner"):
            torch.ones(4).sum()
        with span("probe.none"):        # a span that serves no read set
            torch.ones(4).sum()
    assert not timing.TRACER.on
    assert take().spans == []           # nothing kept past the block
    with open(trace_path(str(tmp_path))) as f:
        events = json.load(f)["traceEvents"]
    args = {e["name"]: e.get("args", {}) for e in events
            if e.get("name", "").startswith("probe.")}
    assert args["probe.me"]["read_set"] == args["probe.inner"]["read_set"] == "r1"
    assert "read_set" not in args["probe.none"]
    # an operator's trace inside a traced block keeps the outer records
    with tracing():
        with span("outer"), device_trace(str(tmp_path), "cpu"):
            pass
        assert [s.name for s in take().spans] == ["outer"]
