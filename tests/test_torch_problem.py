"""The port's ``build_problem`` against ``cammiq_tpu/models/quant.py``'s,
field for field by dtype and bytes, over both index types that reach it
(the ``.npz`` pair's FlatIndex and the merged artifact's memmapped
EntryPayloads), at kept shares from none to every genome, with owners
clipped at 0 and at n - 1, two values of n on one index, a warm memo and
no doubly table; its memo of the entries' grouping and the spans around
it; and ``tools/problem_bench.py``'s problems and digests."""

import dataclasses
import gc

import numpy as np
import pytest

import cammiq_tpu.config as jcfg
import cammiq_tpu.models.quant as jquant
from cammiq_tpu_torch.config import FineParams
from cammiq_tpu_torch.index.artifact import (load_merged_artifact,
                                             save_merged_artifact)
from cammiq_tpu_torch.models import quant
from cammiq_tpu_torch.models.quant import build_problem
from cammiq_tpu_torch.tools import problem_bench
from cammiq_tpu_torch.query.merged import build_merged_index
from cammiq_tpu_torch.utils import timing
from cammiq_tpu_torch.utils.timing import take, tracing
from torch_fixture import fake_index

E, ED = 6000, 40
RID_HI = 35             # rid1 in [-1, RID_HI): -1 and 0 clip to slot 0
N_WIDE = RID_HI + 1     # every rid1 below n
N_CLIP = 31             # rids 31-34 clip to slot 30
FINE = FineParams(read_cnt_thres=5, easy_to_identify_thres=1000, ilp_alpha=1e-3)
PROBLEM_SPANS = ["problem.prefilter", "problem.entry_sizes",
                 "problem.entry_weights", "problem.terms", "problem.bounds"]


def _table(rng, E, doubly):
    rid1 = rng.integers(-1 if not doubly else 1, RID_HI, E)
    rid2 = rng.integers(1, RID_HI, E) if doubly else np.zeros(E, np.int64)
    idx = fake_index(rid1, rid2, rng.integers(1, 6, E),
                     rng.integers(1, 6, E) if doubly else np.zeros(E),
                     rng.integers(26, 51, E), doubly)
    # distinct random keys, so the tables merge into an artifact
    idx.key_words[:] = rng.integers(0, 2**32, idx.key_words.shape, np.uint32)
    return idx


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """{"flat": (FlatIndex u, d), "artifact": (EntryPayloads u, d)} of the
    same columns, the second memmapped from a saved merged artifact."""
    rng = np.random.default_rng(11)
    u, d = _table(rng, E, False), _table(rng, ED, True)
    path = str(tmp_path_factory.mktemp("problem") / "merged")
    save_merged_artifact(build_merged_index(u, d), u, d, path)
    pu, pd = load_merged_artifact(path).payloads()
    assert isinstance(pu.rid1, np.memmap)
    np.testing.assert_array_equal(pu.rid1, u.rid1)
    return {"flat": (u, d), "artifact": (pu, pd)}


@pytest.fixture(autouse=True)
def clean_tracer():
    timing.disable()
    take()
    yield
    timing.disable()
    take()


def _share(index, n, genomes):
    owner = np.clip(np.asarray(index.rid1, np.int64), 0, n - 1)
    return np.isin(owner, genomes).mean()


def _genomes(case, index, n):
    """The genomes the case's prefilter keeps (never slot 0)."""
    inner = np.arange(1, n - 1)       # every genome but the clip's slot n - 1
    if case == "none":
        return inner[:0]
    if case in ("one", "clip_dropped"):
        return inner[:1] if case == "one" else inner[::3]
    if case in ("tenth", "no_doubly"):
        return inner[:4]
    if case in ("third", "half"):
        return inner[:len(inner) // (3 if case == "third" else 2)]
    assert case in ("all", "clip_kept")
    return np.arange(1, n)


def _inputs(index_u, index_d, n, genomes, seed=3):
    """The arguments of build_problem after the two tables, drawn so that
    the prefilter keeps exactly ``genomes``."""
    rng = np.random.default_rng(seed)
    on = np.zeros(n, bool)
    on[genomes] = True
    cnts_u = np.where(on, rng.integers(10, 300, n), 0).astype(np.float64)
    cnts_d = np.where(on, rng.integers(6, 40, n), 0).astype(np.float64)
    nus = rng.integers(500, 1500, n).astype(np.float64)
    nds = rng.integers(0, 500, n).astype(np.float64)
    gl = rng.integers(500, 900, n)
    gl[0] = 0
    ru = rng.integers(0, 9, index_u.num_entries).astype(np.int32)
    rd = rng.integers(0, 9, ED).astype(np.int32)
    return (ru, rd, cnts_u, cnts_d, nus, nds, gl, 100, 2000, 0.01), on


def _port(index_u, index_d, args):
    return build_problem(index_u, index_d, *args, FINE)


def _source(index_u, index_d, args):
    return jquant.build_problem(index_u, index_d, *args,
                                jcfg.FineParams(**dataclasses.asdict(FINE)))


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert type(a) is type(b) and a == b, f.name


CASES = [("none", N_WIDE), ("one", N_WIDE), ("tenth", N_WIDE),
         ("third", N_WIDE), ("half", N_WIDE), ("all", N_WIDE),
         ("clip_dropped", N_CLIP), ("clip_kept", N_CLIP),
         ("no_doubly", N_WIDE)]


def _memo(index):
    """The n of ``index``'s groupings that ``OwnerGroups.of`` holds."""
    return sorted(quant._GROUPS.get(id(index), {}))


def _forget(index):
    quant._GROUPS.pop(id(index), None)


@pytest.mark.parametrize("source", ["flat", "artifact"])
@pytest.mark.parametrize("case,n", CASES)
def test_build_problem_is_the_source_s(tables, source, case, n):
    """Cold and then warm memo: both calls the source's problem, byte for
    byte; where the source fails (a kept owner past n), the port too."""
    index_u, index_d = tables[source]
    if case == "no_doubly":
        index_d = None
    genomes = _genomes(case, index_u, n)
    args, on = _inputs(index_u, index_d, n, genomes)
    _forget(index_u)
    if case == "clip_kept":
        # a kept rid1 >= n is an index past size_u in the source
        assert (np.asarray(index_u.rid1) >= n).any()
        for build in (_source, _port, _port):
            with pytest.raises(IndexError):
                build(index_u, index_d, args)
        return
    want = _source(index_u, index_d, args)
    np.testing.assert_array_equal(want.exist0, on)
    share = _share(index_u, n, genomes)
    assert {"none": share == 0, "all": share > 0.9,
            "tenth": 0.05 < share < 0.2, "third": 0.25 < share < 0.4,
            "half": 0.4 < share < 0.6}.get(case, True), share
    for _ in range(2):
        _assert_same(_port(index_u, index_d, args), want)
    assert _memo(index_u) == [n]


@pytest.mark.parametrize("source", ["flat", "artifact"])
def test_two_values_of_n_on_one_index(tables, source):
    index_u, index_d = tables[source]
    _forget(index_u)
    for n in (N_WIDE, N_CLIP, N_WIDE):
        args, _ = _inputs(index_u, index_d, n, np.arange(1, n - 1, 2), seed=n)
        _assert_same(_port(index_u, index_d, args),
                     _source(index_u, index_d, args))
    assert _memo(index_u) == [N_CLIP, N_WIDE]


@pytest.mark.parametrize("case", ["none", "one", "half", "all"])
def test_grouping_made_once_under_its_span(tables, case):
    """The folded ``problem.group_owners`` counts the memo's misses (1,
    then none) inside ``problem.entry_sizes``; the five ``problem.*``
    records keep their order, once a call, the doubly table's three
    inside their parents, and nothing else folds."""
    index_u, index_d = tables["flat"]
    _forget(index_u)
    args, _ = _inputs(index_u, index_d, N_WIDE, _genomes(case, index_u, N_WIDE))
    off = _port(index_u, index_d, args)
    _forget(index_u)
    for first in (True, False):
        with tracing():
            on = _port(index_u, index_d, args)
        _assert_same(on, off)
        rec = take()
        (whole,) = [s for s in rec.spans if s.name == "quant.build_problem"]
        stages = [s for s in rec.spans if s.parent is whole]
        assert [s.name for s in stages] == PROBLEM_SPANS
        doubly = [s for s in rec.spans if s.name.startswith("problem.doubly_")]
        assert [(s.name, s.parent) for s in doubly] == [
            ("problem.doubly_sizes", stages[1]),
            ("problem.doubly_weights", stages[2]),
            ("problem.doubly_terms", stages[3])]
        assert len(rec.spans) == 1 + len(stages) + len(doubly)
        tot = rec.totals()
        if first:
            assert tot["problem.group_owners"][0] == 1
            assert list(stages[1].folded) == ["problem.group_owners"]
        else:
            assert "problem.group_owners" not in tot
            assert not stages[1].folded
        assert all(not s.folded for s in stages[2:] + doubly)


def test_memo_goes_with_its_index():
    """A grouping lives as long as its index object: a new object on the
    same columns makes its own, and a collected one leaves nothing."""
    index_u = _table(np.random.default_rng(5), 500, False)
    args, _ = _inputs(index_u, None, N_WIDE, np.arange(1, 9))
    _port(index_u, None, args)
    twin = dataclasses.replace(index_u)
    _assert_same(_port(twin, None, args), _port(index_u, None, args))
    keys = {id(index_u), id(twin)}
    assert keys <= set(quant._GROUPS)
    del index_u, twin
    gc.collect()
    assert not keys & set(quant._GROUPS)


@pytest.mark.parametrize("kept", [0, 3, 12, 24])
def test_problem_bench_builds_the_source_s_problem(kept):
    """``tools/problem_bench.py``'s inputs keep exactly the genomes asked
    for, and the digest it prints is the source's problem's, cold and
    warm (its other fields: the count, the kept share, the times)."""
    u, d = problem_bench.tables(3000, 40, 24, seed=7)
    args, on = problem_bench.inputs(u, d, 24, kept, seed=7)
    *rest, fine = args
    want = jquant.build_problem(u, d, *rest,
                                jcfg.FineParams(**dataclasses.asdict(fine)))
    np.testing.assert_array_equal(want.exist0, on)
    (row,) = problem_bench.measure(3000, 40, 24, [kept], 2, 7, log=lambda m: None)
    assert row["digest"] == problem_bench.digest(want)
    assert row["kept_genomes"] == kept and len(row["warm_ms"]) == 2
    assert row["kept_share"] == np.isin(u.rid1, np.arange(1, kept + 1)).mean()
