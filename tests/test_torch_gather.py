"""The port's gather engine against the JAX package's on the same index and
reads: ``query/probe.py``'s plain probe, ``query/classify.py``'s
``collect_matches`` (the plain version of ``kernels/gather_probe.py``) and
gather ``classify_batch``, ``QuerySession(engine="gather")`` and
``cli --query --engine gather``.  Slots, counts, rcounts and pair counts
must be bit-identical, Type-I and Type-II files byte-identical, and quant
must select the same genomes within 1e-3 L1."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cammiq_tpu.index.table as jtab
from cammiq_tpu.cli import main as jax_cli_main
from cammiq_tpu.config import BuildConfig
from cammiq_tpu.config import QueryConfig as JQueryConfig
from cammiq_tpu.index.builder import build_index
from cammiq_tpu.io.fasta import corpus_from_sequences
from cammiq_tpu.io.fastq import ReadSet
from cammiq_tpu.models.output import parse_quant_output
from cammiq_tpu.query import classify as jc
from cammiq_tpu.query import probe as jp
from cammiq_tpu.query.pipeline import QuerySession as JaxSession
from cammiq_tpu.tools.simulate import simulate
from cammiq_tpu_torch import u32
from cammiq_tpu_torch.cli import main as cli_main
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.kernels import gather_probe as kgp
from cammiq_tpu_torch.query import classify as tc
from cammiq_tpu_torch.query import probe as tp
from cammiq_tpu_torch.query.pipeline import QuerySession
from torch_fixture import ALPHA, pair_genomes

G = 6                     # 5 genomes + the unassigned slot
LP = 64
SLOT_FIELDS = ("slots", "rid1", "rid2", "in_u")
COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")
# an index per h: h <= 16 takes one prefix word, h > 16 two
BUILD = {12: dict(k=12, L=60, Lmax=30, h=12), 20: dict(k=20, L=60, Lmax=40, h=20)}

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def indexes():
    """h -> (BuildArtifacts, genomes, planted segments): 5 genomes x 600
    bases with a segment planted in each pair of neighbours, so both tables
    have entries."""
    cache = {}

    def get(h):
        if h not in cache:
            gs, planted = pair_genomes(40 + h, glen=600, seg=120)
            corpus = corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs])
            art = build_index(corpus, BuildConfig(mode="both", **BUILD[h]),
                              engine="numpy")
            assert art.unique_index.num_entries and art.doubly_index.num_entries
            cache[h] = art, gs, planted
        return cache[h]

    return get


def make_reads(gs, planted, seed, h, n=96, minus1=0.0, short=False):
    """int8 codes [n, LP] and int32 lengths: reads of both strands with 2%
    substitutions, half from planted segments; the codes past a read's
    length are random (the forward probe reads them).  ``minus1`` sets that
    share of every position to -1; ``short`` makes some reads empty or
    shorter than h."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, LP)).astype(np.int8)
    lengths = rng.integers(h + 10, LP + 1, n)
    for b in range(n):
        if b % 2:
            g, at = planted[int(rng.integers(len(planted)))]
            p = at + int(rng.integers(0, 120 - LP + 1))
        else:
            g = int(rng.integers(len(gs)))
            p = int(rng.integers(0, len(gs[g]) - LP))
        x = gs[g][p:p + LP].copy()
        if rng.random() < 0.5:
            x = 3 - x[::-1]
        err = rng.random(LP) < 0.02
        x[err] = rng.integers(0, 4, int(err.sum()))
        codes[b, :lengths[b]] = x[:lengths[b]]
    if minus1:
        codes[rng.random(codes.shape) < minus1] = -1
    if short:
        lengths[:8] = [0, 0, 1, 5, h - 1, h, h + 1, 3]
    return codes, lengths.astype(np.int32)


def _tables(art, case):
    """(unique, doubly) FlatIndex pair of a collect_matches case."""
    iu, idd = art.unique_index, art.doubly_index
    h = iu.h
    if case == "empty_unique":
        iu = jtab._empty_flat_index(h, iu.kw, False)
    elif case == "empty_doubly":
        idd = jtab._empty_flat_index(h, idd.kw, True)
    elif case == "forced_probes":
        # a load factor above 1 takes the smallest table the entries fit
        # with bounded displacement, so buckets collide
        iu = jtab.build_flat_index_from_entries(
            iu.key_words, iu.length, iu.rid1, iu.ucount1, iu.rid2, iu.ucount2,
            h, False, load_factor=4.0)
        assert iu.max_probes > 1
    elif case == "probes_65":
        iu = dataclasses.replace(iu, max_probes=65)
        idd = dataclasses.replace(idd, max_probes=65)
    return iu, idd


def _jax_collect(iu, idd, codes, lengths):
    # op by op: most ops' shapes repeat across cases, where a jit of each
    # table pair would compile anew
    return jc.collect_matches(jp.to_device_index(iu), jp.to_device_index(idd),
                              jnp.asarray(codes), jnp.asarray(lengths))


def _port_collect(iu, idd, codes, lengths):
    return tc.collect_matches(tp.to_device_index(iu, "cpu"),
                              tp.to_device_index(idd, "cpu"),
                              torch.from_numpy(codes), torch.from_numpy(lengths))


# ---- the plain probe's pieces

def test_hash_prefix_matches_jax():
    rng = np.random.default_rng(1)
    lo, hi = (rng.integers(0, 1 << 32, 10_000, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    want = np.asarray(jp.hash_prefix_j(jnp.asarray(lo), jnp.asarray(hi)))
    got = tp.hash_prefix(u32.widen(torch.from_numpy(lo.view(np.int32))),
                         u32.widen(torch.from_numpy(hi.view(np.int32))))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(want, jtab.hash_prefix(lo, hi))


@pytest.mark.parametrize("codes_from", ["acgt", "minus1", "revcomp4"])
def test_pack_rolling16_matches_jax(codes_from):
    """-1 codes set every bit from their field up; a reverse-complemented -1
    is a 4, whose bit 2 spills into the next field."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, (40, 37)).astype(np.int8)
    if codes_from != "acgt":
        codes[rng.random(codes.shape) < 0.05] = -1
    if codes_from == "revcomp4":
        codes = np.where(codes < 0, 4, codes).astype(np.int8)
    want = np.asarray(jp.pack_rolling16(jnp.asarray(codes)))
    got = tp.pack_rolling16(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("h", [12, 20])
def test_revcomp_batch_matches_jax(indexes, h):
    art, gs, planted = indexes(h)
    codes, lengths = make_reads(gs, planted, 3, h, minus1=0.03, short=True)
    want = np.asarray(jc.revcomp_batch(jnp.asarray(codes), jnp.asarray(lengths)))
    got = tc.revcomp_batch(torch.from_numpy(codes), torch.from_numpy(lengths))
    assert got.dtype == torch.int8 and (want == 4).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("strand", ["fwd", "rc"])
@pytest.mark.parametrize("h", [12, 20])
def test_probe_strand_matches_jax(indexes, h, strand):
    art, gs, planted = indexes(h)
    codes, lengths = make_reads(gs, planted, 4, h, minus1=0.03)
    if strand == "rc":
        codes = np.array(jc.revcomp_batch(jnp.asarray(codes), jnp.asarray(lengths)))
    O = LP - h + 1
    ju = jp.to_device_index(art.unique_index)
    want = np.asarray(jax.jit(partial(jp.probe_strand, ju))(
        jp.pack_rolling16(jnp.asarray(codes)), jnp.asarray(lengths),
        jnp.arange(O, dtype=jnp.int32)))
    got = tp.probe_strand(tp.to_device_index(art.unique_index, "cpu"),
                          tp.pack_rolling16(torch.from_numpy(codes)),
                          torch.from_numpy(lengths), torch.arange(O))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10


def test_device_index_matches_jax(indexes):
    """Every field of to_device_index, the empty table's dummy entry
    included."""
    art, _, _ = indexes(20)
    for idx in (art.unique_index, jtab._empty_flat_index(20, 3, True)):
        want, got = jp.to_device_index(idx), tp.to_device_index(idx, "cpu")
        for f in ("h", "kw", "max_probes", "max_bucket", "num_entries",
                  "table_bits"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
                  "table_lo", "table_hi", "table_start", "table_count"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)).view(np.int32),
                err_msg=f)
        assert got.erec.shape[1] % 4 == 0 and got.trec.shape[1] == 4


# ---- collect_matches: slots, rid1, rid2 and in_u

CASES = ["plain", "minus1", "short_reads", "empty_unique", "empty_doubly",
         "forced_probes", "probes_65"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("h", [12, 20])
def test_collect_matches_matches_jax(indexes, h, case):
    """Column order [unique fwd | unique rc | doubly fwd | doubly rc], -1
    codes on both strands, reads of length 0 and shorter than h, empty
    tables (ids of the doubly table start past the unique table's dummy
    entry) and tables walked for more than one probe."""
    art, gs, planted = indexes(h)
    codes, lengths = make_reads(gs, planted, 5 + len(case), h,
                                minus1=0.03 if case == "minus1" else 0.0,
                                short=case == "short_reads")
    iu, idd = _tables(art, case)
    want = _jax_collect(iu, idd, codes, lengths)
    got = _port_collect(iu, idd, codes, lengths)
    for f in SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    slots = got.slots.numpy()
    assert slots.shape == (codes.shape[0], 4 * (LP - h + 1))
    hits = slots < kgp.BIG
    assert hits.sum() > 0
    if case != "empty_unique":
        assert got.in_u.numpy().any()
    if case == "short_reads":
        assert not hits[:5].any()


@pytest.mark.parametrize("unique", ["full", "empty"])
def test_collect_matches_bases_match_jax(indexes, unique):
    """The ids' placement, JAX's default: unique hits in [0, Eu), doubly
    hits from Eu on, Eu the unique table's device length (1 for an empty
    table: its dummy entry)."""
    art, gs, planted = indexes(12)
    codes, lengths = make_reads(gs, planted, 6, 12)
    iu, idd = _tables(art, "empty_unique" if unique == "empty" else "plain")
    want = _jax_collect(iu, idd, codes, lengths)
    got = _port_collect(iu, idd, codes, lengths)
    for f in SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    Eu = tp.to_device_index(iu, "cpu").length.shape[0]
    slots, in_u = got.slots.numpy(), got.in_u.numpy()
    doubly = (slots < kgp.BIG) & ~in_u
    assert (slots[in_u] < Eu).all() and (slots[doubly] >= Eu).all()
    assert doubly.any() and in_u.any() == (unique == "full")
    assert (Eu == 1) == (unique == "empty")


def test_plain_version_is_the_cpu_path(indexes):
    """On CPU tensors the wrapper is its plain version; a tensor on another
    device type is refused."""
    art, gs, planted = indexes(20)
    codes, lengths = make_reads(gs, planted, 7, 20)
    du = tp.to_device_index(art.unique_index, "cpu")
    dd = tp.to_device_index(art.doubly_index, "cpu")
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    before = kgp.KERNEL.launches
    for a, b in zip(kgp.gather_probe(du, dd, c, ln), kgp.gather_probe_plain(du, dd, c, ln)):
        assert torch.equal(a, b)
    assert kgp.KERNEL.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        kgp.gather_probe(du, dd, c.to("meta"), ln.to("meta"))


# ---- the walk's stop at the first empty row (csrc/gather_probe.cu)

def _assert_probe_runs(lo, hi, start):
    """Every occupied row s, of hash h (the JAX package's hash), has
    h <= s and rows h..s all occupied; and stage_index's check agrees."""
    T = len(start)
    hv = jtab.hash_prefix(lo, hi).astype(np.int64) & (T - 1)
    rows = np.flatnonzero(np.asarray(start) >= 0)
    for s in rows:
        assert hv[s] <= s and (np.asarray(start)[hv[s]:s + 1] >= 0).all(), s
    tp.check_probe_runs(lo, hi, start)
    return len(rows)


def _runs_producer(art, producer):
    """[(lo, hi, start)] of each hash table a producer builds from the
    unique entries of ``art``."""
    from cammiq_tpu_torch.index import table as ttab

    iu = art.unique_index
    entries = (iu.key_words, iu.length, iu.rid1, iu.ucount1, iu.rid2,
               iu.ucount2, iu.h, False)
    kind, arg = producer.split("_")
    if kind == "empty":
        t = ttab._empty_flat_index(iu.h, iu.kw, False)
        return [(t.table_lo, t.table_hi, t.table_start)]
    build = (ttab if kind == "port" else jtab).build_flat_index_from_entries
    t = build(*entries, load_factor=float(arg))
    if float(arg) > 1:
        assert t.max_probes > 1
    return [(t.table_lo, t.table_hi, t.table_start)]


@pytest.mark.parametrize("producer", ["port_0.5", "port_4.0", "jax_0.5", "jax_4.0",
                                      "port_0.25", "port_1.0", "jax_0.25",
                                      "jax_1.0", "empty_0"])
def test_hash_tables_are_probe_runs(indexes, producer):
    """Every producer of device tables (the flat builder at load factors
    0.25, 0.5, 1.0 and 4.0, the JAX package's and the port's; the empty
    table) places each bucket at or after its hash row with no empty row in
    between, never wrapping: the invariant that makes the kernel's stop at
    an empty row exact."""
    art, _, _ = indexes(20)
    occupied = [_assert_probe_runs(*t) for t in _runs_producer(art, producer)]
    assert (sum(occupied) == 0) == (producer == "empty_0")


@pytest.mark.parametrize("fault", ["hole", "behind_hash"])
def test_stage_index_rejects_broken_runs(indexes, fault):
    """A table with a row cleared inside a run, or a bucket moved to the
    row before its hash, is refused at staging: the kernel would answer
    wrongly on it, and no switch returns to the full walk."""
    art, _, _ = indexes(20)
    iu = jtab.build_flat_index_from_entries(
        *(getattr(art.unique_index, f) for f in ("key_words", "length", "rid1",
                                                 "ucount1", "rid2", "ucount2")),
        20, False, load_factor=4.0)
    T = len(iu.table_start)
    hv = jtab.hash_prefix(iu.table_lo, iu.table_hi).astype(np.int64) & (T - 1)
    occ = iu.table_start >= 0
    lo, hi, start, count = (x.copy() for x in (iu.table_lo, iu.table_hi,
                                               iu.table_start, iu.table_count))
    if fault == "hole":
        s = int(np.flatnonzero(occ & (hv < np.arange(T)))[0])   # displaced
        start[hv[s]], lo[hv[s]], hi[hv[s]] = -1, 0, 0
    else:
        s = int(np.flatnonzero(occ & (hv == np.arange(T)) & ~np.roll(occ, 1)
                               & (np.arange(T) > 0))[0])
        for a in (lo, hi, start, count):
            a[s - 1], a[s] = a[s], 0
        start[s] = -1
    bad = dataclasses.replace(iu, table_lo=lo, table_hi=hi, table_start=start,
                              table_count=count)
    tp.to_device_index(iu, "cpu")
    with pytest.raises(ValueError, match="linear-probe runs"):
        tp.to_device_index(bad, "cpu")


M32 = 0xFFFFFFFF


def _walk_to_first_empty(idx, codes, lengths):
    """Entries at every offset of one strand, by a numpy walk that stops at
    the first row holding the prefix or the first empty row (start < 0),
    at most max_probes rows; then the first entry of the bucket that fits.
    Returns (entries int [B, O] or -1, how each walk ended: 0 hit, 1 empty
    row, 2 cap)."""
    B, Lp = codes.shape
    h, kw, P = idx.h, idx.kw, idx.max_probes
    O = max(Lp - h + 1, 1)
    T = len(idx.table_start)
    c = np.concatenate([codes.astype(np.int64) & M32,
                        np.zeros((B, 16 * kw + 16), np.int64)], 1)
    p16 = np.zeros((B, Lp), np.int64)
    for s in range(16):
        p16 |= (c[:, s:s + Lp] << (2 * s)) & M32
    p16 = np.concatenate([p16, np.zeros((B, 16 * kw + O), np.int64)], 1)
    W = [p16[:, 16 * w:16 * w + O] for w in range(kw)]

    def mask(nb):
        return M32 if nb >= 16 else (1 << (2 * nb)) - 1

    lo = W[0] & mask(min(h, 16))
    hi = W[1] & mask(min(max(h - 16, 0), 16)) if h > 16 else np.zeros_like(lo)
    slot0 = jtab.hash_prefix(lo.astype(np.uint32), hi.astype(np.uint32)) & (T - 1)
    found = np.full((B, O), -1, np.int64)
    ended = np.full((B, O), 2, np.int64)
    for b in range(B):
        for o in range(O):
            bstart = -1
            for p in range(P):
                row = (int(slot0[b, o]) + p) & (T - 1)
                if idx.table_start[row] < 0:
                    ended[b, o] = 1
                    break
                if idx.table_lo[row] == lo[b, o] and idx.table_hi[row] == hi[b, o]:
                    bstart, bcount = int(idx.table_start[row]), int(idx.table_count[row])
                    ended[b, o] = 0
                    break
            if bstart < 0:
                continue
            for k in range(min(bcount, idx.max_bucket)):
                e = min(bstart + k, len(idx.length) - 1)
                elen = int(idx.length[e])
                if elen <= lengths[b] - o and all(
                        (int(W[w][b, o]) & mask(min(max(elen - 16 * w, 0), 16)))
                        == int(idx.key_words[e, w]) for w in range(kw)):
                    found[b, o] = e
                    break
    return found, ended


def _poly_a_table(art, rng):
    """The unique table with one more key whose h-prefix is all A (lo = hi
    = 0, as an empty row's), and that key."""
    iu = art.unique_index
    key = np.concatenate([np.zeros(iu.h, np.int64), rng.integers(0, 4, 9)])
    words = np.zeros((1, iu.kw), np.uint32)
    for i, x in enumerate(key):
        words[0, i // 16] |= np.uint32(x << (2 * (i % 16)))
    cat = [np.concatenate([getattr(iu, f), x]) for f, x in (
        ("key_words", words), ("length", [len(key)]), ("rid1", [1]),
        ("ucount1", [1]), ("rid2", [0]), ("ucount2", [0]))]
    return jtab.build_flat_index_from_entries(*cat, iu.h, False), key


@pytest.mark.parametrize("case", ["minus1", "forced_probes", "probes_65", "poly_a"])
def test_walk_to_first_empty_row_matches_jax(indexes, case):
    """Stopping each walk at the first empty row gives JAX's probe_strand
    (which walks all max_probes rows) exactly, on both strands: reads with
    -1 codes, a table packed tight, 65 probes, and a key whose h-prefix is
    all A planted in reads beside runs of A that match no key."""
    art, gs, planted = indexes(20)
    rng = np.random.default_rng(11)
    codes, lengths = make_reads(gs, planted, 12, 20, minus1=0.03)
    iu = _tables(art, "plain" if case in ("minus1", "poly_a") else case)[0]
    if case == "poly_a":
        iu, key = _poly_a_table(art, rng)
        for b in range(0, 40, 2):
            at = int(rng.integers(0, lengths[b] - len(key) + 1))
            codes[b, at:at + len(key)] = key if b % 4 else 3 - key[::-1]
        codes[1::4, 10:40] = 0
    O = LP - 20 + 1
    ju = jp.to_device_index(iu)
    probe = jax.jit(partial(jp.probe_strand, ju))
    ended_all, found = [], []
    for strand in (codes, np.asarray(jc.revcomp_batch(jnp.asarray(codes),
                                                      jnp.asarray(lengths)))):
        want = np.asarray(probe(jp.pack_rolling16(jnp.asarray(strand)),
                                jnp.asarray(lengths), jnp.arange(O, dtype=jnp.int32)))
        got, ended = _walk_to_first_empty(iu, strand, lengths)
        np.testing.assert_array_equal(got, want)
        assert (want >= 0).sum() > 10
        ended_all.append(ended)
        found.append(want)
    ended = np.concatenate(ended_all)
    assert (ended == 1).sum() > 0.5 * ended.size       # most walks end at an empty row
    if case == "probes_65":
        assert not (ended == 2).any()
    if case == "poly_a":
        e = np.flatnonzero((iu.length == len(key)) & (iu.key_words[:, 0] == 0))
        assert len(e) == 1 and (np.concatenate(found) == e[0]).sum() >= 10


# ---- classify_batch and rcounts

@pytest.mark.parametrize("sc_mode", [False, True])
@pytest.mark.parametrize("with_rcounts", [False, True])
@pytest.mark.parametrize("h", [12, 20])
def test_classify_batch_matches_jax(indexes, h, with_rcounts, sc_mode):
    art, gs, planted = indexes(h)
    codes, lengths = make_reads(gs, planted, 8, h, minus1=0.01)
    iu, idd = art.unique_index, art.doubly_index
    ju, jd = jp.to_device_index(iu), jp.to_device_index(idd)
    want = jax.jit(partial(jc.classify_batch, ju, jd, num_genome_slots=G,
                           with_rcounts=with_rcounts, sc_mode=sc_mode))(
        jnp.asarray(codes), jnp.asarray(lengths))
    du, dd = tp.to_device_index(iu, "cpu"), tp.to_device_index(idd, "cpu")
    Eu, Ed = du.length.shape[0], dd.length.shape[0]
    rc = torch.zeros(Eu + Ed + 1, dtype=torch.int32) if with_rcounts else None
    got = tc.classify_batch(du, dd, torch.from_numpy(codes),
                            torch.from_numpy(lengths), G, rc, sc_mode=sc_mode)
    for f in ("cnts_u", "cnts_d", "nundet", "nconf", "pair_lo", "pair_hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.overflow_slots is None and got.overflow_hits is None
    if with_rcounts:
        np.testing.assert_array_equal(rc[:Eu].numpy(), np.asarray(want.rcount_u))
        np.testing.assert_array_equal(rc[Eu:-1].numpy(), np.asarray(want.rcount_d))
        assert int(rc[:-1].sum()) > 0
    assert int(got.cnts_u.sum()) > 0
    if sc_mode:
        assert int((got.pair_lo >= 0).sum()) > 0


@pytest.mark.parametrize("lo,size", [(0, 50), (40, 30), (0, 400)])
def test_rcounts_from_case_matches_jax(indexes, lo, size):
    art, gs, planted = indexes(12)
    codes, lengths = make_reads(gs, planted, 9, 12)
    want_ms = _jax_collect(art.unique_index, art.doubly_index, codes, lengths)
    case_j = jc.case_analysis(want_ms, jnp.asarray(lengths), G)
    want = np.asarray(jc.rcounts_from_case(case_j, lo, size))
    ms = _port_collect(art.unique_index, art.doubly_index, codes, lengths)
    got = tc.rcounts_from_case(tc.case_analysis(ms, torch.from_numpy(lengths), G),
                               lo, size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


# ---- QuerySession(engine="gather")

def _read_set(codes, lengths):
    codes[np.arange(LP) >= lengths[:, None]] = 0      # FASTQ padding
    return ReadSet(codes=codes, lengths=lengths, total_len=int(lengths.sum()),
                   name="gather")


@pytest.fixture(scope="module")
def session_reads(indexes):
    """300 reads of both strands from the h = 12 index's genomes, 1% of
    their codes -1 (an N), as a ReadSet."""
    _, gs, planted = indexes(12)
    return _read_set(*make_reads(gs, planted, 10, 12, n=300, minus1=0.01))


@pytest.fixture(scope="module")
def acgt_reads(indexes):
    """The same reads with no -1 code.  On a read with an N the two engines
    differ, in the JAX package too: the sort join probes the forward strand
    against reverse-complemented keys, the gather the reverse complement
    itself, and a -1 packs differently from its complement (a 4)."""
    _, gs, planted = indexes(12)
    return _read_set(*make_reads(gs, planted, 10, 12, n=300))


def _assert_counts_equal(got, want, pairs=True):
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.num_reads, got.mean_read_len) == (
        want.nundet, want.nconf, want.num_reads, want.mean_read_len)
    if pairs:
        assert got.pair_counts == want.pair_counts


@pytest.mark.parametrize("sc_mode", [False, True])
@pytest.mark.parametrize("tables", ["both", "no_doubly", "empty_unique"])
def test_session_gather_matches_jax(indexes, session_reads, tables, sc_mode):
    """Against the JAX gather session; with no doubly index both use a dummy
    table, and with an empty unique table the doubly rcounts start past its
    dummy entry."""
    art, _, _ = indexes(12)
    iu, idd = art.unique_index, art.doubly_index
    if tables == "no_doubly":
        idd = None
    elif tables == "empty_unique":
        iu = jtab._empty_flat_index(12, iu.kw, False)
    cfg = dict(h=12, batch_size=128)
    want = JaxSession(iu, idd, G, JQueryConfig(**cfg), engine="gather").run(
        session_reads, sc_mode=sc_mode)
    sess = QuerySession(iu, idd, G, QueryConfig(**cfg), device="cpu",
                        engine="gather")
    assert sess.engine == "gather" and sess.dm is None
    got = sess.run(session_reads, sc_mode=sc_mode)
    _assert_counts_equal(got, want)
    assert want.cnts_u.sum() + want.cnts_d.sum() > 0
    if tables == "empty_unique" and not sc_mode:
        assert want.rcount_d.sum() > 0 and got.rcount_u.shape == (0,)


@pytest.mark.parametrize("sc_mode", [False, True])
def test_session_gather_matches_sortjoin(indexes, acgt_reads, sc_mode):
    """The port's two engines give the same counts on reads of A, C, G and
    T (see ``acgt_reads`` for reads with an N)."""
    art, _, _ = indexes(12)
    cfg = QueryConfig(h=12, batch_size=128)
    got, want = (QuerySession(art.unique_index, art.doubly_index, G, cfg,
                              device="cpu", engine=e).run(acgt_reads,
                                                          sc_mode=sc_mode)
                 for e in ("gather", "sortjoin"))
    _assert_counts_equal(got, want)
    if sc_mode:
        assert len(want.pair_counts) >= 1


def test_session_rejects_unknown_engine(indexes):
    art, _, _ = indexes(12)
    with pytest.raises(ValueError, match="unknown query engine"):
        QuerySession(art.unique_index, art.doubly_index, G, device="cpu",
                     engine="dir")


# ---- the CLI: --engine gather against cammiq_tpu.cli --engine gather

def _write_db(root, gs):
    db = root / "fasta"
    db.mkdir()
    with open(root / "genome_map.out", "w") as m:
        for g, x in enumerate(gs):
            s = ALPHA[x].tobytes().decode()
            with open(db / f"genome{g + 1}.fasta", "w") as f:
                f.write(f">g{g + 1} contig1\n")
                f.writelines(s[i:i + 80] + "\n" for i in range(0, len(s), 80))
            m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
    return str(root / "genome_map.out"), str(db) + "/"


@pytest.fixture(scope="module")
def cli_toys(tmp_path_factory):
    """The verify-skill toy (5 random genomes x 2000 bp) and the pair toy
    (the same with a 300 bp segment planted in each pair of neighbours),
    indexed by cammiq_tpu.cli, with 1500 simulated reads each."""
    rng = np.random.default_rng(42)
    toys = {"toy": [rng.integers(0, 4, 2000) for _ in range(5)],
            "pairs": pair_genomes(5, glen=2000, seg=300)[0]}
    out = {}
    for name, gs in toys.items():
        root = tmp_path_factory.mktemp(f"gather_{name}")
        mapf, db = _write_db(root, gs)
        iu, idd = str(root / "index_u.npz"), str(root / "index_d.npz")
        jax_cli_main(["--build", "--both", "-f", mapf, "-D", db, "-k", "20",
                      "-L", "100", "-Lmax", "40", "-h", "20", "-i", iu, idd,
                      "--engine", "numpy"])
        fq = str(root / "reads.fq")
        simulate(mapf, db, fq, str(root / "truth.out"), num_reads=1500, L=100,
                 erate=0.01, dist="uniform", seed=3)
        out[name] = root, ["-f", mapf, "-i", iu, idd, "-q", fq, "-e", "0.01",
                           "--engine", "gather"]
    return out


@pytest.mark.parametrize("toy,mode", [("toy", "typeI"), ("toy", "quant"),
                                      ("pairs", "typeI"), ("pairs", "typeII"),
                                      ("pairs", "quant")])
def test_cli_gather_matches_jax_cli(cli_toys, toy, mode):
    root, args = cli_toys[toy]
    flags = {"typeI": ["--read_cnts"], "typeII": ["--read_cnts", "--doubly_unique"],
             "quant": []}[mode]
    ours, ref = root / f"{mode}_torch.out", root / f"{mode}_jax.out"
    cli_main(["--device", "cpu", "--query", *flags, *args, "-o", str(ours)])
    jax_cli_main(["--query", *flags, *args, "-o", str(ref)])
    if mode == "quant":
        got = {t: a for t, a, _ in parse_quant_output(str(ours))[0]["rows"]}
        want = {t: a for t, a, _ in parse_quant_output(str(ref))[0]["rows"]}
        assert sorted(got) == sorted(want) and len(want) >= 3
        assert sum(abs(got[t] - want[t]) for t in want) <= 1e-3
    else:
        assert ours.read_bytes() == ref.read_bytes()
        assert ours.read_text().startswith("QUERY/TAXID\t1000\t1001")
