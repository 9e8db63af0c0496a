"""The port's host build engines against ``cammiq_tpu`` on the CPU: every
native binding bit-identical to the JAX package's numpy twin, the bounded
sort a valid bounded order, ``build_index(engine="native"|"numpy")`` equal
to ``cammiq_tpu``'s with the same engine, stage directories resumed across
the packages, and the port's device build equal to the JAX CLI's default
(the native bounded sort).  Exact equality everywhere.

The port's native tests gate on the port's own ``native`` (built under a
lock), never on ``cammiq_tpu.native``, which test workers can find
half-written; the JAX native engine is a reference only where it loaded in
the same test, the JAX numpy engines always."""

import numpy as np
import pytest
import torch

import cammiq_tpu.index.builder as jbuilder
import cammiq_tpu.native as jnative
from cammiq_tpu.config import BuildConfig as JaxBuildConfig
from cammiq_tpu.index import unique as ju
from cammiq_tpu.index.builder import build_index as jax_build_index
from cammiq_tpu.index.staging import StageStore as JaxStageStore
from cammiq_tpu.io.fasta import corpus_from_sequences as jax_corpus
from cammiq_tpu.ops.lcp import lcp_from_sa_numpy
from cammiq_tpu.ops.sa import suffix_array_numpy
from cammiq_tpu_torch import native
from cammiq_tpu_torch.config import BuildConfig
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.index.staging import StageStore
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.ops import sa as tsa
from torch_fixture import ALPHA

# small tensors: intra-op threads would only contend with other test workers
# (this also caps the native sorts' OpenMP threads in this process)
torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="port native library not built")
needs_bsort = pytest.mark.skipif(not (native.available() and native.has_bsort()),
                                 reason="port native bounded sort not built")

INDEX_FIELDS = ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
                "table_lo", "table_hi", "table_start", "table_count")
INDEX_STATICS = ("h", "kw", "max_probes", "max_bucket", "is_doubly")


def assert_same_artifacts(got, want, what=""):
    """Every FlatIndex array and static, the ulm counts and genome lengths."""
    for name in ("unique_index", "doubly_index"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), f"{what} {name}"
        if w is None:
            continue
        for f in INDEX_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}.{f}")
            assert a.dtype == b.dtype, f"{what} {name}.{f}"
        for f in INDEX_STATICS:
            assert getattr(g, f) == getattr(w, f), f"{what} {name}.{f}"
    for f in ("ulm_count_u", "ulm_count_d", "genome_lengths"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f"{what} {f}"
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def shared_genomes(rng, num=5, glen=400, shared_len=150, nctg=1):
    """Genomes of random bases, each with one segment shared by all of them
    (test_native.py's corpus), split into ``nctg`` contigs."""
    shared = rng.integers(0, 4, size=shared_len)
    genomes = []
    for _ in range(num):
        own = rng.integers(0, 4, size=glen)
        ins = int(rng.integers(0, glen - 1))
        seq = ALPHA[np.concatenate([own[:ins], shared, own[ins:]])].tobytes()
        k = max(len(seq) // nctg, 1)
        genomes.append([seq[i * k:(i + 1) * k] for i in range(nctg)])
    return genomes


# ---- native bindings against the JAX package's numpy engines

@needs_native
@pytest.mark.parametrize("n,sigma", [(1, 2), (2, 2), (64, 2), (1000, 4),
                                     (5000, 3), (20000, 4)])
def test_native_suffix_array_matches_numpy(n, sigma):
    s = np.random.default_rng(n).integers(0, sigma, size=n).astype(np.uint8) + 230
    np.testing.assert_array_equal(native.suffix_array(s), suffix_array_numpy(s))


@needs_native
@pytest.mark.parametrize("kind", ["repetitive", "corpus"])
def test_native_suffix_array_special_texts(kind):
    if kind == "repetitive":
        s = np.frombuffer(b"abcabcabcabc" * 100 + b"xy", dtype=np.uint8)
    else:   # offset bases, separator bytes with zeros
        s = corpus_from_sequences(shared_genomes(np.random.default_rng(3), 3)).seq
    np.testing.assert_array_equal(native.suffix_array(s), suffix_array_numpy(s))


@needs_native
@pytest.mark.parametrize("n,sigma", [(2, 2), (1000, 2), (5000, 4)])
def test_native_lcp_kasai_matches_numpy(n, sigma):
    s = np.random.default_rng(n + 7).integers(0, sigma, size=n).astype(np.uint8) + 230
    sa = suffix_array_numpy(s)
    got = native.lcp_kasai(s, sa)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, lcp_from_sa_numpy(s, sa))


def _pipeline(seed, num, glen):
    corpus = corpus_from_sequences(shared_genomes(np.random.default_rng(seed),
                                                  num, glen, int(glen * 0.4)))
    sa = suffix_array_numpy(corpus.seq)
    return corpus, sa


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_sweeps_unique_match_jax_numpy(seed):
    """kasai_u16, gsa32, unique_lcp0_32, occ_unique_u8, min_unique_u16
    against ``cammiq_tpu/index/unique.py``'s numpy engine."""
    corpus, sa = _pipeline(100 + seed, 4, 400)
    n = corpus.n
    lcp64 = lcp_from_sa_numpy(corpus.seq, sa)
    lcp16 = native.kasai_u16(corpus.seq, sa)
    assert lcp16.dtype == np.uint16
    np.testing.assert_array_equal(lcp16.astype(np.int64), np.minimum(lcp64, 0xFFFF))
    gsa = ju.compute_gsa(sa, corpus.ref_pos, corpus.ref_id)
    gsa32 = native.gsa32(sa, corpus.ref_pos, corpus.ref_id)
    np.testing.assert_array_equal(gsa32.astype(np.int64), gsa)
    l0 = ju.unique_lcp0(gsa, lcp64, 11)
    l0_32 = native.unique_lcp0_32(gsa32, lcp16, 11)
    np.testing.assert_array_equal(l0_32.astype(np.int64), l0)
    for wrap in (False, True):
        np.testing.assert_array_equal(
            native.occ_unique_u8(sa, gsa32, lcp16, l0_32, wrap=wrap).astype(np.int64),
            ju.occ_unique(sa, gsa, lcp64, l0, wrap_u8=wrap))
    np.testing.assert_array_equal(native.min_unique_u16(sa, l0_32, n).astype(np.int64),
                                  ju.min_unique(sa, l0, n))


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_sweeps_doubly_match_jax_numpy(seed):
    """doubly_lcp0_32, occ_doubly_u8 and min_unique_u16 (ulmax) against the
    numpy engine."""
    corpus, sa = _pipeline(200 + seed, 5, 350)
    n = corpus.n
    lcp64 = lcp_from_sa_numpy(corpus.seq, sa)
    lcp16 = native.kasai_u16(corpus.seq, sa)
    gsa = ju.compute_gsa(sa, corpus.ref_pos, corpus.ref_id)
    gsa32 = native.gsa32(sa, corpus.ref_pos, corpus.ref_id)
    el, ulmax = 11, 100
    d = ju.doubly_lcp0(sa, gsa, lcp64, el, ulmax)
    l0, g2 = native.doubly_lcp0_32(sa, gsa32, lcp16, el, ulmax)
    np.testing.assert_array_equal(l0.astype(np.int64), d.lcp0)
    np.testing.assert_array_equal(g2.astype(np.int64), d.gsa2)
    for wrap in (False, True):
        occ, occ2 = native.occ_doubly_u8(sa, gsa32, g2, lcp16, l0, ulmax, wrap=wrap)
        want, want2 = ju.occ_doubly(sa, gsa, d.gsa2, lcp64, d.lcp0, ulmax, wrap_u8=wrap)
        np.testing.assert_array_equal(occ.astype(np.int64), want)
        np.testing.assert_array_equal(occ2.astype(np.int64), want2)
    np.testing.assert_array_equal(
        native.min_unique_u16(sa, l0, n, ulmax=ulmax).astype(np.int64),
        ju.min_unique(sa, d.lcp0, n, ulmax=ulmax))


def _window_rows(seq, sa, depth):
    """The first ``depth`` bytes of each suffix, -1 past the end of text
    (so a shorter suffix sorts first, the sorters' virtual sentinel)."""
    n = seq.shape[0]
    idx = sa[:, None] + np.arange(depth)[None, :]
    return np.where(idx < n, seq[np.minimum(idx, n - 1)].astype(np.int32), -1)


def assert_bounded_order(seq, depth, sa=None):
    """``sa`` (the port's bounded sort by default) is a permutation whose
    first ``depth`` bytes run as the JAX package's full sort's do, and
    ``bounded_lcp_u16`` is the adjacent LCP of that order clamped at
    ``depth``."""
    n = seq.shape[0]
    bsa = native.bounded_sa(seq, depth) if sa is None else sa
    assert bsa.dtype == np.int64
    np.testing.assert_array_equal(np.sort(bsa), np.arange(n))
    rows = _window_rows(seq, bsa, depth)
    np.testing.assert_array_equal(rows, _window_rows(seq, suffix_array_numpy(seq), depth))
    blcp = native.bounded_lcp_u16(seq, bsa, depth)
    assert blcp.dtype == np.uint16 and blcp[0] == 0 and blcp[n] == 0
    neq = rows[1:] != rows[:-1]
    want = np.where(neq.any(axis=1), np.argmax(neq, axis=1), depth)
    # a run of -1 (both suffixes ended) is no common byte
    ended = np.minimum(n - bsa[1:], n - bsa[:-1])
    np.testing.assert_array_equal(blcp[1:n].astype(np.int64), np.minimum(want, ended))


def _bounded_text(kind, rng):
    if kind == "random":
        return ALPHA[rng.integers(0, 4, size=3000)].copy()
    if kind == "separators":       # base runs and 4-byte separators with zeros
        parts = []
        for c in range(6):
            parts.append(ALPHA[rng.integers(0, 4, size=400)])
            parts.append(np.array([0, 0, c // 128, c % 128], dtype=np.uint8))
        return np.concatenate(parts)
    if kind == "deep_repeats":     # repeats far longer than the depth bound
        unit = ALPHA[rng.integers(0, 4, size=300)]
        return np.concatenate([np.tile(unit, 20), ALPHA[rng.integers(0, 4, size=500)],
                               np.tile(unit, 7)])
    if kind == "iupac":            # non-ACGT letters between the base values
        seq = ALPHA[rng.integers(0, 4, size=4000)].copy()
        pos = rng.choice(4000, size=120, replace=False)
        iupac = np.frombuffer(b"NRYWSKMBDHVU", dtype=np.uint8)
        seq[pos] = iupac[rng.integers(0, len(iupac), size=120)]
        return seq
    if kind == "corpus":           # a real corpus: offsets, separators, rc
        return corpus_from_sequences(shared_genomes(rng, 4, 500)).seq
    return ALPHA[rng.integers(0, 2, size=60)].copy()   # end of text


@needs_bsort
@pytest.mark.parametrize("depth", [96, 128])
@pytest.mark.parametrize("kind", ["random", "separators", "deep_repeats", "iupac",
                                  "corpus", "end_of_text"])
def test_bounded_sa_is_a_bounded_order(kind, depth):
    assert_bounded_order(_bounded_text(kind, np.random.default_rng(len(kind))), depth)


# ---- build_index on the host engines against cammiq_tpu's

def _cfgs(**kw):
    return BuildConfig(**kw), JaxBuildConfig(**kw)


@pytest.fixture(scope="module")
def host_corpus():
    genomes = shared_genomes(np.random.default_rng(21), 5, 400, 150, nctg=2)
    return corpus_from_sequences(genomes), jax_corpus(genomes)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", ["unique", "doubly_unique", "both"])
@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_host_build_matches_jax(host_corpus, engine, mode, groups, bounded):
    """The port's host build against ``cammiq_tpu``'s numpy engine, and
    against its native engine where that loaded here."""
    if engine == "native" and not native.available():
        pytest.skip(f"port native library not built: {native.build_error()}")
    tc, jc = host_corpus
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=30, h=14, mode=mode, num_groups=groups,
                      bounded_sa=bounded)
    got = build_index(tc, cfg, engine=engine)
    assert_same_artifacts(got, jax_build_index(jc, jcfg, engine="numpy"), "vs numpy")
    if engine == "native" and jnative.has_bsort():
        assert_same_artifacts(got, jax_build_index(jc, jcfg, engine="native"),
                              "vs native")
    assert (got.unique_index is not None) == (mode != "doubly_unique")
    assert got.timings.total() > 0


def test_native_engine_falls_back_to_numpy(host_corpus, monkeypatch, capsys):
    """Without the library, engine "native" runs the numpy engine and says
    so, as ``cammiq_tpu`` falls back (builder.py:45-56)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_ERROR", "no compiler")
    tc, jc = host_corpus
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=30, h=14)
    got = build_index(tc, cfg, engine="native", verbose=True)
    assert "build engine: numpy (native library unavailable: no compiler), host" \
        in capsys.readouterr().err
    assert_same_artifacts(got, jax_build_index(jc, jcfg, engine="numpy"))


def test_device_engine_refuses_2e31_positions():
    """A corpus of 2^31 positions raises before any device work (even with
    no card) and names the host engines; it never switches engine."""
    from cammiq_tpu_torch.io.fasta import Corpus

    seq = np.broadcast_to(np.uint8(ALPHA[0]), (2**31,))   # no memory behind it
    corpus = Corpus(seq=seq, contig_pos=np.array([2**31], np.uint64),
                    ref_pos=np.array([2**31], np.uint64),
                    ref_id=np.array([1], np.uint32), filenames=["big"])
    for engine in ("device", "auto", "jax"):
        with pytest.raises(ValueError, match=r"--engine native.*--build_hosts"):
            build_index(corpus, BuildConfig(), device="cuda", engine=engine)


# ---- stage directories resumed across the packages

STAGE_CFG = dict(k=14, L=80, Lmax=30, h=14, mode="both")


def _no_call(name):
    def fail(*a, **k):
        raise AssertionError(f"{name} ran: the stage was not resumed")
    return fail


@pytest.mark.parametrize("resumer", ["device", "native_exact", "native_bounded"])
def test_port_resumes_jax_stages(host_corpus, tmp_path, monkeypatch, resumer):
    """``cammiq_tpu`` writes a stage directory up to the suffix array; the
    port's build resumes from it (its own sort is made to fail) and gives
    the index of a fresh build."""
    if resumer != "device" and not native.available():
        pytest.skip("port native library not built")
    if resumer == "native_bounded" and not native.has_bsort():
        pytest.skip("port native bounded sort not built")
    tc, jc = host_corpus
    cfg, jcfg = _cfgs(bounded_sa=resumer == "native_bounded", **STAGE_CFG)
    d = str(tmp_path / "stages")
    if resumer == "native_bounded":
        # the bounded sort's stage, written by the JAX package's store
        JaxStageStore(d).save(f"bsa{cfg.sa_depth}",
                              native.bounded_sa(jc.seq, cfg.sa_depth))
    else:
        jax_build_index(jc, jcfg, engine="numpy", stage_dir=d)
        JaxStageStore(d).delete("lcp")
    assert list(JaxStageStore(d).manifest) == (
        [f"bsa{cfg.sa_depth}"] if resumer == "native_bounded" else ["sa"])
    engine = "device" if resumer == "device" else "native"
    fresh = build_index(tc, cfg, device="cpu", engine=engine)
    monkeypatch.setattr(tsa, "suffix_array", _no_call("suffix_array"))
    monkeypatch.setattr(native, "suffix_array", _no_call("native.suffix_array"))
    monkeypatch.setattr(native, "bounded_sa", _no_call("native.bounded_sa"))
    got = build_index(tc, cfg, device="cpu", engine=engine, stage_dir=d)
    assert_same_artifacts(got, fresh)
    assert_same_artifacts(got, jax_build_index(jc, jcfg, engine="numpy"))
    want = {"device": {"sa", "lcp"}, "native_exact": {"sa", "lcp16"},
            "native_bounded": {f"bsa{cfg.sa_depth}", f"blcp16_{cfg.sa_depth}"}}
    assert set(StageStore(d).manifest) == want[resumer]


@pytest.mark.parametrize("writer", ["device", "native_exact", "native_bounded"])
def test_jax_resumes_port_stages(host_corpus, tmp_path, monkeypatch, writer):
    """The reverse: the port writes the stages; ``cammiq_tpu`` resumes from
    them where the names coincide: its numpy engine from the device build's
    ``sa`` and ``lcp`` (both) and from the native SA-IS build's ``sa``, its
    native engine from the bounded sort's stages where it loaded here."""
    if writer != "device" and not native.available():
        pytest.skip("port native library not built")
    if writer == "native_bounded" and not native.has_bsort():
        pytest.skip("port native bounded sort not built")
    tc, jc = host_corpus
    cfg, jcfg = _cfgs(bounded_sa=writer == "native_bounded", **STAGE_CFG)
    d = str(tmp_path / "stages")
    engine = "device" if writer == "device" else "native"
    mine = build_index(tc, cfg, device="cpu", engine=engine, stage_dir=d)
    store = JaxStageStore(d)
    if writer == "device":
        assert store.load("sa").dtype == np.int64 and store.load("lcp").dtype == np.int64
        assert store.load("lcp").shape == (tc.n + 1,)
    monkeypatch.setattr(jbuilder, "suffix_array_numpy", _no_call("suffix_array_numpy"))
    if writer == "device":
        monkeypatch.setattr(jbuilder, "lcp_from_sa_numpy", _no_call("lcp_from_sa_numpy"))
    if writer == "native_bounded":
        assert set(store.manifest) == {f"bsa{cfg.sa_depth}", f"blcp16_{cfg.sa_depth}"}
        if not jnative.has_bsort():
            return      # the JAX native engine did not load in this worker
        monkeypatch.setattr(jnative, "bounded_sa", _no_call("bounded_sa"))
        got = jax_build_index(jc, jcfg, engine="native", stage_dir=d)
    else:
        got = jax_build_index(jc, jcfg, engine="numpy", stage_dir=d)
    assert_same_artifacts(mine, got)


# ---- the port's device build against the JAX CLI's default build

def _adversarial(seed, num=8, glen=6000, repeat_len=800):
    """test_bounded_sa.py's genomes: a shared repeat far longer than the
    sort depth, at contig starts, flush at contig ends, and inside."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 4, size=repeat_len)
    genomes = []
    for g in range(num):
        own = rng.integers(0, 4, size=glen)
        if g % 3 == 0:
            own[:repeat_len] = shared
        elif g % 3 == 1:
            own[-repeat_len:] = shared
        else:
            at = int(rng.integers(0, glen - repeat_len))
            own[at:at + repeat_len] = shared
        genomes.append([ALPHA[own].tobytes()])
    return genomes


def _strain_family():
    """test_bounded_sa.py's 99%-identical strains."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=20000)
    genomes = []
    for _ in range(6):
        v = base.copy()
        pos = rng.choice(v.shape[0], size=200, replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=200)) % 4
        genomes.append([ALPHA[v].tobytes()])
    return genomes


@needs_bsort
@pytest.mark.parametrize("corpus_name", ["adversarial_0", "adversarial_1",
                                         "adversarial_2", "strain_family"])
def test_device_build_matches_default_bounded_build(corpus_name):
    """The port's device build (a full sort, on the CPU device) against the
    default build of ``cammiq_tpu.cli --build`` (``--engine auto``: the
    native bounded sort) on test_bounded_sa.py's corpora; the port's native
    engine on the same corpora.  The JAX native engine is the reference
    where it loaded here, else its copy in the port (held to it above)."""
    genomes = (_strain_family() if corpus_name == "strain_family"
               else _adversarial(int(corpus_name[-1])))
    tc, jc = corpus_from_sequences(genomes), jax_corpus(genomes)
    cfg, jcfg = _cfgs(k=11, L=36, Lmax=24, h=11, mode="both")
    assert cfg.bounded_sa and jcfg.bounded_sa
    port_native = build_index(tc, cfg, engine="native")
    if jnative.has_bsort():
        assert_same_artifacts(port_native, jax_build_index(jc, jcfg, engine="auto"),
                              "port native vs JAX default")
    device = build_index(tc, cfg, device="cpu", engine="device")
    assert_same_artifacts(device, port_native, "port device vs bounded")
    assert device.unique_index.num_entries > 0
