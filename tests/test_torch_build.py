"""The port's device index build against the JAX device engine on the CPU:
every stage bit-identical to its twin (``ops/sa.py``, ``ops/lcp.py``,
``index/unique_jax.py``), and the whole index identical to
``cammiq_tpu`` ``build_index(engine="jax")``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cammiq_tpu.config import BuildConfig
from cammiq_tpu.index import unique_jax as uj
from cammiq_tpu.index.builder import build_index as jax_build_index
from cammiq_tpu.io.fasta import corpus_from_sequences
from cammiq_tpu.ops.lcp import LCP_CLAMP, lcp_jax, lcp_kasai_scalar
from cammiq_tpu.ops.sa import suffix_array_jax
from cammiq_tpu_torch.index import unique as uq
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.kernels.lcp_pairs import lcp_pairs, lcp_pairs_plain
from cammiq_tpu_torch.kernels.occ_count import occ_count_doubly, occ_count_unique
from cammiq_tpu_torch.ops.sa import suffix_array
from cammiq_tpu_torch.ops.scans import segmented_cummin, segmented_cummin_rev
from torch_fixture import ALPHA, pair_corpus

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

EL, ULMAX = 9, 60


def make_corpus(rng, ng=4, cl=150, sf=0.4):
    """test_unique_jax.py's corpus: ng genomes of cl random bases, each with
    one segment shared by all of them."""
    shared = rng.integers(0, 4, int(cl * sf))
    gs = []
    for _ in range(ng):
        own = rng.integers(0, 4, cl)
        ins = int(rng.integers(0, cl - len(shared)))
        gs.append([ALPHA[np.concatenate([own[:ins], shared, own[ins:]])].tobytes()])
    return corpus_from_sequences(gs)


def t(a):
    return torch.from_numpy(np.array(a))


def eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.fixture(scope="module", params=[0, 1, 2])
def stages(request):
    """Both packages' stage outputs on one seeded corpus."""
    corpus = make_corpus(np.random.default_rng(request.param))
    s = corpus.seq
    n = len(s)
    sa_j = suffix_array_jax(s)
    lcp_j = lcp_jax(s, sa_j, max_lcp=LCP_CLAMP)
    gsa_j = uj.compute_gsa_jax(sa_j, jnp.asarray(corpus.ref_pos, jnp.int64),
                               jnp.asarray(corpus.ref_id, jnp.int32))
    lcp0_j = uj.unique_lcp0_jax(gsa_j, lcp_j, EL)
    dl_j, g2_j = uj.doubly_lcp0_jax(sa_j, gsa_j, lcp_j, EL, ULMAX)
    jx = dict(sa=sa_j, lcp=lcp_j, gsa=gsa_j, lcp0=lcp0_j, dl=dl_j, g2=g2_j)
    jx = {k: np.asarray(v) for k, v in jx.items()}
    return corpus, n, jx


def test_suffix_array_matches_jax(stages):
    corpus, _, jx = stages
    eq(suffix_array(t(corpus.seq)), jx["sa"])


def test_suffix_array_stops_early():
    """The JAX engine runs ceil(log2 n) rounds; stopping once the ranks are
    distinct gives the same array, also on repeats and on tiny inputs."""
    rng = np.random.default_rng(5)
    for s in (np.zeros(1, np.uint8), np.array([3, 1], np.uint8),
              np.full(37, 7, np.uint8), np.tile(np.array([1, 2, 3], np.uint8), 20),
              rng.integers(0, 4, 300).astype(np.uint8)):
        eq(suffix_array(t(s)), np.asarray(suffix_array_jax(s)))


def test_lcp_pairs_plain_matches_jax(stages):
    corpus, _, jx = stages
    got = lcp_pairs(t(corpus.seq), t(jx["sa"]))
    eq(got, jx["lcp"])
    assert int(got.max()) > 32   # the shared segment outruns the first block


def test_lcp_pairs_plain_long_and_clamped():
    """One LCP longer than the first block (32) and more, and the same text
    with a clamp that the long LCPs reach."""
    rng = np.random.default_rng(11)
    rep = rng.integers(0, 4, 700).astype(np.uint8)
    s = np.concatenate([rep, rng.integers(0, 4, 50).astype(np.uint8), rep,
                        np.array([9], np.uint8)])
    sa = np.asarray(suffix_array_jax(s))
    want = lcp_kasai_scalar(s, sa)
    assert want.max() >= 700
    eq(lcp_pairs_plain(t(s), t(sa)), want)
    eq(lcp_pairs_plain(t(s), t(sa), clamp=100), np.minimum(want, 100))
    eq(lcp_pairs_plain(t(s), t(sa), clamp=100),
       np.asarray(lcp_jax(s, sa, max_lcp=100)))
    # a run of ranks alone, as the card checks compare them
    eq(lcp_pairs_plain(t(s), t(sa[200:500])), np.concatenate([[0], want[201:500], [0]]))


def test_segmented_cummin_matches_jax():
    from cammiq_tpu.ops.scans_jax import segmented_cummin_jax, segmented_cummin_rev_jax

    rng = np.random.default_rng(4)
    v = rng.integers(0, 1000, 500).astype(np.int32)
    for starts in (rng.random(500) < 0.1, np.zeros(500, bool)):
        eq(segmented_cummin(t(v), t(starts)),
           np.asarray(segmented_cummin_jax(jnp.asarray(v), jnp.asarray(starts))))
        eq(segmented_cummin_rev(t(v), t(starts)),
           np.asarray(segmented_cummin_rev_jax(jnp.asarray(v), jnp.asarray(starts))))


def test_gsa_and_lcp0_match_jax(stages):
    corpus, _, jx = stages
    gsa = uq.compute_gsa(t(jx["sa"]), corpus.ref_pos, corpus.ref_id)
    eq(gsa, jx["gsa"], "gsa")
    eq(uq.unique_lcp0(gsa, t(jx["lcp"]), EL), jx["lcp0"], "unique lcp0")
    dl, g2 = uq.doubly_lcp0(t(jx["sa"]), gsa, t(jx["lcp"]), EL, ULMAX)
    eq(dl, jx["dl"], "doubly lcp0")
    eq(g2, jx["g2"], "gsa2_text")
    assert int(g2.count_nonzero()) > 0


@pytest.mark.parametrize("ulmax", [None, ULMAX])
def test_min_unique_matches_jax(stages, ulmax):
    corpus, n, jx = stages
    lcp0 = jx["lcp0"] if ulmax is None else jx["dl"]
    want = uj.min_unique_jax(jnp.asarray(jx["sa"]), jnp.asarray(lcp0), n, ulmax=ulmax)
    eq(uq.min_unique(t(jx["sa"]), t(lcp0), n, ulmax=ulmax), np.asarray(want))


def test_occ_matches_jax(stages):
    corpus, _, jx = stages
    sa, gsa, lcp = (t(jx[k]) for k in ("sa", "gsa", "lcp"))
    want = uj.occ_unique_jax(*(jnp.asarray(jx[k]) for k in ("sa", "gsa", "lcp", "lcp0")))
    got = uq.occ_unique(sa, gsa, lcp, t(jx["lcp0"]))
    eq(got, np.asarray(want), "occ_unique")
    wd, wd2 = uj.occ_doubly_jax(*(jnp.asarray(jx[k]) for k in
                                  ("sa", "gsa", "g2", "lcp", "dl")), ULMAX)
    gd, gd2 = uq.occ_doubly(sa, gsa, t(jx["g2"]), lcp, t(jx["dl"]), ULMAX)
    eq(gd, np.asarray(wd), "occ_doubly")
    eq(gd2, np.asarray(wd2), "occ2_doubly")
    assert int(gd.count_nonzero()) > 0


def test_occ_count_walks_saturate():
    """One genome of 500 equal ranks with LCPs above lcp0: both walks run
    to their step bounds and saturate at 255, and the doubly walk stops
    at end_excl going down."""
    n = 600
    gsa = torch.ones(n, dtype=torch.int32)
    gsa[:100] = 2
    lcp = torch.full((n + 1,), 50, dtype=torch.int32)
    lcp[0] = lcp[n] = 0
    lcp0 = torch.full((n,), 20, dtype=torch.int32)
    occ = occ_count_unique(lcp, lcp0, gsa)
    assert int(occ[300]) == 255 and int(occ[0]) == 100
    g2 = torch.full((n,), 2, dtype=torch.int32)
    o1, o2 = occ_count_doubly(lcp, lcp0, gsa, g2, 60, 99)
    assert int(o1[300]) == 255 and int(o2[150]) == 1 and int(o1[99]) == 0
    assert int(o2[105]) == 1 and int(o1[105]) == 255


@pytest.fixture(scope="module")
def both_builds():
    corpus = pair_corpus(3)
    cfg = BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both")
    return cfg, corpus, jax_build_index(corpus, cfg, engine="jax")


INDEX_FIELDS = ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2")


def test_build_index_matches_jax_engine(both_builds):
    cfg, corpus, want = both_builds
    got = build_index(corpus, cfg, device="cpu")
    for name in ("unique_index", "doubly_index"):
        g, w = getattr(got, name), getattr(want, name)
        for f in INDEX_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(got.ulm_count_u, want.ulm_count_u)
    np.testing.assert_array_equal(got.ulm_count_d, want.ulm_count_d)
    np.testing.assert_array_equal(got.genome_lengths, want.genome_lengths)
    assert want.doubly_index.num_entries > 0
    assert [s for s, _ in got.timings.records] == [s for s, _ in want.timings.records]


def test_build_index_rejects_occ_u8_wrap(both_builds):
    _, corpus, _ = both_builds
    cfg = BuildConfig(k=12, L=60, Lmax=30, h=12, mode="unique", occ_u8_wrap=True)
    with pytest.raises(ValueError, match="occ_u8_wrap"):
        build_index(corpus, cfg, device="cpu")
