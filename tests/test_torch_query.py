"""The port's query path against the JAX package on the same index and
reads: MatchSlots, case analysis and QueryCounts must be bit-identical."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cammiq_tpu.query.sortjoin as sj
from cammiq_tpu.config import BuildConfig, QueryConfig
from cammiq_tpu.index.artifact import load_merged_artifact, save_merged_artifact
from cammiq_tpu.index.builder import build_index
from cammiq_tpu.io.fasta import corpus_from_sequences
from cammiq_tpu.io.fastq import reads_from_arrays
from cammiq_tpu.query.classify import MatchSlots as JMatchSlots
from cammiq_tpu.query.classify import case_analysis as jax_case_analysis
from cammiq_tpu.query.pipeline import QuerySession as JaxSession
from cammiq_tpu_torch.query.classify import MatchSlots, case_analysis
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, collect_matches
from dist_fixture import make_dist_fixture
from torch_fixture import flat_table, large_bucket_index, rc

SLOT_FIELDS = ("slots", "rid1", "rid2", "in_u")

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


def _jax_slots(m, codes, lengths, maxm):
    ms, ovh, ovs = sj.collect_matches_sortjoin(
        sj.to_device_merged(m), jnp.asarray(codes), jnp.asarray(lengths),
        join="bloom", hit_capacity_frac=1, maxm=maxm)
    assert int(ovh) == 0
    return ms, int(ovs)


def _assert_slots_equal(port, jax_ms):
    for f in SLOT_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_ms, f)), err_msg=f)


@pytest.fixture(scope="module")
def dist_index():
    art, rs, G = make_dist_fixture(seed=13)
    return sj.build_merged_index(art.unique_index, art.doubly_index), rs, G


@pytest.mark.parametrize("maxm", [16, 2])
@pytest.mark.parametrize("unroll", [sj.BUCKET_SCAN_UNROLL, 0])
def test_match_slots_match_jax(dist_index, unroll, maxm, monkeypatch):
    """unroll=0 forces the JAX path used above max_bucket 8 (the
    segment-expanded scan over the 12-word cuckoo table); maxm=2 makes
    reads overflow their slots, which both count alike."""
    monkeypatch.setattr(sj, "BUCKET_SCAN_UNROLL", unroll)
    m, rs, _ = dist_index
    jax_ms, jax_ovs = _jax_slots(m, rs.codes, rs.lengths, maxm)
    mt = collect_matches(TorchMergedIndex.from_merged(m, "cpu"),
                         torch.from_numpy(rs.codes),
                         torch.from_numpy(rs.lengths), maxm)
    _assert_slots_equal(mt.slots, jax_ms)
    assert int(mt.overflow_slots) == jax_ovs
    assert (maxm == 2) == (jax_ovs > 0)


def test_match_slots_four_color_chain():
    """A 4-deep prefix chain (fwd-u < fwd-d < rc-u < rc-d), as in
    test_sortjoin_chains: n_colors >= 4, several matches at one offset."""
    rng = np.random.default_rng(123)
    h, kw = 26, 4
    P1 = list(rng.integers(0, 4, h))
    P2 = P1 + [1, 2]
    K3 = P2 + [0, 3]
    K4 = P2 + [0, 3, 2, 1]
    u_keys = [P1, rc(K3)] + [list(rng.integers(0, 4, int(rng.integers(h, 34))))
                              for _ in range(40)]
    d_keys = [P2, rc(K4)]

    m = sj.build_merged_index(flat_table(u_keys, False, h, kw),
                              flat_table(d_keys, True, h, kw))
    assert m.n_colors >= 4
    reads = rng.integers(0, 4, size=(64, 100)).astype(np.int8)
    for b, s in enumerate([K4, K3, P2, P1, rc(K4), rc(P1)] * 4):
        off = int(rng.integers(0, 100 - len(s)))
        reads[b, off:off + len(s)] = s
    lengths = np.full(64, 100, np.int32)
    jax_ms, _ = _jax_slots(m, reads, lengths, 16)
    mt = collect_matches(TorchMergedIndex.from_merged(m, "cpu"),
                         torch.from_numpy(reads), torch.from_numpy(lengths), 16)
    _assert_slots_equal(mt.slots, jax_ms)
    assert int((mt.slots.slots[0] < (1 << 30)).sum()) >= 4


def test_match_slots_large_bucket():
    """One bucket spans more than BUCKET_SCAN_UNROLL entries, so JAX takes
    its segment-expanded scan on its own; the port's one loop form must
    agree."""
    m, reads, lengths = large_bucket_index()
    assert m.max_bucket > sj.BUCKET_SCAN_UNROLL
    jax_ms, _ = _jax_slots(m, reads, lengths, 16)
    mt = collect_matches(TorchMergedIndex.from_merged(m, "cpu"),
                         torch.from_numpy(reads), torch.from_numpy(lengths), 16)
    _assert_slots_equal(mt.slots, jax_ms)
    assert int((mt.slots.slots < (1 << 30)).any(1).sum()) > 24


@pytest.mark.parametrize("sc_mode", [False, True])
def test_case_analysis_matches_jax(dist_index, sc_mode):
    m, rs, G = dist_index
    jax_ms, _ = _jax_slots(m, rs.codes, rs.lengths, 16)
    # extra rows: an assigned pair, conflicts and an empty read
    extra = np.full((4, 16), np.iinfo(np.int32).max, np.int32)
    extra_r1 = np.zeros((4, 16), np.int32)
    extra_r2 = np.zeros((4, 16), np.int32)
    extra[0, :2], extra_r1[0, :2], extra_r2[0, :2] = [7, 9], [1, 1], [2, 2]
    extra[1, :2], extra_r1[1, :2], extra_r2[1, :2] = [3, 5], [1, 2], [0, 0]
    extra[2, :3], extra_r1[2, :3], extra_r2[2, :3] = [3, 7, 8], [1, 2, 1], [0, 3, 3]
    cols = [np.concatenate([np.asarray(getattr(jax_ms, f)), e])
            for f, e in zip(("slots", "rid1", "rid2"), (extra, extra_r1, extra_r2))]
    lengths = np.concatenate([rs.lengths, [60, 60, 60, 0]]).astype(np.int32)
    ms_j = JMatchSlots(*map(jnp.asarray, cols),
                       in_u=jnp.asarray(cols[0] < m.eu))
    ms_t = MatchSlots(*map(torch.from_numpy, cols),
                      in_u=torch.from_numpy(cols[0] < m.eu))
    want = jax_case_analysis(ms_j, jnp.asarray(lengths), G, sc_mode=sc_mode)
    got = case_analysis(ms_t, torch.from_numpy(lengths), G, sc_mode=sc_mode)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.assigned.sum()) > 0 and int(got.nconf) > 0


ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def session_setup():
    """test_sortjoin.py's 5-genome index with a shared segment and 300
    noisy reads of both strands, plus the JAX session's counts."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 4, 150)
    genomes = []
    for _ in range(5):
        own = rng.integers(0, 4, 500)
        ins = int(rng.integers(0, 350))
        genomes.append([ALPHA[np.concatenate([own[:ins], shared, own[ins:]])].tobytes()])
    art = build_index(corpus_from_sequences(genomes),
                      BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both"),
                      engine="numpy")
    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    reads = []
    for _ in range(300):
        c = genomes[int(rng.integers(0, 5))][0]
        p = int(rng.integers(0, len(c) - 60))
        r = bytearray(c[p:p + 60])
        if rng.random() < 0.5:
            r = bytearray(comp[b] for b in reversed(r))
        for i in range(60):
            if rng.random() < 0.02:
                r[i] = int(ALPHA[rng.integers(0, 4)])
        reads.append(bytes(r))
    rs = reads_from_arrays(reads, max_len=64)
    G = 6
    cfg = QueryConfig(h=12, batch_size=128)
    want = JaxSession(art.unique_index, art.doubly_index, G, cfg,
                      engine="sortjoin").run(rs)
    return art, rs, G, cfg, want


COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")


def _assert_counts_equal(got, want):
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.num_reads, got.mean_read_len) == (
        want.nundet, want.nconf, want.num_reads, want.mean_read_len)


@pytest.mark.parametrize("maxm", [16, 1])
def test_session_npz_matches_jax(session_setup, maxm):
    """maxm=1 starts below the reads' distinct-match count, so the pass
    overflows and re-runs at a doubled (sticky) maxm."""
    art, rs, G, cfg, want = session_setup
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device="cpu")
    sess.maxm = maxm
    _assert_counts_equal(sess.run(rs), want)
    assert sess.maxm >= 2
    assert want.cnts_u.sum() > 0 and want.rcount_d.sum() > 0


def test_session_artifact_matches_jax(session_setup, tmp_path):
    art, rs, G, cfg, want = session_setup
    m = sj.build_merged_index(art.unique_index, art.doubly_index)
    save_merged_artifact(m, art.unique_index, art.doubly_index, str(tmp_path))
    artifact = load_merged_artifact(str(tmp_path))
    sess = QuerySession.from_artifact(artifact, G, cfg, device="cpu")
    _assert_counts_equal(sess.run(rs), want)
    # an artifact without bloom and cuckoo tables: both are built in memory
    bare = dataclasses.replace(artifact, bloom=None, bloom_log=0, cuckoo=None,
                               cuckoo_log=0)
    _assert_counts_equal(QuerySession.from_artifact(bare, G, cfg, device="cpu")
                         .run(rs), want)


def test_session_unique_only_matches_jax(session_setup):
    art, rs, G, cfg, _ = session_setup
    want = JaxSession(art.unique_index, None, G, cfg, engine="sortjoin").run(rs)
    got = QuerySession(art.unique_index, None, G, cfg, device="cpu").run(rs)
    _assert_counts_equal(got, want)


def test_session_sc_mode_not_ported(session_setup):
    art, rs, G, cfg, _ = session_setup
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        sess.run(rs, sc_mode=True)
