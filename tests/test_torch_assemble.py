"""The sort join's match assembly (``kernels/match_assemble.py``) on the
CPU: its plain version against the JAX package's assembly on the same
index and reads, and against a numpy oracle on synthetic match lists;
the result must not depend on the order of the list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cammiq_tpu.query.sortjoin as sj
import cammiq_tpu_torch.query.sortjoin as tsj
from cammiq_tpu_torch.kernels import match_assemble as kma
from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_verify
from cammiq_tpu_torch.kernels.probe_bloom import num_offsets, probe_bloom
from cammiq_tpu_torch.query.sortjoin import (TorchMergedIndex, collect_matches,
                                             match_capacity)
from dist_fixture import make_dist_fixture
from torch_fixture import (MATCH_CASES, assemble_oracle, large_bucket_index,
                           match_list)

SLOT_FIELDS = ("slots", "rid1", "rid2", "in_u")

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


def _dist():
    art, rs, _ = make_dist_fixture(seed=13)
    return (sj.build_merged_index(art.unique_index, art.doubly_index),
            rs.codes, rs.lengths)


INDEXES = {"dist": _dist, "large_bucket": large_bucket_index}


@pytest.fixture(scope="module", params=sorted(INDEXES))
def index_reads(request):
    return INDEXES[request.param]()


def _port_list(m, codes, lengths):
    """The port's match list for the reads (CPU kernels' plain versions)
    at the list's full capacity, and the assembly's arguments."""
    dm = TorchMergedIndex.from_merged(m, "cpu")
    codes, lengths = torch.from_numpy(codes), torch.from_numpy(lengths)
    B, Lp = codes.shape
    O = num_offsets(Lp, dm.h)
    rows, keys, n = probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
    mrow, me, counts = cuckoo_verify(rows, keys, n, codes, lengths, dm.cuckoo,
                                     dm.cuckoo_log, dm.erec, dm.n_colors,
                                     match_capacity(B * O, dm.n_colors, 0))
    return mrow, me, counts, dm.prec, O, B, dm.eu


def _shuffled(mrow, me, counts, seed):
    """The list with its valid prefix in another order."""
    n = min(int(counts[0]), mrow.shape[0])
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    mrow, me = mrow.clone(), me.clone()
    mrow[:n], me[:n] = mrow[:n][perm], me[:n][perm]
    return mrow, me


@pytest.mark.parametrize("maxm", [1, 2, 16])
def test_plain_matches_jax(index_reads, maxm):
    """Slots, rids, in_u and the slot overflow bit-identical to JAX's
    ``collect_matches_sortjoin``, for the list as ``cuckoo_verify`` leaves
    it and for the same list in another order."""
    m, codes, lengths = index_reads
    jax_ms, ovh, ovs = sj.collect_matches_sortjoin(
        sj.to_device_merged(m), jnp.asarray(codes), jnp.asarray(lengths),
        join="bloom", hit_capacity_frac=1, maxm=maxm)
    assert int(ovh) == 0
    mrow, me, counts, prec, O, B, eu = _port_list(m, codes, lengths)
    assert int(counts[0]) > B // 2
    for order in range(2):
        if order:
            mrow, me = _shuffled(mrow, me, counts, maxm)
        got = kma.match_assemble_plain(mrow, me, counts, prec, O, B, maxm, eu)
        for f, g in zip(SLOT_FIELDS, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jax_ms, f)),
                                          err_msg=f)
        assert got[4].dtype == torch.int32 and got[4].shape == ()
        assert int(got[4]) == int(ovs)
    assert maxm < 16 or int(ovs) == 0


@pytest.mark.parametrize("maxm", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_plain_matches_oracle(case, maxm):
    kw = MATCH_CASES[case]
    mrow, me, counts, prec, eu = match_list(7, **kw)
    O, B = kw["O"], kw["B"]
    want = assemble_oracle(mrow, me, counts, prec, O, B, maxm, eu)
    got = kma.match_assemble_plain(*map(torch.from_numpy, (mrow, me, counts, prec)),
                                   O, B, maxm, eu)
    for f, g, w in zip(SLOT_FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert int(got[4]) == want[4]
    if case in ("overflow", "one_read"):
        assert want[4] > 0


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), maxm=st.sampled_from([1, 2, 5, 16]),
       case=st.sampled_from(sorted(MATCH_CASES)))
def test_shuffling_the_valid_prefix_changes_nothing(seed, maxm, case):
    kw = MATCH_CASES[case]
    mrow, me, counts, prec, eu = match_list(seed, **kw)
    args = [torch.from_numpy(a) for a in (mrow, me, counts, prec)]
    want = kma.match_assemble_plain(*args, kw["O"], kw["B"], maxm, eu)
    args[0], args[1] = _shuffled(args[0], args[1], args[2], seed + 1)
    got = kma.match_assemble_plain(*args, kw["O"], kw["B"], maxm, eu)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    kw = MATCH_CASES["dups"]
    mrow, me, counts, prec, eu = match_list(3, **kw)
    args = [torch.from_numpy(a) for a in (mrow, me, counts, prec)]
    before = kma.KERNEL.launches
    got = kma.match_assemble(*args, kw["O"], kw["B"], 16, eu)
    want = kma.match_assemble_plain(*args, kw["O"], kw["B"], 16, eu)
    assert kma.KERNEL.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kma.match_assemble(t, t, t[:2], torch.zeros(4, 3, dtype=torch.int32,
                                                     device="meta"), 2, 2, 4, 1)


def test_collect_matches_assembles_through_the_wrapper(index_reads, monkeypatch):
    """``collect_matches`` hands the assembly its list, count and index
    statics once a batch, and its slots are the wrapper's."""
    m, codes, lengths = index_reads
    calls = []

    def spy(*a):
        calls.append(a)
        return kma.match_assemble(*a)

    monkeypatch.setattr(tsj, "match_assemble", spy)
    mt = collect_matches(TorchMergedIndex.from_merged(m, "cpu"),
                         torch.from_numpy(codes), torch.from_numpy(lengths), 16)
    assert len(calls) == 1
    want = kma.match_assemble_plain(*_port_list(m, codes, lengths)[:6], 16,
                                    int(m.eu))
    for f, w in zip(SLOT_FIELDS, want):
        assert torch.equal(getattr(mt.slots, f), w), f
    assert torch.equal(mt.overflow_slots, want[4])
