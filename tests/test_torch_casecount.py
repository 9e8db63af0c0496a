"""The case analysis and rcount of a batch (``kernels/case_count.py``) on
the CPU, where ``case_count`` runs its plain version, against the JAX
package's ``case_analysis`` + ``rcounts_from_case``: bit-identical on rows
built from a numpy seed that take every branch of the case table, and the
sort join's rcount from its slots against JAX's from its match list."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cammiq_tpu.query.sortjoin as sj
from cammiq_tpu.query import classify as jc
from cammiq_tpu_torch.query import classify as tc
from cammiq_tpu_torch.query.sortjoin import (TorchMergedIndex, classify_batch,
                                             collect_matches)
from dist_fixture import make_dist_fixture
from torch_fixture import CASE_BRANCHES, case_rows

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

B = 64
G_SMALL = 12
ID_SPACE = 200_000
# the rcount's size: the whole id space (r1), or its lower half (r2), so
# the ids past the buffer stay uncounted
RC_SIZE = {1: ID_SPACE, 2: ID_SPACE // 2}
CASES = (
    [(b, 16, 1, False, G_SMALL) for b in CASE_BRANCHES]
    + [(b, 16, 1, False, G_SMALL) for b in ("dups", "all_big", "padding")]
    + [("mixed", 16, 2, True, G_SMALL), ("dups", 300, 1, False, G_SMALL),
       ("mixed", 300, 2, False, G_SMALL), ("padding", 300, 1, True, G_SMALL),
       ("mixed", 4096, 1, False, G_SMALL), ("dups", 4096, 2, True, G_SMALL),
       ("mixed", 16, 1, True, 5000), ("padding", 300, 2, True, 5000)])


@partial(jax.jit, static_argnames=("G", "sc_mode", "ranges"))
def _jax_case(slots, rid1, rid2, lengths, G, sc_mode, ranges):
    ms = jc.MatchSlots(slots, rid1, rid2, in_u=slots < jc.BIG)
    case = jc.case_analysis(ms, lengths, G, sc_mode=sc_mode)
    return case, [jc.rcounts_from_case(case, lo, size) for lo, size in ranges]


def _branch_taken(branch, want, lengths):
    """The rows really took ``branch``: every read lands where it should."""
    n = len(lengths)
    cu, cd = int(np.sum(want.cnts_u)), int(np.sum(want.cnts_d))
    undet, conf = int(want.nundet), int(want.nconf)
    return {"undet": undet == n, "all_big": undet == n,
            "u_only": cu == n and cd == 0, "ud_in": cu == cd == n,
            "ud_out": conf == n and cu == cd == 0,
            "pair": cd == 2 * n and cu == 0, "isect0": conf == n,
            "isect1": cd == n and cu == 0, "isect2": conf == n,
            "u_many": conf == n,
            "dups": cu + cd > 0 and conf > 0,
            "padding": undet + conf < n - int(np.sum(want.assigned)),
            "mixed": cu > 0 and cd > 0 and conf > 0}[branch]


@pytest.mark.parametrize("branch,S,nranges,sc_mode,G", CASES,
                         ids=[f"{b}-S{s}-r{r}-{'sc' if sc else 'quant'}-G{g}"
                              for b, s, r, sc, g in CASES])
def test_case_count_matches_jax(branch, S, nranges, sc_mode, G):
    """Every branch of the case table (undetermined; U only; U with r* in
    every pair and not; one pair; P >= 2 with an intersection of 0, 1 and
    2 genomes; U > 1), duplicated slots, rows of only BIG, padding reads
    of length 0 that hold matches, sc mode, widths 16, 300 and 4096, one
    and an rcount over all ids or over the lower half, and G = 5000.
    ``counts`` is added to, as the grid's buffer is."""
    cols = case_rows(S * 7 + nranges + G, B, S, G, branch, id_space=ID_SPACE)
    size = RC_SIZE[nranges]
    want, (want_rc,) = _jax_case(*map(jnp.asarray, cols), G=G, sc_mode=sc_mode,
                                 ranges=((0, size),))
    assert _branch_taken(branch, want, cols[3]), branch
    slots, rid1, rid2, lengths = map(torch.from_numpy, cols)
    ms = tc.MatchSlots(slots, rid1, rid2, in_u=slots < tc.BIG)
    base = torch.arange(2 * G + 2, dtype=torch.int32)
    counts = base.clone()
    rcount = torch.full((size,), 7, dtype=torch.int32)
    got = tc.case_count(ms, lengths, G, sc_mode=sc_mode, rcount=rcount,
                        counts=counts)
    np.testing.assert_array_equal((counts - base).numpy(), np.concatenate(
        [want.cnts_u, want.cnts_d, [want.nundet, want.nconf]]))
    assert torch.equal(torch.cat([got.cnts_u, got.cnts_d, got.nundet[None],
                                  got.nconf[None]]), counts)
    for f in ("pair_lo", "pair_hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(rcount.numpy() - 7, np.asarray(want_rc))
    if sc_mode and branch in ("mixed", "pair"):
        assert int((got.pair_lo >= 0).sum()) > 0
    if branch in ("mixed", "dups", "padding"):
        assert int(np.sum(want_rc)) > 0
        if size < ID_SPACE:
            # assigned reads hold ids past the buffer, left uncounted
            case = tc.case_analysis(ms, lengths, G)
            assert int(tc.rcounts_from_case(case, size, ID_SPACE - size).sum()) > 0


def test_case_count_default_counts_and_no_targets():
    """With no ``counts`` and no rcount target: fresh zeros, and the same
    counts as with them."""
    cols = case_rows(3, B, 16, G_SMALL)
    ms = tc.MatchSlots(*map(torch.from_numpy, cols[:3]), in_u=None)
    lengths = torch.from_numpy(cols[3])
    got = tc.case_count(ms, lengths, G_SMALL, sc_mode=True)
    rc = torch.zeros(ID_SPACE, dtype=torch.int32)
    again = tc.case_count(ms, lengths, G_SMALL, sc_mode=True, rcount=rc)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert int(rc.sum()) > 0


@pytest.fixture(scope="module")
def dist_index():
    art, rs, G = make_dist_fixture(seed=13)
    return sj.build_merged_index(art.unique_index, art.doubly_index), rs, G


@pytest.mark.parametrize("maxm", [16, 2])
def test_sortjoin_rcount_from_slots(dist_index, maxm):
    """The sort join's rcount now comes from its slots.  At maxm = 16 no
    read overflows its slots, and it equals JAX's rcount from the match
    list (``make_sortjoin_classifier``'s ``part2``) with every other count.
    At maxm = 2 reads overflow: the slots keep each read's first two
    entries, so the port's rcount is compared with JAX's
    ``rcounts_from_case`` over those overflowed slots, and the match
    list's rcount differs (the session discards and re-runs such a pass)."""
    m, rs, G = dist_index
    E = m.eu + m.ed
    dm = TorchMergedIndex.from_merged(m, "cpu")
    rc = torch.zeros(E, dtype=torch.int32)
    got = classify_batch(dm, torch.from_numpy(rs.codes), torch.from_numpy(rs.lengths),
                         G, maxm, rc, frac=0)
    classify = sj.make_sortjoin_classifier(sj.to_device_merged(m), G,
                                           hit_capacity_frac=1, maxm=maxm)
    want, ovh, ovs = classify(jnp.asarray(rs.codes), jnp.asarray(rs.lengths))
    assert int(ovh) == 0 and int(got.overflow_hits) == 0
    assert int(ovs) == int(got.overflow_slots)
    list_rc = np.concatenate([want.rcount_u, want.rcount_d])
    for f in ("cnts_u", "cnts_d", "nundet", "nconf"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if maxm == 16:
        assert int(ovs) == 0
        np.testing.assert_array_equal(rc.numpy(), list_rc)
        assert list_rc.sum() > 0
    else:
        assert int(ovs) > 0
        # the port's slots, which equal JAX's at maxm = 2
        # (test_torch_query.py::test_match_slots_match_jax)
        ms = collect_matches(dm, torch.from_numpy(rs.codes),
                             torch.from_numpy(rs.lengths), maxm).slots
        _, (want_rc,) = _jax_case(*(jnp.asarray(x.numpy()) for x in ms[:3]),
                                  jnp.asarray(rs.lengths), G=G, sc_mode=False,
                                  ranges=((0, E),))
        np.testing.assert_array_equal(rc.numpy(), np.asarray(want_rc))
        assert not np.array_equal(rc.numpy(), list_rc)
