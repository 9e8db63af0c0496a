"""The port's three kernels: plain PyTorch versions against the JAX package
(bit-identical).  The CUDA kernels against the plain versions are in
test_torch_cuda.py, which imports no JAX and so also runs on a GPU host."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.pallas_repro import first_of_run_scan_pallas
from cammiq_tpu.query.probe import pack_rolling16
from cammiq_tpu.query.sortjoin import (
    _bloom_maybe,
    _build_bloom,
    _build_cuckoo,
    _cuckoo_lookup,
    _first_of_run_scan,
    _fold_bloom,
    _hash_prefix,
)
from cammiq_tpu_torch import u32
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.kernels import build
from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_lookup_plain
from cammiq_tpu_torch.kernels.first_of_run import (
    first_of_run_scan,
    first_of_run_scan_plain,
)
from cammiq_tpu_torch.kernels.probe_bloom import num_offsets, probe_bloom_plain
from cammiq_tpu_torch.query import merged as tmerged
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.query.sortjoin import level1_log
from torch_fixture import dist_fixture

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


def _scan_inputs(n, nv, seed, lead_start):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.02
    flags[0] = lead_start
    vals = [rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
            for _ in range(nv)]
    return flags, vals


@pytest.mark.parametrize("nv", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 2047, 2049, 40000])
def test_scan_plain_matches_xla_twin(n, nv):
    """Including a leading run with no start: the twin carries values[0]."""
    flags, vals = _scan_inputs(n, nv, seed=n * 10 + nv, lead_start=False)
    want = _first_of_run_scan(jnp.asarray(flags), *map(jnp.asarray, vals))
    got = first_of_run_scan_plain(torch.from_numpy(flags),
                                  *map(torch.from_numpy, vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the twin's semantics, pinned: before the first start, values[0]
    first = int(np.argmax(flags)) if flags.any() else n
    for g, v in zip(got, vals):
        assert (g.numpy()[:first] == v[0]).all()


def _mode_flags(case, n, seed):
    rng = np.random.default_rng(seed)
    return {"all_false": np.zeros(n, bool), "all_true": np.ones(n, bool),
            "only_0": np.arange(n) == 0,
            "random": rng.random(n) < 0.01}[case]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 4096, 5000])
@pytest.mark.parametrize("case", ["all_false", "all_true", "only_0", "random"])
def test_scan_plain_modes_match_flip_and_xla_twin(case, n, reverse):
    """Index mode (no value array) and ``reverse`` against the formulation
    they replace (values = arange, and the reverse scan on flipped
    arrays) and against the XLA twin; 5000 is not a multiple of the
    kernel's 4096-element tile."""
    flags = _mode_flags(case, n, seed=n)
    vals = np.random.default_rng(n + 1).integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    f = torch.from_numpy(flags)
    (got_idx,) = first_of_run_scan_plain(f, reverse=reverse)
    (got_val,) = first_of_run_scan_plain(f, torch.from_numpy(vals), reverse=reverse)
    assert got_idx.dtype == torch.int32
    if reverse:
        (flip_idx,) = first_of_run_scan_plain(f.flip(0), torch.from_numpy(idx).flip(0))
        flip_idx = flip_idx.flip(0)
        twin = [np.asarray(w)[::-1] for w in _first_of_run_scan(
            jnp.asarray(flags[::-1].copy()), jnp.asarray(idx[::-1].copy()),
            jnp.asarray(vals[::-1].copy()))]
    else:
        (flip_idx,) = first_of_run_scan_plain(f, torch.from_numpy(idx))
        twin = [np.asarray(w) for w in _first_of_run_scan(
            jnp.asarray(flags), jnp.asarray(idx), jnp.asarray(vals))]
    assert torch.equal(got_idx, flip_idx)
    np.testing.assert_array_equal(got_idx.numpy(), twin[0])
    np.testing.assert_array_equal(got_val.numpy(), twin[1])
    if case == "all_true":
        np.testing.assert_array_equal(got_idx.numpy(), idx)
    if case == "all_false":
        assert (got_idx.numpy() == (n - 1 if reverse else 0)).all()


@pytest.mark.parametrize("nv", [1, 3])
def test_scan_plain_matches_pallas(nv):
    """The Pallas kernel (interpret mode) agrees wherever a start leads;
    it returns 0, not values[0], before the first start."""
    flags, vals = _scan_inputs(40000, nv, seed=nv, lead_start=True)
    want = first_of_run_scan_pallas(jnp.asarray(flags), *map(jnp.asarray, vals))
    got = first_of_run_scan_plain(torch.from_numpy(flags),
                                  *map(torch.from_numpy, vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_probe(codes, h, bloom, bloom_log):
    """khlo and bloom maybe as collect_matches_sortjoin computes them."""
    B, Lp = codes.shape
    O = max(Lp - h + 1, 1)
    p16 = pack_rolling16(jnp.asarray(codes))

    def window(w):
        if 16 * w >= Lp:
            return jnp.zeros((B, O), jnp.uint32)
        sl = p16[:, 16 * w:]
        if sl.shape[1] < O:
            sl = jnp.concatenate(
                [sl, jnp.zeros((B, O - sl.shape[1]), jnp.uint32)], axis=1)
        return sl[:, :O]

    klo = window(0) & jnp.uint32(u32.const_mask(min(h, 16)))
    khi = (window(1) & jnp.uint32(u32.const_mask(h - 16)) if h > 16
           else jnp.zeros((B, O), jnp.uint32))
    khlo, _ = _hash_prefix(klo.reshape(-1), khi.reshape(-1), jnp)
    maybe = _bloom_maybe(jnp.asarray(bloom), khlo, bloom_log, jnp)
    return np.asarray(khlo), np.asarray(maybe)


def _probe_inputs(h, Lp, noncanon):
    """48 reads of Lp codes and a bloom over half of their prefixes plus
    random keys, so both outcomes of the membership test occur.
    ``noncanon``: -1 codes (non-ACGT, which pack_rolling16 widens to
    0xFFFFFFFF) and zero-length padded reads, as a padded batch holds."""
    rng = np.random.default_rng(h * 1000 + Lp)
    codes = rng.integers(0, 4, (48, Lp)).astype(np.int8)
    if noncanon:
        codes[rng.random(codes.shape) < 0.03] = -1
        codes[-4:] = 0
    khlo_all, _ = _jax_probe(codes, h, np.zeros(1 << 12, np.uint32), 12)
    keys = np.concatenate([khlo_all[::2],
                           rng.integers(0, 1 << 32, 5000).astype(np.uint32)])
    bloom, blog = _build_bloom(np.sort(keys))
    return codes, bloom, blog


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("noncanon", [False, True])
@pytest.mark.parametrize("h", [20, 26])
@pytest.mark.parametrize("Lp", [100, 37, 16])
def test_probe_bloom_plain_matches_jax(h, Lp, noncanon):
    """The compacted survivors equal JAX's maybe rows and their keys, -1
    codes and zero-length padded reads included (``_probe_inputs``)."""
    codes, bloom, blog = _probe_inputs(h, Lp, noncanon)
    khlo, maybe = _jax_probe(codes, h, bloom, blog)
    rows, k, n = probe_bloom_plain(torch.from_numpy(codes),
                                   torch.from_numpy(bloom.view(np.int32)), h, blog)
    n = int(n[0])
    assert rows.shape == k.shape == (maybe.shape[0],)
    np.testing.assert_array_equal(rows[:n].numpy(), np.nonzero(maybe)[0])
    np.testing.assert_array_equal(k[:n].numpy().view(np.uint32), khlo[maybe])
    assert 0 < n < maybe.shape[0]
    if noncanon:      # the -1 codes reach the hashes
        clean = np.where(codes < 0, 0, codes).astype(np.int8)
        assert (_jax_probe(clean, h, bloom, blog)[0] != khlo).any()


@pytest.mark.parametrize("drop", [1, 2, 4])
@pytest.mark.parametrize("noncanon", [False, True])
@pytest.mark.parametrize("h", [20, 26])
def test_probe_bloom_plain_two_levels(h, noncanon, drop):
    """With a level-1 fold (the bloom folded ``drop`` logs down by JAX's
    ``_fold_bloom``) the survivors, keys and count equal the one-level
    call's and JAX's ``_bloom_maybe``; the rows counted as sent to level 2
    are those JAX's test passes against the fold, and the survivors n."""
    codes, bloom, blog = _probe_inputs(h, 100, noncanon)
    khlo, maybe = _jax_probe(codes, h, bloom, blog)
    l1, l1_log = _fold_bloom(bloom, blog - drop)
    assert l1_log == blog - drop
    c = torch.from_numpy(codes)
    one = probe_bloom_plain(c, _i32(bloom), h, blog)
    counts = torch.zeros(2, dtype=torch.int32)
    two = probe_bloom_plain(c, _i32(bloom), h, blog, _i32(l1), l1_log, counts)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    n = int(two[2][0])
    np.testing.assert_array_equal(two[0][:n].numpy(), np.nonzero(maybe)[0])
    np.testing.assert_array_equal(two[1][:n].numpy().view(np.uint32), khlo[maybe])
    _, sent = _jax_probe(codes, h, l1, l1_log)
    assert counts.tolist() == [int(sent.sum()), n]
    assert 0 < n < int(sent.sum()) < maybe.shape[0]


@pytest.mark.parametrize("drop", [1, 2, 4])
def test_bloom_fold_keeps_every_bit(drop):
    """The port's fold (what the device index's level 1 is made with)
    equals JAX's and holds every bit of every bloom word: word w's bits
    are set in fold word w >> drop, so every key of the bloom passes it."""
    rng = np.random.default_rng(drop)
    keys = np.sort(rng.integers(0, 1 << 32, 30000).astype(np.uint32))
    bloom, blog = _build_bloom(keys)
    l1, l1_log = tmerged._fold_bloom(bloom, blog - drop)
    want, want_log = _fold_bloom(bloom, blog - drop)
    assert l1_log == want_log == blog - drop and l1.shape == (1 << l1_log,)
    np.testing.assert_array_equal(l1, want)
    w = np.arange(1 << blog)
    assert ((l1[w >> drop] & bloom) == bloom).all()
    bits = tmerged._bloom_bits(keys)
    assert ((l1[keys >> np.uint32(32 - l1_log)] & bits) == bits).all()


@pytest.mark.parametrize("blog,l2,want", [
    (24, 50 << 20, 22),   # the H100: 2^22 words, 16 MB, in front of 64 MB
    (26, 50 << 20, 22), (23, 50 << 20, 22),
    (22, 50 << 20, 0),    # the filter fits the budget: one level
    (12, 50 << 20, 0),
    (24, 40 << 20, 21),
    (24, 0, 0),           # no L2 (the CPU): one level
])
def test_level1_log(blog, l2, want):
    """The level-1 size: the largest power of two of words within a third
    of the L2, and none where the bloom is no larger than that."""
    assert level1_log(blog, l2) == want


@pytest.mark.parametrize("drop", [0, 6])
def test_pass_probe_counters(drop):
    """A pass's probe counters equal the plain version's counts summed over
    its batches (the session's trimmed width, padded last batch), with one
    level (``drop`` 0: every row goes to level 2) and with a level-1 fold
    put on the device index; the counts the pass returns are the same with
    and without the fold."""
    art, rs, G = dist_fixture(seed=13)
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device="cpu")
    base = sess.run(rs)
    dm = sess.dm
    l1 = None
    if drop:
        l1 = _i32(tmerged._fold_bloom(dm.bloom.numpy(), dm.bloom_log - drop)[0])
        sess.dm = dataclasses.replace(dm, bloom_l1=l1,
                                      bloom_l1_log=dm.bloom_log - drop)
    got = sess.run(rs)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(base, f.name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
    want, rows = torch.zeros(2, dtype=torch.int32), 0
    bs = sess.batch_size(rs)
    lp = min(rs.codes.shape[1], int(rs.lengths.max()))
    for batch in rs.batches(bs):
        codes = torch.from_numpy(np.ascontiguousarray(batch.codes[:, :lp]))
        probe_bloom_plain(codes, dm.bloom, dm.h, dm.bloom_log, l1,
                          dm.bloom_log - drop, want)
        rows += codes.shape[0] * num_offsets(lp, dm.h)
    assert sess.last_counters == {"probe.rows": rows,
                                  "probe.level2": int(want[0]),
                                  "probe.survivors": int(want[1])}
    assert 0 < want[1] < want[0] <= rows
    assert (int(want[0]) == rows) == (drop == 0)


def _cuckoo_fixture(seed=5, nd=20000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 32, nd * 2).astype(np.uint32))[:nd]
    pref_lo = np.sort(np.repeat(keys, rng.integers(1, 3, nd)))
    first = np.ones(pref_lo.shape[0], bool)
    first[1:] = pref_lo[1:] != pref_lo[:-1]
    run = np.cumsum(first) - 1
    starts = rng.integers(0, 1 << 20, nd).astype(np.int32)[run]
    counts = rng.integers(1, 5, nd).astype(np.int32)[run]
    tab, tlog = _build_cuckoo(pref_lo, starts, counts)
    absent = np.setdiff1d(rng.integers(0, 1 << 32, 4096).astype(np.uint32), keys)
    return tab, tlog, np.concatenate([keys, absent])


def test_cuckoo_lookup_plain_matches_jax():
    tab, tlog, probes = _cuckoo_fixture()
    want = _cuckoo_lookup(jnp.asarray(tab), tlog, jnp.asarray(probes), jnp)
    got = cuckoo_lookup_plain(torch.from_numpy(tab.view(np.int32)), tlog,
                              u32.widen(torch.from_numpy(probes.view(np.int32))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and not got[0].all()


def test_u32_mul_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 10000, dtype=np.uint64).astype(np.uint32)
    for c in (0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1):
        with np.errstate(over="ignore"):
            want = a * np.uint32(c)
        got = u32.mul(torch.from_numpy(a.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(u32.narrow(got).numpy(),
                                      want.view(np.int32))


def test_wrapper_checks():
    with pytest.raises(ValueError):
        first_of_run_scan(torch.ones(3, dtype=torch.bool),
                          *[torch.zeros(3, dtype=torch.int32)] * 5)
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        build.check_tensor(t, "t", torch.int8, t.device)
    with pytest.raises(ValueError):
        build.check_tensor(t.t()[:, :2], "t", torch.int32, t.device)
    with pytest.raises(ValueError):
        build.check_tensor(t, "t", torch.int32, torch.device("meta"))

