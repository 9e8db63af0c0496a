"""The port's three kernels: plain PyTorch versions against the JAX package
(bit-identical).  The CUDA kernels against the plain versions are in
test_torch_cuda.py, which imports no JAX and so also runs on a GPU host."""

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
    _hash_prefix,
)
from cammiq_tpu_torch import u32
from cammiq_tpu_torch.kernels import build
from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_lookup_plain
from cammiq_tpu_torch.kernels.first_of_run import (
    first_of_run_scan,
    first_of_run_scan_plain,
)
from cammiq_tpu_torch.kernels.probe_bloom import probe_bloom_plain

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


@pytest.mark.parametrize("h", [20, 26])
@pytest.mark.parametrize("Lp", [100, 37, 16])
def test_probe_bloom_plain_matches_jax(h, Lp):
    rng = np.random.default_rng(h * 1000 + Lp)
    codes = rng.integers(0, 4, (48, Lp)).astype(np.int8)
    # a filter over half of the probed prefixes plus random keys, so both
    # outcomes of the membership test occur
    khlo_all, _ = _jax_probe(codes, h, np.zeros(1 << 12, np.uint32), 12)
    keys = np.concatenate([khlo_all[::2],
                           rng.integers(0, 1 << 32, 5000).astype(np.uint32)])
    bloom, blog = _build_bloom(np.sort(keys))
    khlo, maybe = _jax_probe(codes, h, bloom, blog)
    m, k = probe_bloom_plain(torch.from_numpy(codes),
                             torch.from_numpy(bloom.view(np.int32)), h, blog)
    np.testing.assert_array_equal(k.numpy().view(np.uint32), khlo)
    np.testing.assert_array_equal(m.numpy().astype(bool), maybe)
    assert 0 < int(maybe.sum()) < maybe.shape[0]


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

