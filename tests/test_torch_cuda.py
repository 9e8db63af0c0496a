"""The port's CUDA kernels against their plain PyTorch versions, and the
query path through the kernels against the same path on the CPU.  Every
test needs a card (marker ``cuda``) and skips without one: the kernels are
compiled with nvcc and have no CPU mode.  The file imports nothing of
JAX or of the JAX package, so it runs on a GPU host without either:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import datetime
import warnings

import numpy as np
import pytest
import torch

from cammiq_tpu_torch import u32
from cammiq_tpu_torch.config import BuildConfig, QueryConfig
from cammiq_tpu_torch.index import unique as uq
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.kernels import case_count as kcc
from cammiq_tpu_torch.kernels import cuckoo_verify as kcv
from cammiq_tpu_torch.kernels import first_of_run as kfr
from cammiq_tpu_torch.kernels import gather_probe as kgp
from cammiq_tpu_torch.kernels import lcp_pairs as klcp
from cammiq_tpu_torch.kernels import match_assemble as kma
from cammiq_tpu_torch.kernels import occ_count as kocc
from cammiq_tpu_torch.kernels import probe_bloom as kpb
from cammiq_tpu_torch.kernels import quant_fista as kqf
from cammiq_tpu_torch.kernels import read_pack as krp
from cammiq_tpu_torch.kernels import segmented_min as ksm
from cammiq_tpu_torch.io.fastq import ReadSet
from cammiq_tpu_torch.models.quant import solve_quant
from cammiq_tpu_torch.ops.sa import suffix_array
from cammiq_tpu_torch.parallel import dist_query as tdq
from cammiq_tpu_torch.index.table import _empty_flat_index
from cammiq_tpu_torch.query import classify as tgc
from cammiq_tpu_torch.query.classify import MatchSlots, case_count
from cammiq_tpu_torch.query.merged import (_build_bloom, _fold_bloom,
                                           build_merged_index)
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.query.probe import to_device_index
import cammiq_tpu_torch.query.sortjoin as tsj
from cammiq_tpu_torch.query.sortjoin import (TorchMergedIndex, classify_batch,
                                             collect_matches)
from cammiq_tpu_torch.utils.timing import take, tracing
from torch_fixture import (ALPHA, CASE_BRANCHES, MATCH_CASES,
                           QUANT_BEYOND_CAP, QUANT_CONSTRAINED,
                           QUANT_UNCONSTRAINED, by_entry_key, case_rows,
                           dist_fixture, end_run_table, flat_table,
                           gather_tables, large_bucket_index, match_list,
                           pair_corpus, pair_genomes, pair_reads, planted_reads,
                           quant_problem, strain_index, strain_reads)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dist_index():
    art, rs, G = dist_fixture(seed=13)
    return art, build_merged_index(art.unique_index, art.doubly_index), rs, G


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lead_start", [False, True])
@pytest.mark.parametrize("nv", [0, 1, 4])
@pytest.mark.parametrize("n", [1, 2048, 2049, 4097, 1 << 20])
def test_scan_kernel_matches_plain(cuda_device, n, nv, lead_start, reverse):
    """Every mode (index mode at nv = 0, forward and reverse), at sizes
    below, at and off the 4096-element tile."""
    rng = np.random.default_rng(n + nv)
    flags = rng.random(n) < 0.02
    flags[-1 if reverse else 0] = lead_start
    f = torch.from_numpy(flags).to(cuda_device)
    vs = [torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, n)
                           .astype(np.int32)).to(cuda_device) for _ in range(nv)]
    before = kfr.KERNEL.launches
    got = kfr.first_of_run_scan(f, *vs, reverse=reverse)
    assert kfr.KERNEL.launches == before + 1
    want = kfr.first_of_run_scan_plain(f, *vs, reverse=reverse)
    assert len(got) == len(want) == max(nv, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["all_false", "all_true", "only_first",
                                  "sparse", "misaligned"])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_look_back(cuda_device, kind, reverse):
    """Runs longer than many tiles (the look-back walks through tiles with
    no start), every element a start, and flags not 16-byte aligned (the
    byte-load path)."""
    n = 3 * 4096 * 37 + 5
    rng = np.random.default_rng(len(kind))
    flags = {"all_false": np.zeros(n, bool), "all_true": np.ones(n, bool),
             "only_first": np.arange(n) == (n - 1 if reverse else 0),
             "sparse": rng.random(n) < 2e-5,
             "misaligned": rng.random(n) < 1e-3}[kind]
    f = torch.from_numpy(flags).to(cuda_device)
    if kind == "misaligned":
        f = torch.cat([torch.zeros(1, dtype=torch.bool, device=cuda_device), f])[1:]
        assert f.data_ptr() % 16
    v = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32)).to(cuda_device)
    for args in ((f,), (f, v)):
        got = kfr.first_of_run_scan(*args, reverse=reverse)
        want = kfr.first_of_run_scan_plain(*args, reverse=reverse)
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("nv", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_matches_plain_2e27(cuda_device, nv, reverse):
    """n = 2^27: 32,768 tiles, each mode."""
    n = 1 << 27
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f = torch.rand(n, device=cuda_device, generator=g) < 1e-3
    v = torch.randint(-(1 << 30), 1 << 30, (n,), device=cuda_device,
                      dtype=torch.int32, generator=g)
    vs = (v,) * nv
    (got,) = kfr.first_of_run_scan(f, *vs, reverse=reverse)
    (want,) = kfr.first_of_run_scan_plain(f, *vs, reverse=reverse)
    assert torch.equal(got, want)


# ---- the segmented min-scan of the LCP0 stages (kernels/segmented_min.py)

SEGMIN_TILE = 4096
SEGMIN_PATTERNS = ["none", "all", "only_first", "only_last", "lead_run",
                   "last_tile", "1e-4", "1e-2", "0.5"]


def _segmin_inputs(pattern, n, reverse, dev, seed):
    """Values with runs of 0 and 2^31 - 1, and flags of ``pattern``;
    "last_tile": one flag in the tile processed last (the last tile
    forward, the first reverse), every earlier tile looking back through
    all the others."""
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randint(0, 1 << 31, (n,), device=dev, dtype=torch.int32, generator=g)
    pick = torch.rand(n, device=dev, generator=g)
    v[pick < 0.2] = 0
    v[pick > 0.8] = (1 << 31) - 1
    idx = torch.arange(n, device=dev)
    if pattern == "none":
        f = torch.zeros(n, dtype=torch.bool, device=dev)
    elif pattern == "all":
        f = torch.ones(n, dtype=torch.bool, device=dev)
    elif pattern in ("only_first", "only_last"):
        f = idx == (0 if pattern == "only_first" else n - 1)
    elif pattern == "lead_run":
        f = (torch.rand(n, device=dev, generator=g) < 0.01) & (idx >= n // 2)
    elif pattern == "last_tile":
        last = (n - 1) // SEGMIN_TILE * SEGMIN_TILE
        at = (min(7, n - 1) if reverse else last + (n - 1 - last) // 2)
        f = idx == at
    else:
        f = torch.rand(n, device=dev, generator=g) < float(pattern)
    return v, f


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pattern", SEGMIN_PATTERNS)
@pytest.mark.parametrize("n", [1, SEGMIN_TILE - 1, SEGMIN_TILE, SEGMIN_TILE + 1,
                               (1 << 20) + 3, 1 << 27])
def test_segmented_min_kernel_matches_plain(cuda_device, n, pattern, reverse):
    v, f = _segmin_inputs(pattern, n, reverse, cuda_device, n % 1000 + len(pattern))
    before = ksm.KERNEL.launches
    got = ksm.segmented_min(v, f, reverse=reverse)
    assert ksm.KERNEL.launches == before + 1
    want = ksm.segmented_min_plain(v, f, reverse=reverse)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("value", [0, (1 << 31) - 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_min_kernel_extreme_values(cuda_device, value, reverse):
    n = 37 * SEGMIN_TILE + 5
    rng = np.random.default_rng(value % 11)
    v = np.full(n, value, np.int32)
    v[rng.integers(0, n, 50)] = 1
    f = torch.from_numpy(rng.random(n) < 1e-4).to(cuda_device)
    v = torch.from_numpy(v).to(cuda_device)
    assert torch.equal(ksm.segmented_min(v, f, reverse=reverse),
                       ksm.segmented_min_plain(v, f, reverse=reverse))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("flag_offset", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_min_kernel_unaligned_views(cuda_device, offset, flag_offset,
                                              reverse):
    """v a view 1-3 elements past a 16-byte boundary (the build's reverse
    scan reads lcp[1:n+1]) and flags one byte off it (the byte-load path),
    at sizes off the tile."""
    for n in (5, SEGMIN_TILE + 3, 3 * SEGMIN_TILE + 1, (1 << 20) + 1):
        lcp, f = _segmin_inputs("1e-2", n + 4, reverse, cuda_device, n + offset)
        v = lcp[offset:offset + n]
        f = f[flag_offset:flag_offset + n]
        assert v.data_ptr() % 16 == 4 * offset
        assert torch.equal(ksm.segmented_min(v, f, reverse=reverse),
                           ksm.segmented_min_plain(v, f, reverse=reverse))


def test_segmented_min_kernel_in_lcp0_stages(cuda_device, build_stages):
    """unique_lcp0 and doubly_lcp0 on the card launch the scan twice each
    and equal the same stages on the CPU."""
    sa, lcp, gsa = build_stages[:3]
    before = ksm.KERNEL.launches
    got_u = uq.unique_lcp0(gsa, lcp, 20)
    got_d = uq.doubly_lcp0(sa, gsa, lcp, 20, 40)
    assert ksm.KERNEL.launches == before + 4
    want_u = uq.unique_lcp0(gsa.cpu(), lcp.cpu(), 20)
    want_d = uq.doubly_lcp0(sa.cpu(), gsa.cpu(), lcp.cpu(), 20, 40)
    assert torch.equal(got_u.cpu(), want_u)
    for g, w in zip(got_d, want_d):
        assert torch.equal(g.cpu(), w)


def test_segmented_min_rejects_bad_inputs(cuda_device):
    v = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    f = torch.zeros(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        ksm.segmented_min(v.long(), f)
    with pytest.raises(ValueError):
        ksm.segmented_min(v, f[:7])
    with pytest.raises(ValueError):
        ksm.segmented_min(v, f.cpu())
    with pytest.raises(ValueError):
        ksm.segmented_min(v[::2], f[::2])          # not contiguous
    assert ksm.segmented_min(v[:0], f[:0]).shape == (0,)


def _repeat_text(rng, n, rep):
    """Random bases with a `rep`-base block copied at several places, some
    copies overlapping the end, so LCPs reach thousands of bases."""
    s = rng.integers(0, 4, n).astype(np.uint8)
    block = s[:rep].copy()
    for at in rng.integers(rep, n - rep // 2, 12):
        k = min(rep, n - at)
        s[at:at + k] = block[:k]
    return s


@pytest.mark.parametrize("kind,n,clamp", [("random", 100_000, 0xFFFF),
                                          ("repeats", 60_000, 0xFFFF),
                                          ("repeats", 60_000, 1000),
                                          ("random", 9, 0xFFFF)])
def test_lcp_pairs_kernel_matches_plain(cuda_device, kind, n, clamp):
    rng = np.random.default_rng(n + clamp)
    s = (rng.integers(0, 4, n).astype(np.uint8) if kind == "random"
         else _repeat_text(rng, n, 5000))
    text = torch.from_numpy(s).to(cuda_device)
    sa = suffix_array(text)
    before = klcp.KERNEL.launches
    got = klcp.lcp_pairs(text, sa, clamp)
    assert klcp.KERNEL.launches == before + 1
    want = klcp.lcp_pairs_plain(text, sa, clamp)
    assert torch.equal(got, want)
    if kind == "repeats":
        assert int(got.max()) >= min(clamp, 4000)
        # a run of ranks alone
        assert torch.equal(klcp.lcp_pairs(text, sa[777:9999], clamp),
                           klcp.lcp_pairs_plain(text, sa[777:9999], clamp))


@pytest.mark.parametrize("case", ["all_long", "to_the_end", "clamp_in_warp",
                                  "no_long"])
def test_lcp_pairs_kernel_phases(cuda_device, case):
    """The two phases: every pair long (copies of one 6 kb segment), long
    pairs that run into the end of the text, the clamp reached inside the
    warp phase, and an empty worklist (no LCP of 32 or more)."""
    rng = np.random.default_rng(len(case))
    clamp = 0xFFFF
    if case == "all_long":
        seg = rng.integers(0, 4, 6000).astype(np.uint8)
        s = np.concatenate([seg] * 12 + [rng.integers(0, 4, 7).astype(np.uint8)])
    elif case == "to_the_end":
        seg = rng.integers(0, 4, 3000).astype(np.uint8)
        s = np.concatenate([rng.integers(0, 4, 5000).astype(np.uint8), seg,
                            rng.integers(0, 4, 999).astype(np.uint8), seg])
    elif case == "clamp_in_warp":
        s = _repeat_text(rng, 60_000, 5000)
        clamp = 1000
    else:
        s = rng.integers(0, 4, 1 << 14).astype(np.uint8)
    text = torch.from_numpy(s).to(cuda_device)
    sa = suffix_array(text)
    got = klcp.lcp_pairs(text, sa, clamp)
    want = klcp.lcp_pairs_plain(text, sa, clamp)
    assert torch.equal(got, want)
    top = int(want.max())
    if case == "no_long":
        assert top < 32
    elif case == "clamp_in_warp":
        assert top == clamp
    else:
        assert top >= 2900
    if case == "all_long":
        assert int((want[1:-1] >= 32).float().mean() * 100) >= 90


@pytest.fixture(scope="module")
def build_stages():
    """The device build's arrays for a corpus with planted genome pairs,
    computed on the card (the plain stages around the kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    corpus = pair_corpus(7, ng=6, glen=3000, seg=400)
    text = torch.from_numpy(corpus.seq.copy()).to(dev)
    sa = suffix_array(text)
    lcp = klcp.lcp_pairs(text, sa)
    gsa = uq.compute_gsa(sa, corpus.ref_pos, corpus.ref_id)
    lcp0 = uq.unique_lcp0(gsa, lcp, 11)
    dl, g2 = uq.doubly_lcp0(sa, gsa, lcp, 11, 60)
    return sa, lcp, gsa, lcp0, dl, g2[sa.long()]


def test_occ_count_kernel_matches_plain(cuda_device, build_stages):
    sa, lcp, gsa, lcp0, dl, g2 = build_stages
    before = kocc.KERNEL.launches
    got = kocc.occ_count_unique(lcp, lcp0, gsa)
    assert torch.equal(got, kocc.occ_count_unique_plain(lcp, lcp0, gsa))
    end_excl = int(torch.nonzero(gsa != gsa[0])[0]) - 1
    for ulmax, ee in ((60, end_excl), (60, 0), (1 << 20, 5)):
        got_d = kocc.occ_count_doubly(lcp, dl, gsa, g2, ulmax, ee)
        want_d = kocc.occ_count_doubly_plain(lcp, dl, gsa, g2, ulmax, ee)
        assert all(torch.equal(a, b) for a, b in zip(got_d, want_d))
    assert kocc.KERNEL.launches == before + 4
    assert int(got_d[1].max()) > 0


def test_occ_count_kernel_saturates(cuda_device):
    """Long same-genome runs with high LCPs: the walks hit their step
    bounds (255 and 511) in both directions."""
    n = 4000
    gsa = torch.ones(n, dtype=torch.int32)
    gsa[1500:1700] = 2
    lcp = torch.full((n + 1,), 80, dtype=torch.int32)
    lcp[0] = lcp[n] = 0
    lcp[2500] = 10
    lcp0 = torch.full((n,), 30, dtype=torch.int32)
    g2 = torch.full((n,), 2, dtype=torch.int32)
    args = [x.to(cuda_device) for x in (lcp, lcp0, gsa)]
    assert torch.equal(kocc.occ_count_unique(*args),
                       kocc.occ_count_unique_plain(*args))
    for a, b in zip(kocc.occ_count_doubly(*args, g2.to(cuda_device), 60, 3),
                    kocc.occ_count_doubly_plain(*args, g2.to(cuda_device), 60, 3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,Lp,B", [(12, 100, 512), (20, 100, 512),
                                    (26, 100, 512), (26, 37, 512),
                                    (20, 16, 512), (26, 100, 8192),
                                    (20, 16, 5000), (26, 12000, 6)])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_bloom_kernel_matches_plain(cuda_device, h, Lp, B, aligned):
    """The survivors in order, their keys and their count equal the plain
    version's (torch.nonzero), -1 codes and zero-length padded reads
    included; many tiles (B = 8192, and 5000 reads of Lp < h: one row a
    read), one read a tile above 48 KB of shared memory (Lp = 12000), and
    codes whose span is not 16-byte aligned."""
    rng = np.random.default_rng(h * 1000 + Lp + B)
    x = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    x[rng.random(x.shape) < 0.02] = -1
    x[-3:] = 0
    flat = torch.zeros(B * Lp + 3, dtype=torch.int8, device=cuda_device)
    codes = flat[0 if aligned else 3:][:B * Lp].view(B, Lp)
    codes.copy_(torch.from_numpy(x))
    assert (codes.data_ptr() % 16 == 0) == aligned
    bloom = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32))
    bloom = bloom.to(cuda_device)
    before = kpb.KERNEL.launches
    rows, keys, n = kpb.probe_bloom(codes, bloom, h, 16)
    assert kpb.KERNEL.launches == before + 1
    want = kpb.probe_bloom_plain(codes, bloom, h, 16)
    assert torch.equal(n, want[2])
    k = int(n[0])
    assert torch.equal(rows[:k], want[0][:k]) and torch.equal(keys[:k], want[1][:k])
    assert 0 < k < rows.shape[0]


def _sparse_bloom(codes, h, log, rng):
    """A bloom of 2^log words at about one key a word (the device index's
    load), over every third prefix ``codes`` probe and random keys."""
    probed = u32.narrow(kpb.probe_keys_plain(codes, h)).cpu().numpy()
    keys = np.concatenate([probed.view(np.uint32)[::3],
                           rng.integers(0, 1 << 32, 1 << log).astype(np.uint32)])
    return _build_bloom(np.sort(keys), log)[0]


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


@pytest.mark.parametrize("h,Lp,B,blog", [
    (12, 100, 512, 16), (20, 100, 512, 16), (26, 100, 512, 16),
    (26, 37, 512, 16), (20, 16, 512, 16), (26, 100, 8192, 16),
    (20, 16, 5000, 16), (26, 12000, 6, 16),
    (26, 100, 65536, 24)])      # the pass's batch against a 64 MB filter
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_bloom_two_levels_match_plain(cuda_device, h, Lp, B, blog, aligned):
    """With a level-1 fold (the filter folded two logs down) the kernel's
    survivors, keys and count equal the plain version's and the one-level
    launch's, exactly on the first n, and the two counters (rows sent to
    level 2, survivors) equal the plain version's: at the shapes of the
    one-level test and at the pass's 65,536 x 100 batch against a
    2^24-word filter."""
    rng = np.random.default_rng(h * 1000 + Lp + B + blog)
    x = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    x[rng.random(x.shape) < 0.02] = -1
    x[-3:] = 0
    flat = torch.zeros(B * Lp + 3, dtype=torch.int8, device=cuda_device)
    codes = flat[0 if aligned else 3:][:B * Lp].view(B, Lp)
    codes.copy_(torch.from_numpy(x))
    bloom_np = _sparse_bloom(codes, h, blog, rng)
    l1_np, l1_log = _fold_bloom(bloom_np, blog - 2)
    bloom, l1 = _i32(bloom_np, cuda_device), _i32(l1_np, cuda_device)
    got_c, want_c = (torch.zeros(2, dtype=torch.int32, device=cuda_device)
                     for _ in range(2))
    before = kpb.KERNEL.launches
    got = kpb.probe_bloom(codes, bloom, h, blog, l1, l1_log, got_c)
    assert kpb.KERNEL.launches == before + 1
    one = kpb.probe_bloom(codes, bloom, h, blog)
    want = kpb.probe_bloom_plain(codes, bloom, h, blog, l1, l1_log, want_c)
    k = int(want[2][0])
    for out in (got, one):
        assert torch.equal(out[2], want[2])
        assert torch.equal(out[0][:k], want[0][:k])
        assert torch.equal(out[1][:k], want[1][:k])
    assert torch.equal(got_c, want_c)
    assert 0 < k < int(want_c[0]) < got[0].shape[0]


def test_probe_bloom_rejects_bad_level1(cuda_device):
    codes = torch.zeros((4, 30), dtype=torch.int8, device=cuda_device)
    bloom = torch.zeros(1 << 10, dtype=torch.int32, device=cuda_device)
    l1 = torch.zeros(1 << 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):        # size and log disagree
        kpb.probe_bloom(codes, bloom, 20, 10, l1, 9)
    with pytest.raises(ValueError):        # no smaller than the bloom
        kpb.probe_bloom(codes, bloom, 20, 10, bloom, 10)
    with pytest.raises(ValueError):
        kpb.probe_bloom(codes, bloom, 20, 10, l1.cpu(), 8)
    with pytest.raises(ValueError):
        kpb.probe_bloom(codes, bloom, 20, 10, l1, 8,
                        torch.zeros(1, dtype=torch.int32, device=cuda_device))
    with pytest.raises(TypeError):
        kpb.probe_bloom(codes, bloom, 20, 10, l1, 8,
                        torch.zeros(2, dtype=torch.int64, device=cuda_device))


def _match_pairs(mrow, me, counts, kp):
    m = min(int(counts[0]), kp)
    return torch.sort((mrow[:m].long() << 32) | me[:m].long()).values


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("index", ["dist", "large_bucket"])
def test_cuckoo_verify_kernel_matches_plain(cuda_device, dist_index, index, tight):
    """The match list sorted by (row, e) equals the plain list; ``tight``
    sizes KP at half the matches: the counts still agree and every slot
    written holds a match of the plain list.  large_bucket walks spans of
    more than 8 entries."""
    if index == "dist":
        _, m, rs, _ = dist_index
        reads, lens = rs.codes, rs.lengths
    else:
        m, reads, lens = large_bucket_index()
    dm = TorchMergedIndex.from_merged(m, cuda_device)
    codes = torch.from_numpy(reads).to(cuda_device)
    lengths = torch.from_numpy(lens).to(cuda_device)
    rows, keys, n = kpb.probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
    args = (rows, keys, n, codes, lengths, dm.cuckoo, dm.cuckoo_log, dm.erec,
            dm.n_colors)
    full = rows.shape[0] * dm.n_colors
    want = kcv.cuckoo_verify_plain(*args, full)
    total = int(want[2][0])
    assert total > 0
    kp = total // 2 if tight else full
    before = kcv.KERNEL.launches
    got = kcv.cuckoo_verify(*args, kp)
    assert kcv.KERNEL.launches == before + 1
    assert got[2].tolist() == [total, max(total - kp, 0)]
    got_pairs = _match_pairs(*got, kp)
    want_pairs = _match_pairs(*want, full)
    if tight:
        assert got_pairs.shape[0] == kp
        assert torch.isin(got_pairs, want_pairs).all()
    else:
        assert torch.equal(got_pairs, want_pairs)


@pytest.mark.parametrize("sc_mode", [False, True])
def test_classify_batch_makes_no_host_sync(cuda_device, dist_index, sc_mode):
    """One batch through the kernels under sync debug mode "error": any
    host sync raises.  Its counts equal the plain path's."""
    art, m, rs, G = dist_index
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        dm = TorchMergedIndex.from_merged(m, dev)
        codes = torch.from_numpy(rs.codes).to(dev)
        lengths = torch.from_numpy(rs.lengths).to(dev)
        rc = torch.zeros(m.eu + m.ed + 1, dtype=torch.int32, device=dev)
        rc = None if sc_mode else rc
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            bc = classify_batch(dm, codes, lengths, G, 16, rc, sc_mode=sc_mode,
                                frac=32)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append([x.cpu() for x in (*bc, *([] if rc is None else [rc]))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("index,maxm", [("dist", 16), ("dist", 2),
                                        ("large_bucket", 16)])
def test_collect_matches_cuda_matches_cpu(cuda_device, dist_index, index, maxm):
    """maxm=2 overflows slots; large_bucket walks spans of more than 8."""
    if index == "dist":
        _, m, rs, _ = dist_index
        codes, lengths = torch.from_numpy(rs.codes), torch.from_numpy(rs.lengths)
    else:
        m, reads, lens = large_bucket_index()
        codes, lengths = torch.from_numpy(reads), torch.from_numpy(lens)
    want = collect_matches(TorchMergedIndex.from_merged(m, "cpu"), codes,
                           lengths, maxm)
    dm = TorchMergedIndex.from_merged(m, cuda_device)
    before = kma.KERNEL.launches
    got = collect_matches(dm, codes.to(cuda_device), lengths.to(cuda_device), maxm)
    assert kma.KERNEL.launches == before + 1       # the assembly's one launch
    for f in ("slots", "rid1", "rid2", "in_u"):
        assert torch.equal(getattr(got.slots, f).cpu(), getattr(want.slots, f)), f
    assert int(got.overflow_slots) == int(want.overflow_slots)


def test_session_cuda_matches_cpu(cuda_device, dist_index):
    art, _, rs, G = dist_index
    reads = ReadSet(codes=np.concatenate([rs.codes] * 3),
                    lengths=np.concatenate([rs.lengths] * 3),
                    total_len=3 * rs.total_len, name="x3")
    cfg = QueryConfig(h=art.unique_index.h, batch_size=256)
    runs = []
    for dev in ("cpu", cuda_device):
        sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device=dev)
        sess.maxm = 1
        runs.append(sess.run(reads))
    for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        np.testing.assert_array_equal(getattr(runs[1], f), getattr(runs[0], f))
    assert (runs[1].nundet, runs[1].nconf) == (runs[0].nundet, runs[0].nconf)


def test_session_drain_buffer_outlives_its_pass(cuda_device, dist_index):
    """The pass's counters land in one pinned buffer kept for the session:
    a result handed out stays as it was after later passes refill the
    buffer, with and without rcounts, and each equals the CPU's."""
    art, _, rs, G = dist_index
    half = ReadSet(codes=rs.codes[::2], lengths=rs.lengths[::2],
                   total_len=int(rs.lengths[::2].sum()), name="half")
    cfg = QueryConfig(h=art.unique_index.h, batch_size=256)
    cpu = QuerySession(art.unique_index, art.doubly_index, G, cfg, device="cpu")
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device)
    plan = [(rs, True), (half, True), (rs, False), (half, True)]
    got = [sess.run(r, with_rcounts=w) for r, w in plan]
    assert sess._drain_buf.is_pinned()
    for g, (r, w) in zip(got, plan):
        want = cpu.run(r, with_rcounts=w)
        for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
            np.testing.assert_array_equal(getattr(g, f), getattr(want, f))
        assert (g.nundet, g.nconf) == (want.nundet, want.nconf)
    assert not np.array_equal(got[0].cnts_u, got[1].cnts_u)


@pytest.mark.parametrize("sc_mode", [False, True])
def test_session_hit_overflow_cuda_matches_cpu(cuda_device, dist_index, sc_mode,
                                               monkeypatch):
    """Match lists from 20 slots: both sessions overflow, widen frac and
    end with the same counts."""
    art, _, rs, G = dist_index
    monkeypatch.setattr(tsj, "HIT_FLOOR", 16)
    monkeypatch.setattr(tsj, "LIST_SLACK", 0)
    cfg = QueryConfig(h=art.unique_index.h, batch_size=256)
    runs = []
    for dev in ("cpu", cuda_device):
        sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device=dev)
        sess.frac = 1024
        runs.append(sess.run(rs, sc_mode=sc_mode))
        assert sess.frac <= 128
    for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        np.testing.assert_array_equal(getattr(runs[1], f), getattr(runs[0], f))
    assert (runs[1].nundet, runs[1].nconf) == (runs[0].nundet, runs[0].nconf)
    assert runs[1].pair_counts == runs[0].pair_counts


@pytest.mark.parametrize("sc_mode", [False, True])
def test_session_pass_syncs_once(cuda_device, dist_index, sc_mode):
    """A warm pass of four batches waits for the device once: its
    end-of-pass transfer (sync debug mode "warn" counts every host
    sync)."""
    art, _, rs, G = dist_index
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device)
    sess.run(rs, sc_mode=sc_mode)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sess.run(rs, sc_mode=sc_mode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's message for a sync, not its notice about the debug mode
    assert sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught) == 1


def test_session_sc_mode_cuda_matches_cpu(cuda_device, dist_index):
    """sc mode: counts and pair counts through the kernels equal the plain
    path's, also after widening from maxm=1."""
    art, _, rs, G = dist_index
    cfg = QueryConfig(h=art.unique_index.h, batch_size=256)
    runs = []
    for dev in ("cpu", cuda_device):
        sess = QuerySession(art.unique_index, art.doubly_index, G, cfg, device=dev)
        sess.maxm = 1
        runs.append(sess.run(rs, sc_mode=True))
    for f in ("cnts_u", "cnts_d"):
        np.testing.assert_array_equal(getattr(runs[1], f), getattr(runs[0], f))
    assert (runs[1].nundet, runs[1].nconf) == (runs[0].nundet, runs[0].nconf)
    assert runs[1].pair_counts == runs[0].pair_counts


# ---- the read upload at 2 bits a base (kernels/read_pack.py)


@pytest.mark.parametrize("loop", ["native", "scalar"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("Lp", [1, 3, 4, 33, 99, 100, 101, 255])
def test_pack_reads_native_matches_plain(cuda_device, Lp, strided, loop):
    """The native packer (AVX2 where the host has it, a scalar tail past
    the last 32 bases; or its scalar loop alone) byte-equal to the numpy
    twin, rows read in place from a [R, 256] read set or contiguous,
    writing nothing past the batch; a -1 code and a length past uint16 are
    reported."""
    pack = krp.pack_reads if loop == "native" else krp.pack_reads_scalar
    rng = np.random.default_rng(Lp)
    B = 65536 if Lp == 100 else 4097
    full = rng.integers(0, 4, (B, 256)).astype(np.int8)
    codes = full[:, :Lp] if strided else np.ascontiguousarray(full[:, :Lp])
    lengths = rng.integers(0, Lp + 1, B).astype(np.int32)
    want = krp.pack_reads_plain(codes, lengths)
    out = np.full(want.size + 16, 0xAB, np.uint8)
    assert pack(codes, lengths, out)
    np.testing.assert_array_equal(out[:want.size], want)
    assert (out[want.size:] == 0xAB).all()
    bad = codes.copy()
    bad[B // 2, Lp - 1] = -1
    assert not pack(bad, lengths, out)
    wide = lengths.copy()
    wide[-1] = 1 << 16
    assert not pack(codes, wide, out)


@pytest.mark.parametrize("B,Lp", [(1, 1), (7, 3), (4097, 4), (300, 33),
                                  (65536, 100), (1000, 101), (50, 255), (10, 0)])
def test_unpack_reads_kernel_matches_plain(cuda_device, B, Lp):
    """One launch, no host sync (sync debug mode "error"), equal to the
    plain version on the same device buffer and to the source batch."""
    rng = np.random.default_rng(B + Lp)
    codes = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    lengths = rng.integers(0, Lp + 1, B).astype(np.int32)
    buf = torch.from_numpy(krp.pack_reads_plain(codes, lengths)).to(cuda_device)
    before = krp.KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = krp.unpack_reads(buf, B, Lp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert krp.KERNEL.launches == before + 1
    want = krp.unpack_reads_plain(buf, B, Lp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_array_equal(got[0].cpu().numpy(), codes)
    np.testing.assert_array_equal(got[1].cpu().numpy(), lengths)


def _wide_reads(rs, planted: bool) -> ReadSet:
    """``rs`` in a [R, 256] read set, as ``read_fastq`` pads it, so the
    session trims it to a strided view; ``planted`` puts a -1 code (an N,
    as the JAX package's tests plant it) into read 70."""
    codes = np.zeros((rs.num_reads, 256), np.int8)
    codes[:, :rs.codes.shape[1]] = rs.codes
    if planted:
        codes[70, 5] = -1
    return ReadSet(codes=codes, lengths=rs.lengths, total_len=rs.total_len,
                   name="wide")


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("engine,sc_mode", [("sortjoin", False),
                                            ("sortjoin", True),
                                            ("gather", False)])
def test_session_packed_upload_matches_cpu(cuda_device, dist_index, engine,
                                           sc_mode, planted):
    """The card's session, its batches packed (or, with a -1 code, one
    batch unpacked), counts as the CPU's: the sort join, sc mode and the
    gather engine."""
    art, _, rs, G = dist_index
    reads = _wide_reads(rs, planted)
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    got, want = (QuerySession(art.unique_index, art.doubly_index, G, cfg,
                              device=d, engine=engine).run(reads, sc_mode=sc_mode)
                 for d in (cuda_device, "cpu"))
    _assert_query_counts_equal(got, want)


@pytest.mark.parametrize("planted", ["none", "one", "every"])
def test_session_pass_pack_counts_packed_batches(cuda_device, dist_index,
                                                 planted):
    """``pass.pack`` folds once a batch, ``pass.unpacked`` once for each
    batch that did not pack: none of the four, the one that holds a -1
    code, or all four where each does."""
    art, _, rs, G = dist_index
    codes = rs.codes.copy()
    if planted == "one":
        codes[130, 7] = -1
    elif planted == "every":
        codes[::64, 0] = -1
    reads = ReadSet(codes=codes, lengths=rs.lengths, total_len=rs.total_len,
                    name="planted")
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    want = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device="cpu").run(reads)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device)
    sess.run(reads)                 # settles maxm and frac: one pass below
    take()
    with tracing():
        got = sess.run(reads)
    tot = take().totals()
    _assert_query_counts_equal(got, want)
    nb = 4
    assert tot["query.pass"][0] == 1 and tot["pass.stage"][0] == 2 * nb + 1
    unpacked = {"none": 0, "one": 1, "every": nb}[planted]
    assert tot["pass.pack"][0] == nb
    assert tot.get("pass.unpacked", [0])[0] == unpacked


@pytest.fixture(scope="module")
def nccl_grid():
    """A world of one rank over NCCL and its 1 x 1 grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist

    from cammiq_tpu_torch.parallel.mesh import ProcessGrid

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield ProcessGrid(1, 1, dev)
    finally:
        dist.destroy_process_group()


def _assert_query_counts_equal(got, want):
    for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.pair_counts) == (
        want.nundet, want.nconf, want.pair_counts)


@pytest.mark.parametrize("sc_mode", [False, True])
def test_nccl_grid_session_matches_single(cuda_device, dist_index, nccl_grid,
                                          sc_mode):
    """The grid session over NCCL (one gather a batch, one all_reduce a
    pass) gives the single session's counts, also after widening from
    maxm=1, from npz and from the same index's artifact."""
    art, _, rs, G = dist_index
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    want = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device).run(rs, sc_mode=sc_mode)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device, grid=nccl_grid)
    sess.maxm = 1
    _assert_query_counts_equal(sess.run(rs, sc_mode=sc_mode), want)
    assert sess.maxm >= 2
    assert want.cnts_u.sum() > 0


@pytest.mark.parametrize("sc_mode", [False, True])
def test_two_shards_on_one_card_match_unsharded(cuda_device, dist_index, sc_mode):
    """Two model shards probed through the kernels, their slots
    concatenated (what the gather gives a row of two ranks): the case
    analysis and the rcount from it equal the unsharded batch's."""
    _, m, rs, G = dist_index
    codes = torch.from_numpy(rs.codes).to(cuda_device)
    lengths = torch.from_numpy(rs.lengths).to(cuda_device)
    nrc = m.eu + m.ed
    rc_want = torch.zeros(nrc, dtype=torch.int32, device=cuda_device)
    want = classify_batch(TorchMergedIndex.from_merged(m, cuda_device), codes,
                          lengths, G, 16, None if sc_mode else rc_want,
                          sc_mode=sc_mode)
    src = tdq._MergedSource.from_merged(m)
    cuts = tdq.shard_merged_cuts(src, 2)
    before = kcv.KERNEL.launches
    mts = [collect_matches(tdq.shard_index(src, i, cuts, cuda_device), codes,
                           lengths, 16) for i in range(2)]
    assert kcv.KERNEL.launches == before + 2
    slots = MatchSlots(*(torch.cat([getattr(mt.slots, f) for mt in mts], 1)
                         for f in MatchSlots._fields))
    rc = torch.zeros(nrc, dtype=torch.int32, device=cuda_device)
    before = kcc.KERNEL.launches
    case = case_count(slots, lengths, G, sc_mode=sc_mode, rcount=rc)
    assert kcc.KERNEL.launches == before + 1
    for got, w in ((case.cnts_u, want.cnts_u), (case.cnts_d, want.cnts_d),
                   (case.nundet, want.nundet), (case.nconf, want.nconf),
                   (case.pair_lo, want.pair_lo), (case.pair_hi, want.pair_hi)):
        assert torch.equal(got, w)
    if not sc_mode:
        assert torch.equal(rc, rc_want) and int(rc.sum()) > 0
    assert all(int(mt.overflow_slots) == 0 for mt in mts)


def test_nccl_grid_batch_makes_no_host_sync(cuda_device, dist_index, nccl_grid):
    """An sc-mode grid batch (probe, gather, case analysis) runs under sync
    debug mode "error", and a warm grid pass waits for the device once."""
    art, _, rs, G = dist_index
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device, grid=nccl_grid)
    sess.run(rs, sc_mode=True)          # NCCL communicators, pair table
    codes = torch.from_numpy(rs.codes[:64]).to(cuda_device)
    lengths = torch.from_numpy(rs.lengths[:64]).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.dist.classify_batch(codes, lengths, G, sess.maxm, sc_mode=True,
                                 frac=sess.frac)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sess.run(rs, sc_mode=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught) == 1


def test_build_index_cuda_matches_cpu(cuda_device):
    corpus = pair_corpus(8, ng=6, glen=3000, seg=400)
    cfg = BuildConfig(k=20, L=100, Lmax=40, h=20, mode="both")
    want = build_index(corpus, cfg, device="cpu")
    got = build_index(corpus, cfg, device=cuda_device)
    for name in ("unique_index", "doubly_index"):
        for f in ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2"):
            np.testing.assert_array_equal(getattr(getattr(got, name), f),
                                          getattr(getattr(want, name), f))
    np.testing.assert_array_equal(got.ulm_count_u, want.ulm_count_u)
    np.testing.assert_array_equal(got.ulm_count_d, want.ulm_count_d)
    assert want.doubly_index.num_entries > 0


def _same_build(got, want):
    for name in ("unique_index", "doubly_index"):
        for f in ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
                  "table_lo", "table_hi", "table_start", "table_count"):
            np.testing.assert_array_equal(getattr(getattr(got, name), f),
                                          getattr(getattr(want, name), f))
    np.testing.assert_array_equal(got.ulm_count_u, want.ulm_count_u)
    np.testing.assert_array_equal(got.ulm_count_d, want.ulm_count_d)


def test_build_index_cuda_stages_resume(cuda_device, tmp_path):
    """The device build on the card writes the JAX engines' ``sa`` (int64
    [n]) and ``lcp`` (int64 [n + 1]) stages and resumes from them."""
    from cammiq_tpu_torch.index.staging import StageStore

    corpus = pair_corpus(8, ng=6, glen=3000, seg=400)
    cfg = BuildConfig(k=20, L=100, Lmax=40, h=20, mode="both")
    want = build_index(corpus, cfg, device=cuda_device)
    d = str(tmp_path / "stages")
    first = build_index(corpus, cfg, device=cuda_device, stage_dir=d)
    store = StageStore(d)
    assert store.load("sa").dtype == np.int64 and store.load("lcp").shape == (corpus.n + 1,)
    again = build_index(corpus, cfg, device=cuda_device, stage_dir=d)
    for art in (first, again):
        _same_build(art, want)


@pytest.mark.parametrize("engine,bounded", [("native", True), ("native", False),
                                            ("numpy", True)])
def test_host_engines_match_cuda_build(cuda_device, engine, bounded):
    """The host engines give the index of the device build on the card."""
    from cammiq_tpu_torch import native

    if engine == "native" and not native.has_bsort():
        pytest.skip(f"native library not built: {native.build_error()}")
    corpus = pair_corpus(8, ng=6, glen=3000, seg=400)
    cfg = BuildConfig(k=20, L=100, Lmax=40, h=20, mode="both", bounded_sa=bounded)
    _same_build(build_index(corpus, cfg, engine=engine),
                build_index(corpus, cfg, device=cuda_device))


@pytest.mark.parametrize("engine", ["sortjoin", "gather"])
def test_reference_format_index_on_card(cuda_device, tmp_path, engine):
    """A cuda-built pair written in the reference's .bin1/.bin2 format and
    read back: the same entry set, and sessions on the card over the
    imported pair count as over the original (rcounts by entry key, as the
    import orders entries by its trie walk), in quant and sc mode."""
    from cammiq_tpu_torch.io.fasta import corpus_from_sequences
    from cammiq_tpu_torch.index.refcompat import (reference_index_to_flat,
                                                  write_reference_index)

    gs, planted = pair_genomes(17, ng=5, glen=600, seg=120)
    corpus = corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs])
    art = build_index(corpus, BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both"),
                      device=cuda_device)
    orig = (art.unique_index, art.doubly_index)
    imported = []
    for ix, name in zip(orig, ("index.bin1", "index.bin2")):
        p = str(tmp_path / name)
        write_reference_index(p, ix)
        back = reference_index_to_flat(p, Lmax=30)
        assert back.num_entries == ix.num_entries
        for f in ("rid1", "rid2", "ucount1", "ucount2"):
            assert by_entry_key(back, getattr(back, f)) == by_entry_key(ix, getattr(ix, f))
        imported.append(back)
    assert orig[1].num_entries > 0
    rs = pair_reads(gs, planted, 5)
    cfg = QueryConfig(h=12, batch_size=128)
    for sc_mode in (False, True):
        got, want = (QuerySession(*pair, 6, cfg, device=cuda_device,
                                  engine=engine).run(rs, sc_mode=sc_mode)
                     for pair in (imported, orig))
        for f in ("cnts_u", "cnts_d"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.nundet, got.nconf, got.pair_counts) == (
            want.nundet, want.nconf, want.pair_counts)
        assert got.cnts_u.sum() > 0
        if sc_mode:
            assert got.pair_counts
        else:
            for f, a, b in (("rcount_u", imported[0], orig[0]),
                            ("rcount_d", imported[1], orig[1])):
                assert by_entry_key(a, getattr(got, f)) == by_entry_key(b, getattr(want, f))


def test_wrappers_reject_bad_inputs(cuda_device):
    codes = torch.zeros((4, 30), dtype=torch.int8, device=cuda_device)
    bloom = torch.zeros(1 << 10, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kpb.probe_bloom(codes.to(torch.int32), bloom, 20, 10)
    with pytest.raises(ValueError):
        kpb.probe_bloom(codes, bloom, 20, 11)
    with pytest.raises(ValueError):
        kpb.probe_bloom(codes, bloom.cpu(), 20, 10)
    flags = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        kfr.first_of_run_scan(flags, torch.zeros(7, dtype=torch.int32,
                                                 device=cuda_device))
    text = torch.zeros(16, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        klcp.lcp_pairs(text, torch.zeros(16, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        klcp.lcp_pairs(text, torch.zeros(17, dtype=torch.int32, device=cuda_device))
    i32 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kocc.occ_count_unique(i32, i32, i32)          # lcp needs n + 1
    prec = torch.zeros(4, 3, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        kma.match_assemble(i32.long(), i32, i32[:2], prec, 2, 4, 16, 1)
    with pytest.raises(ValueError):
        kma.match_assemble(i32, i32[:7], i32[:2], prec, 2, 4, 16, 1)
    with pytest.raises(ValueError):
        kma.match_assemble(i32, i32, i32[:2], prec[:, :2].contiguous(), 2, 4, 16, 1)
    with pytest.raises(ValueError):
        kma.match_assemble(i32, i32, i32[:2].cpu(), prec, 2, 4, 16, 1)


# ---- the gather engine (kernels/gather_probe.py)

def _gather_both(iu, idd, codes, lengths, dev):
    """gather_probe on ``dev`` (one launch) and its plain version on the
    same tensors."""
    du, dd = to_device_index(iu, dev), to_device_index(idd, dev)
    c, ln = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    before = kgp.KERNEL.launches
    got = kgp.gather_probe(du, dd, c, ln)
    assert kgp.KERNEL.launches == before + 1
    return got, kgp.gather_probe_plain(du, dd, c, ln)


def _assert_gather_equal(got, want, hits=True):
    for name, g, w in zip(("slots", "rid1", "rid2", "in_u"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert (int((got[0] < kgp.BIG).sum()) > 0) == hits


@pytest.mark.parametrize("h,Lp,B", [(12, 64, 512), (16, 100, 300),
                                    (17, 100, 300), (20, 100, 512),
                                    (26, 100, 8192), (26, 20, 1000),
                                    (20, 12000, 3)])
def test_gather_probe_kernel_matches_plain(cuda_device, h, Lp, B):
    """Random tables, reads with -1 codes on both strands, empty reads and
    reads shorter than h; h at the one-word edge (16, 17), Lp < h (one
    offset), many tiles (B = 8192), and one read a tile above 48 KB of
    shared memory (Lp = 12000)."""
    iu, idd, keys = gather_tables(h, h)
    codes, lengths = planted_reads(h + Lp, keys, B, Lp)
    _assert_gather_equal(*_gather_both(iu, idd, codes, lengths, cuda_device),
                         hits=Lp >= h)


@pytest.mark.parametrize("probes", ["tight_table", "65"])
def test_gather_probe_kernel_walks_probes(cuda_device, probes):
    """A hash table packed tight (max_probes > 1), and 65 probes over a
    table that needs fewer: each thread takes the first matching row and
    stops at the first empty row, with JAX's answer."""
    import dataclasses

    iu, idd, keys = gather_tables(5, 20, load_factor=4.0)
    assert iu.max_probes > 1
    if probes == "65":
        iu, idd = (dataclasses.replace(x, max_probes=65) for x in (iu, idd))
    codes, lengths = planted_reads(6, keys, 2048, 100)
    _assert_gather_equal(*_gather_both(iu, idd, codes, lengths, cuda_device))


def _stop_case(case):
    """(unique, doubly, int8 codes, int32 lengths, whether any slot hits) of
    a case of test_gather_probe_kernel_stops_at_empty_row."""
    import dataclasses

    rng = np.random.default_rng(30)
    if case == "end_run_wraps":
        iu, idd, keys = end_run_table(21, 26)
        iu = dataclasses.replace(iu, max_probes=65)
    elif case == "tight_65":
        iu, idd, keys = gather_tables(13, 26, load_factor=4.0)
        assert iu.max_probes > 1
        iu, idd = (dataclasses.replace(x, max_probes=65) for x in (iu, idd))
    else:
        iu, idd, keys = gather_tables(15, 26)
    if case == "all_miss":
        codes = rng.integers(0, 4, (4096, 100)).astype(np.int8)
        codes[rng.random(codes.shape) < 0.03] = -1
        return iu, idd, codes, rng.integers(0, 101, 4096).astype(np.int32), False
    if case == "poly_a":
        poly = [0] * 26 + list(rng.integers(0, 4, 8))
        iu = flat_table(keys[:412] + [poly], False, 26, iu.kw)
        keys = [poly] * 40 + keys
    if case == "bucket":
        assert iu.max_bucket >= 12
        keys = keys[:12]
    codes, lengths = planted_reads(31, keys, 4096, 100)
    if case == "poly_a":
        codes[::7, 60:95] = 0            # runs of A that match no key
    return iu, idd, codes, lengths, True


@pytest.mark.parametrize("case", ["end_run_wraps", "tight_65", "all_miss",
                                  "poly_a", "bucket"])
def test_gather_probe_kernel_stops_at_empty_row(cuda_device, case):
    """The walk stops at the first empty row and still equals JAX's full
    walk: a table whose last run ends at row T - 1 (walks from there wrap
    to row 0 in JAX), a table packed tight with 65 probes, reads that match
    nothing, a key whose h-prefix is all A (lo = hi = 0, as an empty row's)
    beside runs of A, and a bucket of twelve entries."""
    iu, idd, codes, lengths, hits = _stop_case(case)
    _assert_gather_equal(*_gather_both(iu, idd, codes, lengths, cuda_device),
                         hits=hits)


@pytest.mark.parametrize("empty", ["unique", "doubly"])
def test_gather_probe_kernel_empty_table(cuda_device, empty):
    """An empty table's dummy entry never matches; the doubly ids start past
    the unique table's device length."""
    iu, idd, keys = gather_tables(7, 20)
    if empty == "unique":
        iu = _empty_flat_index(20, iu.kw, False)
    else:
        idd = _empty_flat_index(20, idd.kw, True)
    codes, lengths = planted_reads(8, keys, 1024, 100)
    _assert_gather_equal(*_gather_both(iu, idd, codes, lengths, cuda_device))


def test_gather_probe_kernel_bases(cuda_device):
    """The kernel places ids as JAX's single-device layout: unique hits in
    [0, Eu), doubly hits from Eu on, Eu the unique table's device
    length."""
    iu, idd, keys = gather_tables(9, 26)
    codes, lengths = planted_reads(10, keys, 1024, 100)
    got, want = _gather_both(iu, idd, codes, lengths, cuda_device)
    _assert_gather_equal(got, want)
    Eu = to_device_index(iu, "cpu").length.shape[0]
    slots, in_u = got[0], got[3]
    doubly = (slots < kgp.BIG) & ~in_u
    assert bool((slots[in_u] < Eu).all()) and bool((slots[doubly] >= Eu).all())
    assert bool(in_u.any()) and bool(doubly.any())


def test_gather_probe_rejects_2e31_slots(cuda_device):
    """B * 4 * O >= 2^31 raises before any launch."""
    iu, idd, _ = gather_tables(11, 12)
    du, dd = to_device_index(iu, cuda_device), to_device_index(idd, cuda_device)
    Lp = 4000
    B = 2**31 // (4 * (Lp - 12 + 1)) + 1
    codes = torch.zeros((B, Lp), dtype=torch.int8, device=cuda_device)
    lengths = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    before = kgp.KERNEL.launches
    with pytest.raises(ValueError, match="int32 slots"):
        kgp.gather_probe(du, dd, codes, lengths)
    with pytest.raises(TypeError):
        kgp.gather_probe(du, dd, codes[:4].to(torch.int32), lengths[:4])
    assert kgp.KERNEL.launches == before


@pytest.mark.parametrize("sc_mode", [False, True])
def test_gather_classify_batch_makes_no_host_sync(cuda_device, dist_index, sc_mode):
    """A gather batch through the kernel under sync debug mode "error";
    its counts and rcount equal the plain path's."""
    art, _, rs, G = dist_index
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        du = to_device_index(art.unique_index, dev)
        dd = to_device_index(art.doubly_index, dev)
        codes = torch.from_numpy(rs.codes).to(dev)
        lengths = torch.from_numpy(rs.lengths).to(dev)
        rc = torch.zeros(du.length.shape[0] + dd.length.shape[0] + 1,
                         dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            bc = tgc.classify_batch(du, dd, codes, lengths, G, rc, sc_mode=sc_mode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append([x.cpu() for x in (bc.cnts_u, bc.cnts_d, bc.nundet, bc.nconf,
                                       bc.pair_lo, bc.pair_hi, rc)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sc_mode", [False, True])
def test_gather_session_cuda_matches_sortjoin(cuda_device, dist_index, sc_mode):
    """QuerySession(engine="gather") on the card equals the same session on
    the CPU and the sort-join session on the card (the fixture's reads
    hold no N), and a warm pass syncs once."""
    art, _, rs, G = dist_index
    cfg = QueryConfig(h=art.unique_index.h, batch_size=64)
    sess = QuerySession(art.unique_index, art.doubly_index, G, cfg,
                        device=cuda_device, engine="gather")
    got = sess.run(rs, sc_mode=sc_mode)
    for want in (QuerySession(art.unique_index, art.doubly_index, G, cfg,
                              device=d, engine=e).run(rs, sc_mode=sc_mode)
                 for d, e in (("cpu", "gather"), (cuda_device, "sortjoin"))):
        _assert_query_counts_equal(got, want)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            sess.run(rs, sc_mode=sc_mode)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught) == 1


# ---- the case analysis and rcount (kernels/case_count.py)

CASE_IDS = 200_000
# the rcount's size: every id, or the lower half (ids past it uncounted)
CASE_RC_SIZE = {1: CASE_IDS, 2: CASE_IDS // 2}


def _case_both(cols, G, sc_mode, nranges, dev):
    """case_count (one launch) and its plain version on the same CUDA
    tensors, each into a fresh rcount: (counts + pairs, [rcount])."""
    slots, rid1, rid2, lengths = (torch.from_numpy(x).to(dev) for x in cols)
    ms = MatchSlots(slots, rid1, rid2, in_u=slots < kcc.BIG)
    outs = []
    for fn in (kcc.case_count, kcc.case_count_plain):
        rc = torch.zeros(CASE_RC_SIZE[nranges], dtype=torch.int32, device=dev)
        before = kcc.KERNEL.launches
        out = fn(ms, lengths, G, sc_mode=sc_mode, rcount=rc)
        assert kcc.KERNEL.launches == before + (fn is kcc.case_count)
        outs.append((list(out), [rc]))
    torch.cuda.synchronize()
    return outs


def _assert_case_equal(outs):
    (got, got_rc), (want, want_rc) = outs
    for f, g, w in zip(kcc.CaseCounts._fields, got, want):
        assert torch.equal(g, w), f
    for g, w in zip(got_rc, want_rc):
        assert torch.equal(g, w)


# widths around the group path's lane counts (8, 16, 32), its 16-byte
# loads, its last width (1024) and the block path past it
CASE_WIDTHS = (1, 7, 8, 15, 16, 17, 31, 32, 33, 300, 600, 1024, 1025, 4096)


@pytest.mark.parametrize("branch,S,nranges,sc_mode,G", (
    [(b, 16, 1, False, 12) for b in CASE_BRANCHES + ("dups", "all_big", "padding")]
    + [("mixed", 16, 2, True, 12), ("dups", 300, 2, True, 12),
       ("padding", 300, 1, False, 12), ("dups", 4096, 2, False, 12),
       ("mixed", 4096, 1, True, 12), ("mixed", 300, 2, True, 5000)]
    + [(b, S, 1 + S % 2, S % 3 == 0, 12) for S in CASE_WIDTHS
       if S not in (16, 300, 4096) for b in ("mixed", "dups")]))
def test_case_count_kernel_matches_plain(cuda_device, branch, S, nranges, sc_mode, G):
    """The rows of tests/test_torch_casecount.py (every branch of the case
    table, duplicated slots, rows of only BIG, padding reads, an rcount over
    every id and over the lower half, G = 5000) at every width of
    ``CASE_WIDTHS``: the kernel equals its plain version exactly."""
    cols = case_rows(S * 7 + nranges + G, 64, S, G, branch, id_space=CASE_IDS)
    _assert_case_equal(_case_both(cols, G, sc_mode, nranges, cuda_device))


@pytest.mark.parametrize("B,S", [(8192, 300), (64, 4096), (8192, 16), (1, 16),
                                 (15, 300), (8193, 16), (8193, 300), (15, 7),
                                 (8193, 33), (1, 1025)])
@pytest.mark.parametrize("sc_mode", [False, True])
def test_case_count_kernel_random_batches(cuda_device, B, S, sc_mode):
    """A random batch at the gather engine's [8192, 300], the sort join's
    widest [64, 4096] and its first [8192, 16], and at batches of 1, 15 and
    8193 reads, which fill no block of the group path (256 / g reads a
    block)."""
    cols = case_rows(B + S, B, S, 40, "mixed", id_space=CASE_IDS)
    outs = _case_both(cols, 40, sc_mode, 2, cuda_device)
    _assert_case_equal(outs)
    if B > 1:
        assert int(outs[0][1][0].sum()) > 0


@pytest.mark.parametrize("S,valid,ids", [(20_000, 20_000, 6000), (300, 63, 48),
                                         (300, 64, 48), (300, 65, 48),
                                         (1024, 1000, 700), (4096, 65, 48)])
def test_case_count_kernel_rows_past_its_stage(cuda_device, S, valid, ids):
    """Rows of `valid` valid slots of S, ids drawn from `ids` values (so
    repeated): around the 64 entries a 32-lane group stages (63, 64, 65),
    far past it (1000), and 20,000, past the 16,384 a block of the block
    path stages, where the case flags and the rcount come from device
    memory."""
    B, G = 4, 12
    rng = np.random.default_rng(5)
    slots = rng.integers(0, ids, (B, S)).astype(np.int32)
    rid1 = np.full((B, S), 3, np.int32)
    rid2 = np.zeros((B, S), np.int32)
    rid1[1], rid2[1] = 3 + (slots[1] % 2), 0              # U = 2: conflict
    rid1[2], rid2[2] = 3, np.where(slots[2] % 3 == 0, 4, 0)  # r* in every pair
    pair3 = slots[3] % 3 == 0                                # r* in no pair
    rid1[3], rid2[3] = np.where(pair3, 3, 5), np.where(pair3, 4, 0)
    if valid < S:
        for r in range(B):
            slots[r, rng.choice(S, S - valid, replace=False)] = kcc.BIG
    lengths = np.full(B, 60, np.int32)
    outs = _case_both((slots, rid1, rid2, lengths), G, False, 1, cuda_device)
    _assert_case_equal(outs)
    (got, rc), _ = outs
    assert got[0].tolist()[3] == 2 and int(got[3]) == 2
    distinct = [np.unique(slots[r][slots[r] < kcc.BIG]).size for r in (0, 2)]
    assert int(rc[0].sum()) == sum(distinct)


@pytest.mark.parametrize("B,S,want", [
    (8192, 16, dict(group_path=1, lanes=16, reads_per_block=16, blocks=512,
                    slots_per_load=1)),
    (8192, 300, dict(group_path=1, lanes=32, reads_per_block=8, blocks=1024,
                     slots_per_load=4, loads_per_lane=3)),
    (15, 7, dict(group_path=1, lanes=8, reads_per_block=32, blocks=1)),
    (8193, 33, dict(group_path=1, lanes=32, blocks=1025, slots_per_load=1,
                    loads_per_lane=2)),
    (3, 1024, dict(group_path=1, lanes=32, slots_per_load=4, loads_per_lane=8)),
    (3, 1025, dict(group_path=0, reads_per_block=1, blocks=3)),
    (64, 4096, dict(group_path=0, threads=256, blocks=64))])
def test_case_count_geometry(cuda_device, B, S, want):
    """The launch the wrapper makes: lanes a read, reads a block, blocks,
    16-byte loads where the row allows, the block path past 1024 slots;
    every kernel fits at least one block an SM."""
    slots = torch.zeros((B, S), dtype=torch.int32, device=cuda_device)
    geo = kcc.case_count_geometry(slots)
    assert {k: geo[k] for k in want} == want
    assert geo["registers"] > 0 and geo["resident_blocks_per_sm"] >= 1


def test_case_count_kernel_unaligned_rows(cuda_device):
    """Rows that start 4 bytes past a 16-byte boundary take 4-byte loads,
    and equal the plain version."""
    cols = case_rows(17, 1000, 300, 40, "dups", id_space=CASE_IDS)
    base = torch.empty(1000 * 300 + 1, dtype=torch.int32, device=cuda_device)
    slots = base[1:].view(1000, 300)
    slots.copy_(torch.from_numpy(cols[0]))
    assert kcc.case_count_geometry(slots)["slots_per_load"] == 1
    rid1, rid2, lengths = (torch.from_numpy(x).to(cuda_device) for x in cols[1:])
    ms = MatchSlots(slots, rid1, rid2, in_u=None)
    outs = []
    for fn in (kcc.case_count, kcc.case_count_plain):
        rc = torch.zeros(CASE_IDS, dtype=torch.int32, device=cuda_device)
        outs.append((list(fn(ms, lengths, 40, sc_mode=True, rcount=rc)), [rc]))
    _assert_case_equal(outs)


def test_case_count_kernel_on_a_side_stream(cuda_device):
    """The launch goes to the caller's current stream: queued there behind
    a sleep, it has not yet written the counts when the default stream
    reads them, and it then equals the plain version."""
    G = 40
    cols = case_rows(23, 8192, 300, G, "mixed", id_space=CASE_IDS)
    slots, rid1, rid2, lengths = (torch.from_numpy(x).to(cuda_device) for x in cols)
    ms = MatchSlots(slots, rid1, rid2, in_u=None)
    counts = torch.zeros(2 * G + 2, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        kcc.case_count(ms, lengths, G, counts=counts)
    early = counts.clone()
    torch.cuda.synchronize()
    assert int(early.abs().sum()) == 0
    want = kcc.case_count_plain(ms, lengths, G)
    assert torch.equal(counts, torch.cat([want.cnts_u, want.cnts_d,
                                          want.nundet[None], want.nconf[None]]))


@pytest.fixture(scope="module")
def strain_db():
    """The strain database (``torch_fixture.strain_index``) and 2048 of
    its reads."""
    art, gs, G = strain_index()
    return art, strain_reads(gs, 3, 2048), G


def test_session_level1_survivors_and_counters(cuda_device, strain_db):
    """The strain database's session: its bloom fits the L2's budget, so
    its device index has no level 1 and every row reaches the bloom; with a
    level-1 fold put on the index, each batch's survivors are those of the
    one-level probe, the pass's counts are the same, and ``probe.level2``
    and ``probe.survivors`` equal a host count by the plain version."""
    art, rs, G = strain_db
    sess = QuerySession(art.unique_index, art.doubly_index, G,
                        QueryConfig(h=art.unique_index.h, batch_size=512),
                        device=cuda_device)
    dm = sess.dm
    assert dm.bloom_l1 is None and dm.bloom_l1_log == 0
    base = sess.run(rs)
    one = dict(sess.last_counters)
    l1_np, l1_log = _fold_bloom(dm.bloom.cpu().numpy(), dm.bloom_log - 4)
    two = dataclasses.replace(dm, bloom_l1=_i32(l1_np, cuda_device),
                              bloom_l1_log=l1_log)
    lp = min(rs.codes.shape[1], int(rs.lengths.max()))
    want, rows, cpu_l1 = torch.zeros(2, dtype=torch.int32), 0, _i32(l1_np, "cpu")
    for batch in rs.batches(sess.batch_size(rs)):
        host = torch.from_numpy(np.ascontiguousarray(batch.codes[:, :lp]))
        codes = host.to(cuda_device)
        a = kpb.probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
        b = kpb.probe_bloom(codes, two.bloom, two.h, two.bloom_log,
                            two.bloom_l1, two.bloom_l1_log)
        k = int(a[2][0])
        assert torch.equal(a[2], b[2]) and k > 0
        assert torch.equal(a[0][:k], b[0][:k]) and torch.equal(a[1][:k], b[1][:k])
        kpb.probe_bloom_plain(host, dm.bloom.cpu(), dm.h, dm.bloom_log, cpu_l1,
                              l1_log, want)
        rows += host.shape[0] * kpb.num_offsets(lp, dm.h)
    sess.dm = two
    got = sess.run(rs)
    for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        np.testing.assert_array_equal(getattr(got, f), getattr(base, f))
    assert (got.nundet, got.nconf) == (base.nundet, base.nconf)
    assert sess.last_counters == {"probe.rows": rows,
                                  "probe.level2": int(want[0]),
                                  "probe.survivors": int(want[1])}
    assert one == {"probe.rows": rows, "probe.level2": rows,
                   "probe.survivors": int(want[1])}
    assert int(want[1]) < int(want[0]) < rows


@pytest.mark.parametrize("sc_mode", [False, True])
@pytest.mark.parametrize("engine", ["sortjoin", "gather"])
def test_case_count_kernel_on_strain_slots(cuda_device, strain_db, engine, sc_mode):
    """The kernel against its plain version on the slots each engine's
    session on the card gives the strain database's reads, where a third
    of the reads hold a genome pair (P >= 1)."""
    art, rs, G = strain_db
    sess = QuerySession(art.unique_index, art.doubly_index, G,
                        QueryConfig(h=art.unique_index.h, batch_size=2048),
                        device="cuda", engine=engine)
    codes = torch.from_numpy(rs.codes).to(cuda_device).contiguous()
    lengths = torch.from_numpy(rs.lengths).to(cuda_device)
    if engine == "gather":
        ms = tgc.collect_matches(sess.didx_u, sess.didx_d, codes, lengths)
    else:
        ms = collect_matches(sess.dm, codes, lengths, sess.maxm, sess.frac).slots
    assert float(((ms.slots < kcc.BIG) & (ms.rid2 != 0)).any(1).float().mean()) > 0.25
    outs = []
    for fn in (kcc.case_count, kcc.case_count_plain):
        rc = torch.zeros(sess._rc_size, dtype=torch.int32, device=cuda_device)
        outs.append((list(fn(ms, lengths, G, sc_mode=sc_mode, rcount=rc)),
                     [rc]))
    torch.cuda.synchronize()
    _assert_case_equal(outs)
    assert int(outs[0][1][0].sum()) > 0


def test_case_count_kernel_makes_no_host_sync(cuda_device):
    """One launch with an rcount and a given counts buffer, views of one
    buffer, under sync debug mode "error"; then equal to the plain
    version."""
    G = 40
    cols = case_rows(9, 8192, 300, G, "mixed", id_space=CASE_IDS)
    slots, rid1, rid2, lengths = (torch.from_numpy(x).to(cuda_device) for x in cols)
    ms = MatchSlots(slots, rid1, rid2, in_u=None)
    outs = []
    for fn in (kcc.case_count, kcc.case_count_plain):
        buf = torch.zeros(2 * G + 2 + CASE_IDS, dtype=torch.int32, device=cuda_device)
        rc = buf[2 * G + 2:]
        if fn is kcc.case_count:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(ms, lengths, G, sc_mode=True, counts=buf[:2 * G + 2],
                     rcount=rc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append((buf, out.pair_lo, out.pair_hi))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][0][2 * G + 2:].sum()) > 0


def test_case_count_rejects_bad_inputs(cuda_device):
    z = torch.zeros((4, 16), dtype=torch.int32, device=cuda_device)
    ln = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    ms = MatchSlots(z, z, z, in_u=None)
    before = kcc.KERNEL.launches
    with pytest.raises(TypeError):
        kcc.case_count(MatchSlots(z.long(), z, z, None), ln, 5)
    with pytest.raises(ValueError):
        kcc.case_count(ms, ln[:3], 5)
    with pytest.raises(TypeError):
        kcc.case_count(ms, ln, 5, rcount=ln.long())
    with pytest.raises(ValueError):
        kcc.case_count(ms, ln, 5, rcount=z)
    with pytest.raises(ValueError):
        kcc.case_count(ms, ln, 5, counts=torch.zeros(11, dtype=torch.int32,
                                                     device=cuda_device))
    with pytest.raises(ValueError):
        kcc.case_count(ms, ln.cpu(), 5)
    assert kcc.KERNEL.launches == before


# ---- the sort join's match assembly (kernels/match_assemble.py)

ASSEMBLY_FIELDS = ("slots", "rid1", "rid2", "in_u", "overflow")


def _assemble_both(lists, O, B, maxm, eu, dev):
    """match_assemble on ``dev`` (one launch) and its plain version on the
    same tensors: equal in every output."""
    args = [torch.from_numpy(a).to(dev) for a in lists]
    before = kma.KERNEL.launches
    got = kma.match_assemble(*args, O, B, maxm, eu)
    assert kma.KERNEL.launches == before + 1
    want = kma.match_assemble_plain(*args, O, B, maxm, eu)
    torch.cuda.synchronize()
    for f, g, w in zip(ASSEMBLY_FIELDS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert torch.equal(g, w), f
    return got


@pytest.mark.parametrize("maxm", [1, 16, 300, 4096])
@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_assemble_kernel_matches_plain(cuda_device, case, maxm):
    """Every synthetic list (duplicates, overflow, counts[0] > KP and = 0,
    garbage past the valid prefix, B off every block's reads, one read
    holding the list) at each lane width (8, 16, 32)."""
    kw = MATCH_CASES[case]
    mrow, me, counts, prec, eu = match_list(11, **kw)
    _assemble_both((mrow, me, counts, prec), kw["O"], kw["B"], maxm, eu,
                   cuda_device)


@pytest.mark.parametrize("maxm", [1, 16, 4096])
@pytest.mark.parametrize("n", [33, 65, 129, 4096, 4097, 24256])
def test_match_assemble_kernel_wide_read(cuda_device, n, maxm):
    """One read holds every match of the list: past a group's stage (4
    matches a lane) it takes one block, which sorts up to 4096 matches in
    shared memory and counts from device memory beyond."""
    mrow, me, counts, prec, eu = match_list(n + maxm, B=5, O=n, kp=n, n=n,
                                            pool=min(n, 3000), E=8192,
                                            one_read=True)
    got = _assemble_both((mrow, me, counts, prec), n, 5, maxm, eu, cuda_device)
    assert int(got[4]) > 0 or maxm == 4096


@pytest.mark.parametrize("maxm", [1, 16, 32, 64])
def test_match_assemble_kernel_bucket_edge(cuda_device, maxm):
    """Reads holding exactly 4g and 4g + 1 matches for the lane width g of
    ``maxm``: a full bucket on the group path, and one match past it on
    the fallback (its matches packed by read, one block a wide read)."""
    kw = MATCH_CASES["bucket_edge"]
    mrow, me, counts, prec, eu = match_list(5, **kw)
    S = kma.BUCKET_PER_LANE * kma.lanes_for(maxm)
    held = np.bincount(mrow[:kw["n"]] // kw["O"], minlength=kw["B"])
    assert S in held and S + 1 in held
    _assemble_both((mrow, me, counts, prec), kw["O"], kw["B"], maxm, eu,
                   cuda_device)


@pytest.mark.parametrize("maxm", [1, 16, 64])
def test_match_assemble_kernel_every_read_wide(cuda_device, maxm):
    """Every one of 600 reads past its bucket (4g + 1 to 4g + 40 matches:
    the fallback's scan runs over more than one block of wide reads),
    twice, then an ordinary list on the same stream, which finds the state
    the fallback left at zero."""
    S = kma.BUCKET_PER_LANE * kma.lanes_for(maxm)
    sizes = tuple(range(S + 1, S + 41))
    B = 600
    n = int(np.resize(sizes, B).sum())
    mrow, me, counts, prec, eu = match_list(maxm, B=B, O=50, kp=n + 100, n=n,
                                            pool=60, E=8192, sizes=sizes)
    for _ in range(2):
        _assemble_both((mrow, me, counts, prec), 50, B, maxm, eu, cuda_device)
    kw = MATCH_CASES["skewed"]
    mrow, me, counts, prec, eu = match_list(4, **kw)
    _assemble_both((mrow, me, counts, prec), kw["O"], kw["B"], maxm, eu,
                   cuda_device)


@pytest.mark.parametrize("pool", [3, 40])
def test_match_assemble_kernel_config3_density(cuda_device, pool):
    """The config-#3 batch's shape: B = 8192 reads, O = 75, KP = 24,256
    with 12,895 matches (1.6 a read), maxm 16; ``pool`` 40 puts a third
    of the reads past 16 distinct gids."""
    mrow, me, counts, prec, eu = match_list(pool, B=8192, O=75, kp=24256,
                                            n=12895, pool=pool, E=1 << 16,
                                            garbage=True)
    _assemble_both((mrow, me, counts, prec), 75, 8192, 16, eu, cuda_device)


def test_match_assemble_kernel_state_and_streams(cuda_device):
    """The per-stream state stays at zero between launches: calls in a row,
    a batch wider than the last, a side stream and a batch of one read
    each equal the plain version, and a call under sync debug mode
    "error" makes no host sync."""
    for seed, (B, maxm) in enumerate([(64, 16), (64, 16), (3000, 4), (1, 300)]):
        mrow, me, counts, prec, eu = match_list(seed, B=B, O=20, kp=6 * B + 9,
                                                n=5 * B, pool=6)
        _assemble_both((mrow, me, counts, prec), 20, B, maxm, eu, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    mrow, me, counts, prec, eu = match_list(9, **MATCH_CASES["skewed"])
    with torch.cuda.stream(side):
        for _ in range(2):
            _assemble_both((mrow, me, counts, prec), 30, 100, 16, eu, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (mrow, me, counts, prec)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kma.match_assemble(*args, 30, 100, 16, eu)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = kma.match_assemble_plain(*args, 30, 100, 16, eu)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the quant solver's FISTA chunk (kernels/quant_fista.py)

# a chunk's x, kernel against plain version: max |x - x_plain| within
# QUANT_CHUNK_TOL x max(1, max |x_plain|).  The kernel's float32 sums run
# in another order, and the projection's first feasible grid point can
# then move by one step; FISTA's momentum carries such a step through the
# chunk.  The plain version, its start moved by one ulp, moves as far
# mid-chunk; by the chunk's end both settle again (PERF.md)
QUANT_CHUNK_TOL = 1e-3
QUANT_KINDS = {"unconstrained": QUANT_UNCONSTRAINED,
               "constrained": QUANT_CONSTRAINED, "beyond_cap": QUANT_BEYOND_CAP,
               # reads for about half the predicted coverage: the TOTAL row
               # binds and the projection's grid runs
               "total_binds": dict(total_slack=(0.5, 0.6))}


def _chunk_inputs(prob, S, dev, seed):
    """A chunk's inputs as the solver makes them: the problem's own bounds
    (S = 1) or the bounds of S random subsets of the candidates (the
    enumeration's), starts inside them, multipliers >= 0, the step
    1 / (2 L) with L the Gershgorin bound of H, and rho = L / |M|^2."""
    rng = np.random.default_rng(seed)
    n, C2 = prob.n, len(prob.c2_species)
    if S == 1:
        lb, ub = prob.lb[None], prob.ub[None]
    else:
        sel = (rng.random((S, n)) < 0.6) & prob.exist0
        lb = np.where(sel, np.maximum(prob.lb, 0.01), 0.0)
        ub = np.where(sel, prob.ub, 0.0)
    x0 = np.clip(rng.random((S, n)) * 4, lb, ub)
    lam = rng.random((S, C2)) * 10
    terms = kqf.fista_terms(prob, dev)
    f = terms.folded
    L = float(torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, torch.repeat_interleave(torch.arange(n, device=dev),
                                   (f["h_ptr"][1:] - f["h_ptr"][:-1]).long()),
        f["h_val"].abs()).max())
    rho = L / max(float((f["m_val"].double() ** 2).sum()), 1e-12)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (x0, lam, lb, ub)]
    return args, terms, 1.0 / (2 * L), rho


def _chunk_both(prob, S, n_it, dev, seed=0):
    (x0, lam, lb, ub), terms, step, rho = _chunk_inputs(prob, S, dev, seed)
    before = kqf.KERNEL.launches
    stats = torch.zeros(S, 2, dtype=torch.int32, device=dev)
    got = kqf.fista_chunk(x0, lam, lb, ub, n_it, terms, step, rho, stats=stats)
    assert kqf.KERNEL.launches == before + 1
    want = kqf.fista_chunk_plain(x0, lam, lb, ub, n_it, terms, step, rho)
    assert got.shape == want.shape == (S, prob.n)
    err = float((got - want).abs().max())
    assert err <= QUANT_CHUNK_TOL * max(1.0, float(want.abs().max())), err
    # the kernel stays in the bounds and counts the coordinates with lb < ub
    assert bool(((got >= lb) & (got <= ub)).all())
    assert torch.equal(stats[:, 1].long().cpu(), (lb < ub).sum(1).cpu())
    return stats


@pytest.mark.parametrize("kind", list(QUANT_KINDS))
@pytest.mark.parametrize("S", [1, 64])
def test_quant_fista_kernel_matches_plain(cuda_device, kind, S):
    """A chunk of the solver's 333 iterations, with and without C2 rows,
    one problem and a batch of 64 subsets."""
    prob = quant_problem({"unconstrained": 1000, "constrained": 7000,
                          "beyond_cap": 42000, "total_binds": 1001}[kind],
                         **QUANT_KINDS[kind])
    assert (len(prob.c2_species) > 0) == (kind == "constrained")
    stats = _chunk_both(prob, S, 333, cuda_device, seed=S)
    if kind == "total_binds":
        assert int(stats[:, 0].sum()) > 0     # the projection's grid ran


@pytest.mark.parametrize("S", [1, 256])
def test_quant_fista_kernel_config3_width(cuda_device, S):
    """n = 1001 (config #3's genome slots) with C2 rows and a TOTAL row
    that binds, one problem and the enumeration's 256 subsets, each at
    the solver's chunk length (333 iterations, 200 for the enumeration)."""
    prob = quant_problem(5, n_sp=1000, per_genome_u=4, n_d=600,
                         easy_thres=30, total_slack=(0.5, 0.6), ilp_alpha=1e-4)
    assert len(prob.c2_species) > 100
    stats = _chunk_both(prob, S, 333 if S == 1 else 200, cuda_device, seed=S)
    if S == 1:
        assert int(stats[0, 0]) > 0     # the projection's grid ran


@pytest.mark.parametrize("n_sp", [6399, 6400])
def test_quant_fista_kernel_past_shared_memory(cuda_device, n_sp):
    """n = 6400 fills the kernel's shared-memory working set to its cap;
    n = 6401 is one past it and runs from the wrapper's device scratch."""
    prob = quant_problem(6, n_sp=n_sp, per_genome_u=2, n_d=3000)
    words = kqf.scratch_words(prob.n, len(prob.c2_species))
    assert (4 * words > kqf.smem_cap()) == (n_sp == 6400)
    _chunk_both(prob, 2, 20, cuda_device)


def test_quant_fista_kernel_edges(cuda_device):
    """No iteration returns the start; a 1-d start gives a 1-d result; a
    chunk makes no host sync; terms made for the CPU and a float64 start
    are refused."""
    prob = quant_problem(7000, **QUANT_CONSTRAINED)
    (x0, lam, lb, ub), terms, step, rho = _chunk_inputs(prob, 3, cuda_device, 1)
    assert torch.equal(kqf.fista_chunk(x0, lam, lb, ub, 0, terms, step, rho), x0)
    got = kqf.fista_chunk(x0[0], lam[0], lb[0], ub[0], 50, terms, step, rho)
    want = kqf.fista_chunk(x0[:1], lam[:1], lb[:1], ub[:1], 50, terms, step, rho)
    assert got.shape == (prob.n,) and torch.equal(got, want[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kqf.fista_chunk(x0, lam, lb, ub, 50, terms, step, rho)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with pytest.raises(ValueError):
        kqf.fista_chunk(x0, lam, lb, ub, 5, kqf.fista_terms(prob, "cpu"),
                        step, rho)
    with pytest.raises(TypeError):
        kqf.fista_chunk(x0.double(), lam, lb, ub, 5, terms, step, rho)


@pytest.mark.parametrize("seed,kind,enum_cap", [
    (1000, "unconstrained", 6), (1002, "unconstrained", 6),
    (7000, "constrained", 6), (7001, "constrained", 6),
    (42000, "beyond_cap", 6), (91001, "beyond_cap", 4)])
def test_solve_quant_cuda_matches_cpu(cuda_device, seed, kind, enum_cap):
    """The whole solve on the card (every chunk one launch) against the
    same solve on the CPU (the plain version): the same EXIST set,
    abundances within 1e-3 L1 and the same stopped_by."""
    prob = quant_problem(seed, **QUANT_KINDS[kind])
    opts = dict(iters=1800, outer=6, enum_cap=enum_cap, enum_iters=400)
    before = kqf.KERNEL.launches
    ge, gc, gi = solve_quant(prob, device="cuda", **opts)
    assert kqf.KERNEL.launches - before == gi["fista_chunks"] > 0
    we, wc, wi = solve_quant(prob, device="cpu", **opts)
    np.testing.assert_array_equal(ge, we)
    assert np.abs(gc / gc[ge].sum() - wc / wc[we].sum()).sum() <= 1e-3
    assert gi["stopped_by"] == wi["stopped_by"]
    assert ge.any()
