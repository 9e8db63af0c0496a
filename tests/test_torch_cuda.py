"""The port's CUDA kernels against their plain PyTorch versions, and the
query path through the kernels against the same path on the CPU.  Every
test needs a card (marker ``cuda``) and skips without one: the kernels are
compiled with nvcc and have no CPU mode.  The file imports nothing of
JAX or of the JAX package, so it runs on a GPU host without either:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cammiq_tpu_torch.config import BuildConfig, QueryConfig
from cammiq_tpu_torch.index import unique as uq
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.kernels import cuckoo_verify as kcv
from cammiq_tpu_torch.kernels import first_of_run as kfr
from cammiq_tpu_torch.kernels import lcp_pairs as klcp
from cammiq_tpu_torch.kernels import occ_count as kocc
from cammiq_tpu_torch.kernels import probe_bloom as kpb
from cammiq_tpu_torch.io.fastq import ReadSet
from cammiq_tpu_torch.ops.sa import suffix_array
from cammiq_tpu_torch.query.merged import build_merged_index
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, collect_matches
from torch_fixture import dist_fixture, large_bucket_index, pair_corpus

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


@pytest.mark.parametrize("h,Lp", [(12, 100), (20, 100), (26, 100), (26, 37),
                                  (20, 16)])
def test_probe_bloom_kernel_matches_plain(cuda_device, h, Lp):
    rng = np.random.default_rng(h * 1000 + Lp)
    codes = torch.from_numpy(rng.integers(0, 4, (512, Lp)).astype(np.int8))
    bloom = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32))
    codes, bloom = codes.to(cuda_device), bloom.to(cuda_device)
    got = kpb.probe_bloom(codes, bloom, h, 16)
    want = kpb.probe_bloom_plain(codes, bloom, h, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(got[0].sum()) < got[0].shape[0]


def test_cuckoo_verify_kernel_matches_plain(cuda_device, dist_index):
    _, m, rs, _ = dist_index
    dm = TorchMergedIndex.from_merged(m, cuda_device)
    codes = torch.from_numpy(rs.codes).to(cuda_device)
    lengths = torch.from_numpy(rs.lengths).to(cuda_device)
    maybe, khlo = kpb.probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
    rows = torch.nonzero(maybe).squeeze(1)
    args = (rows, khlo, codes, lengths, dm.cuckoo, dm.cuckoo_log, dm.erec,
            dm.n_colors)
    got = kcv.cuckoo_verify(*args)
    assert torch.equal(got, kcv.cuckoo_verify_plain(*args))
    assert int((got >= 0).sum()) > 0


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
    got = collect_matches(TorchMergedIndex.from_merged(m, cuda_device),
                          codes.to(cuda_device), lengths.to(cuda_device), maxm)
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
