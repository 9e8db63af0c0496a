"""The port's CUDA kernels against their plain PyTorch versions, and the
query path through the kernels against the same path on the CPU.  Every
test needs a card (marker ``cuda``) and skips without one: the kernels are
compiled with nvcc and have no CPU mode.  The file imports no JAX, so it
runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cammiq_tpu.config import QueryConfig
from cammiq_tpu.io.fastq import ReadSet
from cammiq_tpu.query.sortjoin import build_merged_index
from cammiq_tpu_torch.kernels import cuckoo_verify as kcv
from cammiq_tpu_torch.kernels import first_of_run as kfr
from cammiq_tpu_torch.kernels import probe_bloom as kpb
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, collect_matches
from dist_fixture import make_dist_fixture
from torch_fixture import large_bucket_index

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dist_index():
    art, rs, G = make_dist_fixture(seed=13)
    return art, build_merged_index(art.unique_index, art.doubly_index), rs, G


@pytest.mark.parametrize("lead_start", [False, True])
@pytest.mark.parametrize("nv", [1, 4])
@pytest.mark.parametrize("n", [1, 2048, 2049, 1 << 20])
def test_scan_kernel_matches_plain(cuda_device, n, nv, lead_start):
    rng = np.random.default_rng(n + nv)
    flags = rng.random(n) < 0.02
    flags[0] = lead_start
    f = torch.from_numpy(flags).to(cuda_device)
    vs = [torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, n)
                           .astype(np.int32)).to(cuda_device) for _ in range(nv)]
    before = kfr.KERNEL.launches
    got = kfr.first_of_run_scan(f, *vs)
    assert kfr.KERNEL.launches == before + 1
    for g, w in zip(got, kfr.first_of_run_scan_plain(f, *vs)):
        assert torch.equal(g, w)


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
