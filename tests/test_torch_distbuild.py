"""The port's cross-host build (``parallel/dist_build.py``) and sharded
suffix sort against ``cammiq_tpu`` on the CPU: ``dist_bounded_sa`` a valid
bounded order that yields the same index, ``dist_build_index(hosts=H)``
equal to ``cammiq_tpu``'s and to ``build_index(num_groups=min(H, 4, M))``,
with worker processes and from a streamed corpus.  Exact equality of every
array.  (The copies it runs on, ``index/chunked.py`` and
``io/fasta.py:build_corpus_streaming``, are held to their sources in
test_torch_standalone.py.)

The port's tests gate on the port's own ``native``; ``cammiq_tpu``'s
native engine and its ``dist_build_index`` (which needs it) are references
only where they loaded in the same test, its numpy engine always."""

import numpy as np
import pytest
import torch

import cammiq_tpu.native as jnative
from cammiq_tpu.config import BuildConfig as JaxBuildConfig
from cammiq_tpu.index.builder import build_index as jax_build_index
from cammiq_tpu.io import fasta as jfasta
from cammiq_tpu.parallel import dist_build as jdb
from cammiq_tpu_torch import native
from cammiq_tpu_torch.config import BuildConfig
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.io import fasta as tfasta
from cammiq_tpu_torch.parallel import dist_build as tdb
from test_torch_hostbuild import assert_bounded_order, assert_same_artifacts
from torch_fixture import ALPHA

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not (native.available() and native.has_bsort()),
    reason="port native bounded sort not built")

PHASES = ("baseline", "p1_sort_partition", "p2_merge_chunks", "p3_sweeps",
          "p4_select")


def _genomes(num=6, glen=3000, seed=7, nctg=1):
    """test_dist_build_full.py's genomes: a shared segment, so repeats cross
    slice boundaries and unique, doubly and multi content all exist."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 4, min(600, glen // 5))
    genomes = []
    for _ in range(num):
        own = rng.integers(0, 4, glen)
        ins = int(rng.integers(0, glen - len(shared)))
        seq = ALPHA[np.concatenate([own[:ins], shared, own[ins:]])].tobytes()
        k = max(len(seq) // nctg, 1)
        genomes.append([seq[i * k:(i + 1) * k] for i in range(nctg)])
    return genomes


def _pair(genomes):
    return tfasta.corpus_from_sequences(genomes), jfasta.corpus_from_sequences(genomes)


def _cfgs(**kw):
    return BuildConfig(**kw), JaxBuildConfig(**kw)


@pytest.mark.parametrize("hosts", [2, 3])
def test_dist_bounded_sa_is_a_bounded_order(hosts):
    """The slices' merged order is a valid bounded order of the whole text,
    its keys those of the single-host sort (by both packages' key packer),
    and the index built on it is the single-host index."""
    tc, jc = _pair(_genomes())
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=40, h=14, mode="both")
    depth = cfg.sa_depth
    sa = tdb.dist_bounded_sa(tc.seq, depth, hosts, processes=False)
    assert_bounded_order(tc.seq, depth, sa)
    one = native.bounded_sa(tc.seq, depth)
    for pack in (tdb._pack_keys, jdb._pack_keys):
        for a, b in zip(pack(tc.seq, sa, depth), pack(tc.seq, one, depth)):
            np.testing.assert_array_equal(a, b)
    got = build_index(tc, cfg, engine="native", sa_hosts=hosts)
    assert_same_artifacts(got, build_index(tc, cfg, engine="native"))
    assert_same_artifacts(got, jax_build_index(jc, jcfg, engine="numpy"))


def test_dist_bounded_sa_processes(monkeypatch):
    """Two worker processes, each handed only its subtext's bytes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tc, _ = _pair(_genomes(num=3, glen=2000))
    sa = tdb.dist_bounded_sa(tc.seq, 104, 2, processes=True)
    assert_bounded_order(tc.seq, 104, sa)


def _dist_refs(tc, jc, cfg, jcfg, hosts, tmp_path):
    """``build_index(num_groups=min(H, 4, M))`` of the port's native engine
    and of ``cammiq_tpu``'s numpy engine, and ``cammiq_tpu``'s
    ``dist_build_index`` where its native library loaded here."""
    refs = {"port native": build_index(tc, cfg, engine="native"),
            "jax numpy": jax_build_index(jc, jcfg, engine="numpy")}
    if jnative.has_bsort():
        refs["jax dist"] = jdb.dist_build_index(jc, jcfg, hosts, str(tmp_path / "jwd"),
                                                processes=False)[0]
    return refs


@pytest.mark.parametrize("hosts,nctg", [(2, 1), (3, 1), (3, 3)])
def test_dist_build_index_matches(tmp_path, hosts, nctg):
    tc, jc = _pair(_genomes(nctg=nctg))
    groups = min(hosts, 4, tc.num_files)
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=40, h=14, mode="both", num_groups=groups)
    got, rss = tdb.dist_build_index(tc, cfg, hosts, str(tmp_path / "wd"),
                                    processes=False)
    assert set(rss) == set(PHASES[1:])
    for what, want in _dist_refs(tc, jc, cfg, jcfg, hosts, tmp_path).items():
        assert_same_artifacts(got, want, what)
    assert got.unique_index.num_entries > 0 and got.doubly_index.num_entries > 0


@pytest.mark.parametrize("mode", ["unique", "doubly_unique"])
def test_dist_build_index_one_table(tmp_path, mode):
    tc, jc = _pair(_genomes(num=4, glen=2500, seed=11))
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=40, h=14, mode=mode, num_groups=2)
    got, _ = tdb.dist_build_index(tc, cfg, 2, str(tmp_path / "wd"), processes=False)
    for what, want in _dist_refs(tc, jc, cfg, jcfg, 2, tmp_path).items():
        assert_same_artifacts(got, want, what)


def test_dist_build_index_processes(tmp_path, monkeypatch):
    """Worker processes (spawned, each importing numpy and this package's
    host modules, not torch): the same index, and a peak RSS for every
    worker of every phase."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tc, jc = _pair(_genomes(num=4, glen=2500, seed=5))
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=40, h=14, mode="both", num_groups=2)
    got, rss = tdb.dist_build_index(tc, cfg, 2, str(tmp_path / "wd"), processes=True)
    assert set(rss) == set(PHASES)
    assert [len(rss[p]) for p in PHASES] == [2, 2, 2, 1, 2]
    assert all(v > 0 for p in PHASES for v in rss[p])
    for what, want in _dist_refs(tc, jc, cfg, jcfg, 2, tmp_path).items():
        assert_same_artifacts(got, want, what)


def test_dist_build_rejects_bit_parity_modes(tmp_path):
    tc, _ = _pair(_genomes(num=2, glen=800))
    for kw in (dict(occ_u8_wrap=True), dict(unique_if_advance=True)):
        with pytest.raises(ValueError, match="single-host"):
            tdb.dist_build_index(tc, BuildConfig(k=14, L=80, Lmax=40, h=14, **kw), 2,
                                 str(tmp_path / "wd"))


def _fasta_files(tmp_path, seed, num, glen, nctg, shared_len=0):
    rng = np.random.default_rng(seed)
    shared = "".join("ACGT"[x] for x in rng.integers(0, 4, shared_len))
    files = []
    for g in range(num):
        p = tmp_path / f"g{g}.fasta"
        with open(p, "w") as f:
            for c in range(nctg):
                own = "".join("ACGT"[x] for x in rng.integers(0, 4, glen))
                ins = int(rng.integers(0, glen))
                seq = own[:ins] + shared + own[ins:]
                f.write(f">g{g}c{c}\n{seq[:333]}\n{seq[333:]}\n")
        files.append((str(p), g + 1))
    return files


def test_dist_build_from_streamed_corpus(tmp_path):
    """The CLI's ``--build_hosts`` path: a memmapped streamed corpus gives
    the in-memory build's index."""
    files = _fasta_files(tmp_path, 9, 6, 2500, 1, shared_len=500)
    cfg, jcfg = _cfgs(k=14, L=80, Lmax=40, h=14, mode="both", num_groups=2)
    corpus = tfasta.build_corpus_streaming(files, str(tmp_path / "seq.bin"))
    assert isinstance(corpus.seq, np.memmap)
    got, _ = tdb.dist_build_index(corpus, cfg, 2, str(tmp_path / "wd"), processes=False)
    assert_same_artifacts(got, build_index(tfasta.build_corpus(files), cfg,
                                           engine="native"))
    assert_same_artifacts(got, jax_build_index(jfasta.build_corpus(files), jcfg,
                                               engine="numpy"))
