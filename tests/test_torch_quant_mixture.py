"""The quantification path on a mixture, the port against the JAX package
(CPU): ``tools/benchdata.py:sample_mixture`` (a copy of
``benchmarks/realized_free.py``'s sampler, held to it byte for byte here)
draws reads of 16 present genomes of 40 x 20 kb bench genomes; both
packages' sessions classify them and both solvers solve the problem of
the stress and the constrained fine parameters: the same counts, the
same EXIST set, abundances within 1e-3 L1 and the same stopped_by."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from cammiq_tpu.config import QueryConfig as JQueryConfig
from cammiq_tpu.models.quant import solve_quant as jax_solve_quant
from cammiq_tpu.query.pipeline import QuerySession as JaxSession
from cammiq_tpu_torch.config import BuildConfig, FineParams, QueryConfig
from cammiq_tpu_torch.index.builder import build_index
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.io.fastq import ReadSet
from cammiq_tpu_torch.models.quant import build_problem, solve_quant
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.tools.benchdata import gen_genomes, sample_mixture
from torch_fixture import fake_index

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOMES, GLEN, PRESENT, BATCHES = 40, 20_000, 16, 2
# the fine parameters of realized_free.py's stress variant (no EXP rows:
# every candidate free, so the B&B runs) and a constrained variant (the
# default easy_to_identify_thres: C2 rows and the AL path)
FINE = {"stress": dict(read_cnt_thres=1, easy_to_identify_thres=10**9,
                       ilp_alpha=1e-9),
        "constrained": dict(read_cnt_thres=1, ilp_alpha=1e-9)}
# 2^4 subsets a round: the plain version's enumeration builds
# [2^m, 256, n] temporaries, and 2^8 take about 100 s on the CPU
ENUM_CAP = 4
COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")


@pytest.fixture(scope="module")
def mixture():
    """The config-#3 build parameters on 40 bench genomes (the native host
    engine), the mixture's reads, both sessions' counts."""
    gs = gen_genomes(GENOMES, GLEN)
    art = build_index(corpus_from_sequences(gs),
                      BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both"),
                      engine="native")
    _, _, batches = sample_mixture(gs, PRESENT, BATCHES)
    codes = np.concatenate([b[0] for b in batches])
    lengths = np.concatenate([b[1] for b in batches])
    rs = ReadSet(codes=codes, lengths=lengths, total_len=int(lengths.sum()),
                 name="mixture")
    iu, idd = art.unique_index, art.doubly_index
    G = GENOMES + 1
    got = QuerySession(iu, idd, G, QueryConfig(h=26, batch_size=8192),
                       device="cpu").run(rs)
    want = JaxSession(iu, idd, G, JQueryConfig(h=26, batch_size=8192)).run(rs)
    return art, got, want


def test_mixture_counts_match_jax(mixture):
    _, got, want = mixture
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.num_reads) == (
        want.nundet, want.nconf, want.num_reads)


@pytest.mark.parametrize("variant", list(FINE))
def test_mixture_solve_matches_jax(mixture, variant):
    art, counts, _ = mixture
    gl, nus, nds = (np.concatenate([[0], a]) for a in (
        art.genome_lengths, art.ulm_count_u, art.ulm_count_d))
    prob = build_problem(
        art.unique_index, art.doubly_index, counts.rcount_u, counts.rcount_d,
        counts.cnts_u.astype(np.float64), counts.cnts_d.astype(np.float64),
        nus.astype(np.float64), nds.astype(np.float64), gl.astype(np.int64),
        counts.mean_read_len, counts.num_reads, 0.01, FineParams(**FINE[variant]))
    te, tc, ti = solve_quant(prob, enum_cap=ENUM_CAP, device="cpu")
    je, jc, ji = jax_solve_quant(prob, enum_cap=ENUM_CAP)
    np.testing.assert_array_equal(te, je)
    assert np.abs(tc / tc[te].sum() - jc / jc[je].sum()).sum() <= 1e-3
    assert ti["stopped_by"] == ji["stopped_by"]
    if variant == "stress":
        assert ti["free_candidates"] > ENUM_CAP and ti["stopped_by"] == "bnb"
    else:
        assert ti["c2_rows"] > 0 and te.any()


def test_sample_mixture_is_realized_free_s(monkeypatch, tmp_path):
    """benchmarks/realized_free.py's main(), its index, classifier and
    genomes stood in for, hands its classifier the batches that
    sample_mixture gives on the same genomes: byte for byte."""
    import jax

    import bench
    import cammiq_tpu.index.artifact as jart
    import cammiq_tpu.query.sortjoin as jsj

    spec = importlib.util.spec_from_file_location(
        "realized_free", os.path.join(REPO, "benchmarks", "realized_free.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    G, glen, present, nb = 12, 3000, 5, 2
    genomes = gen_genomes(G, glen, seed=4)
    seen = []

    def classifier(dm, slots, **kw):
        def classify(codes, lengths, **kw):
            seen.append((np.asarray(codes), np.asarray(lengths)))
            out = types.SimpleNamespace(cnts_u=np.zeros(slots), cnts_d=np.zeros(slots),
                                        rcount_u=np.zeros(0), rcount_d=np.zeros(0))
            return out, 0, 0
        return classify

    mdir = tmp_path / "merged"
    mdir.mkdir()
    for name in ("genome_lengths.out", "unique_lmer_count_u.out",
                 "unique_lmer_count_d.out"):
        (mdir / name).write_text("".join(f"{g} {glen}\n" for g in range(1, G + 1)))
    tables = tuple(fake_index([], [], [], [], [], d) for d in (False, True))
    art = types.SimpleNamespace(eu=0, ed=0, payloads=lambda: tables)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    for name in ("BENCH_GENOMES", "BENCH_GLEN"):   # main() sets them
        monkeypatch.setattr(bench, name, getattr(bench, name))
    monkeypatch.setattr(bench, "bench_cache_dir", lambda: str(tmp_path))
    monkeypatch.setattr(bench, "gen_bench_genomes", lambda: genomes)
    monkeypatch.setattr(jart, "load_merged_artifact", lambda d: art)
    monkeypatch.setattr(jsj, "to_device_merged_artifact", lambda a: None)
    monkeypatch.setattr(jsj, "make_sortjoin_classifier", classifier)
    monkeypatch.setenv("CAMMIQ_BENCH_GENOMES", str(G))
    monkeypatch.setenv("CAMMIQ_BENCH_GLEN", str(glen))
    monkeypatch.setattr(sys, "argv", [
        "realized_free.py", "--genomes", str(G), "--glen", str(glen),
        "--present", str(present), "--batches", str(nb)])
    mod.main()
    _, _, got = sample_mixture(genomes, present, nb)
    assert len(seen) == len(got) == nb
    for (codes, lengths), (want_codes, want_lengths) in zip(got, seen):
        assert codes.dtype == want_codes.dtype and lengths.dtype == want_lengths.dtype
        assert codes.tobytes() == want_codes.tobytes()
        assert lengths.tobytes() == want_lengths.tobytes()
