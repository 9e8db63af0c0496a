"""Both port engines against the JAX package's, and against the scalar
transcription of the reference's query loop (``tests/query_oracle.py``),
on realistic content: strain families at 95-99.9% ANI plus unrelated
genomes and a backbone shared by every third genome
(``torch_fixture.strain_genomes``, a cut of ``tests/test_realistic.py``'s
database), where the pair branches of the case table really run.
Counts, rcounts and pair counts must be bit-identical, in quant and in
sc mode."""

import numpy as np
import pytest
import torch

from cammiq_tpu.config import BuildConfig
from cammiq_tpu.config import QueryConfig as JQueryConfig
from cammiq_tpu.index.builder import build_index
from cammiq_tpu.io.fasta import corpus_from_sequences
from cammiq_tpu.query.pipeline import QuerySession as JaxSession
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.io.fastq import ReadSet
from cammiq_tpu_torch.query import classify as tc
from cammiq_tpu_torch.query.pipeline import QuerySession
from query_oracle import oracle_classify
from torch_fixture import ALPHA, STRAIN_BUILD, strain_genomes, strain_reads

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")
# reads whose matches hold a genome pair (P >= 1): 37.6% with this seed
MIN_PAIR_SHARE = 0.25
BATCH = 512
ORACLE_READS = 400      # the oracle walks every offset in Python


@pytest.fixture(scope="module")
def strains():
    """The JAX package's index of the strain database (the port's entry
    points take it by its numpy attributes), 2000 reads with 1% errors,
    and the number of genome slots."""
    gs = strain_genomes()
    corpus = corpus_from_sequences([[ALPHA[g].tobytes()] for g in gs])
    art = build_index(corpus, BuildConfig(**STRAIN_BUILD), engine="numpy")
    assert art.unique_index.num_entries and art.doubly_index.num_entries
    return art, strain_reads(gs, 3, 2000), len(gs) + 1


@pytest.mark.parametrize("sc_mode", [False, True])
@pytest.mark.parametrize("engine", ["sortjoin", "gather"])
def test_session_matches_jax_on_strains(strains, engine, sc_mode):
    art, rs, G = strains
    iu, idd = art.unique_index, art.doubly_index
    want = JaxSession(iu, idd, G, JQueryConfig(h=iu.h, batch_size=BATCH),
                      engine=engine).run(rs, sc_mode=sc_mode)
    got = QuerySession(iu, idd, G, QueryConfig(h=iu.h, batch_size=BATCH),
                       device="cpu", engine=engine).run(rs, sc_mode=sc_mode)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.num_reads, got.mean_read_len) == (
        want.nundet, want.nconf, want.num_reads, want.mean_read_len)
    assert got.pair_counts == want.pair_counts
    assert want.cnts_d.sum() > 0 and want.nconf > 0
    if sc_mode:
        assert len(want.pair_counts) >= 2


def test_strain_reads_take_pair_branches(strains):
    """A stated share of the reads carries a genome pair among its
    matches (P >= 1), so the pair branches of the case table run."""
    art, rs, G = strains
    sess = QuerySession(art.unique_index, art.doubly_index, G,
                        QueryConfig(h=art.unique_index.h), device="cpu",
                        engine="gather")
    ms = tc.collect_matches(sess.didx_u, sess.didx_d, torch.from_numpy(rs.codes),
                            torch.from_numpy(rs.lengths))
    pair = ((ms.slots < tc.BIG) & (ms.rid2 != 0)).any(1)
    assert float(pair.float().mean()) >= MIN_PAIR_SHARE


@pytest.fixture(scope="module")
def oracle_counts(strains):
    art, rs, G = strains
    n = ORACLE_READS
    sub = ReadSet(codes=rs.codes[:n], lengths=rs.lengths[:n],
                  total_len=int(rs.lengths[:n].sum()), name="strains")
    return sub, oracle_classify(art.unique_index, art.doubly_index, sub.codes,
                                sub.lengths, G)


@pytest.mark.parametrize("engine", ["sortjoin", "gather"])
def test_session_matches_query_oracle_on_strains(strains, oracle_counts, engine):
    """The reference's per-read loop: counts and rcounts of a quant pass,
    the assigned pairs of an sc pass."""
    art, _, G = strains
    sub, want = oracle_counts
    sess = QuerySession(art.unique_index, art.doubly_index, G,
                        QueryConfig(h=art.unique_index.h, batch_size=BATCH),
                        device="cpu", engine=engine)
    got = sess.run(sub)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), want[f], err_msg=f)
    assert (got.nundet, got.nconf) == (want["nundet"], want["nconf"])
    assert sess.run(sub, sc_mode=True).pair_counts == want["pair_counts"]
    assert want["pair_counts"] and want["cnts_d"].sum() > 0
